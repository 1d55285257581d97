"""Logical-axis sharding, in PyTorch: the port of
``repro/launch/sharding.py``.  Model code annotates tensors with *logical*
axis names; a context-installed rule set maps them to mesh axes (or drops
them).

Keeping the mapping out of model code lets the same model run on one
device (no mesh: every annotation returns its input), on a
``torch.distributed`` ``DeviceMesh`` of the cards, and on the 16 x 16 and
2 x 16 x 16 production meshes of the dry run (``launch/dryrun.py``).

A ``PartitionSpec`` names, for each tensor dim, a mesh axis, a tuple of
them or ``None``, as the reference's does; ``placements`` turns it into
the DTensor placements of a mesh.  ``resolve_spec`` reads only
``mesh.shape`` as a name -> size mapping (``mesh_sizes`` makes one of a
``DeviceMesh``), so it also runs on a shape-only mesh.  Under a mesh the
models' tensors are DTensors and ``constraint`` redistributes them; the
plain tensors that the model code makes itself (positions, masks, zeros)
count as replicated there (``implicit_replication``).

``shard_owner_map`` places the keyed-state plane's shards (DESIGN.md §9);
its source equals the reference's (tests/test_torch_isolation.py).
"""
from __future__ import annotations

import contextlib
import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]

class _State(threading.local):
    """The installed mesh and rules of this thread; the class's defaults
    (no mesh) until ``axis_rules`` sets them, so that the plain path reads
    them without a failed lookup."""
    mesh: Any = None
    rules: Dict[str, Axis] = {}


_state = _State()


class PartitionSpec(tuple):
    """A tuple with one entry a tensor dim: a mesh axis name, a tuple of
    them (the dim split over each, major first) or ``None``
    (replicated).  ``PartitionSpec("data", None) == ("data", None)``."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """``mesh.shape`` as a name -> size mapping: a shape-only mesh's own, or
    a ``DeviceMesh``'s dim names zipped with its sizes."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _current() -> Tuple[Any, Dict[str, Axis]]:
    return _state.mesh, _state.rules


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, Axis]):
    """Install logical->mesh axis rules for the enclosed code.  Plain
    tensors meeting DTensors inside count as replicated on the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    old = _current()
    _state.mesh, _state.rules = mesh, dict(rules)
    try:
        with implicit_replication():
            yield
    finally:
        _state.mesh, _state.rules = old


# Default logical->mesh mapping used by the launcher.  ``data`` composes the
# pod axis so multi-pod is batch-parallel across pods by default.
def default_rules(multi_pod: bool) -> Dict[str, Axis]:
    data = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": data,            # batch dim of activations
        "seq": None,              # sequence (train/prefill activations)
        "kv_seq": None,           # KV-cache sequence dim (decode)
        "embed": None,            # d_model
        "heads": "model",         # attention heads / q heads
        "kv_heads": "model",
        "mlp": "model",           # ffn hidden
        "vocab": "model",         # embedding/vocab-parallel
        "experts": "model",       # MoE expert dim
        "experts_data": data,     # expert dim on the data axis (serve EP)
        "expert_fsdp": data,      # expert-weight E dim on data (serve EP)
        "expert_mlp": None,       # per-expert hidden (already expert-sharded)
        "ssm_inner": "model",     # mamba/rwkv channel dim
        "kv_lora": None,          # MLA latent cache dim
        "tp": "model",            # parameter tensor-parallel dim
        "fsdp": data,             # parameter FSDP dim (policy-gated)
        "opt_shard": data,        # ZeRO-1 optimizer-state sharding
        "state_shard": data,      # sharded keyed-state plane: leading shard
        #                           dim of stacked per-shard arenas (§9)
    }


def on_mesh(rules: Dict[str, Axis], mesh) -> Dict[str, Axis]:
    """``rules`` with the axes that ``mesh`` lacks dropped (a rule left
    with none maps to ``None``): the rules of a smaller mesh."""
    have = mesh_sizes(mesh)
    out = {}
    for name, axis in rules.items():
        if axis is None or isinstance(axis, str):
            out[name] = axis if axis in have else None
        else:
            kept = tuple(a for a in axis if a in have)
            out[name] = kept or None
    return out


# ------------------------------------------------------ keyed-state shards
# Placement for the sharded keyed-state plane (DESIGN.md §9): shards (hash
# bins of the key space) are assigned to owners — engine subtasks or mesh
# devices — round-robin, so consecutive shards land on distinct owners and
# a contiguous shard range migrates with maximum source fan-out.

def shard_owner_map(n_shards: int, n_owners: int) -> list:
    """Round-robin shard->owner table.  ``ShardRouter`` builds its default
    bin table from this; ``ShardPlane`` (streaming side, deliberately
    jax-free) keeps an identical inline copy — change both together."""
    if n_shards < n_owners:
        raise ValueError(f"n_shards={n_shards} < n_owners={n_owners}")
    return [s % n_owners for s in range(n_shards)]


def mesh_shard_owners(mesh, n_shards: int, axis: Axis = "data") -> list:
    """Shard->owner table sized to one mesh axis (or axis tuple): owner i
    is the i-th device coordinate along ``axis``, so per-shard arenas
    co-locate with the mesh's data-parallel shards and a ``state_shard``-
    annotated pool stack places its rows on their owners."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    sizes = mesh_sizes(mesh)
    n_owners = 1
    for a in axes:
        n_owners *= sizes[a]
    return shard_owner_map(n_shards, n_owners)


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: Dict[str, Axis]) -> PartitionSpec:
    """Map logical names to a PartitionSpec, dropping axes that do not divide
    the corresponding dimension (divisibility-aware fallback)."""
    sizes = mesh_sizes(mesh)
    used = set()
    out = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if any(a in used for a in axes):
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= sizes[a]
        if size == 0 or dim % size != 0:
            # try a prefix of the axis tuple that divides
            ok = None
            for cut in range(len(axes) - 1, 0, -1):
                s = 1
                for a in axes[:cut]:
                    s *= sizes[a]
                if dim % s == 0:
                    ok = axes[:cut]
                    break
            if ok is None:
                out.append(None)
                continue
            axes = ok
        used.update(axes)
        # keep the rule's tuple-ness, as the reference's specs do
        out.append(axes[0] if isinstance(axis, str) else tuple(axes))
    return PartitionSpec(*out)


def placements(spec: Sequence[Axis], mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that splits tensor dim d, ``Replicate()`` on the others.  A
    tuple of axes on one dim must list them major first, in the mesh's
    order (DTensor splits a dim over its mesh dims in that order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"placements: mesh axis {names[i]} splits "
                                 f"two dims of {tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


_dtensor_type = None     # DTensor, looked up once it can exist


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; cheap on the plain path, which calls it
    at every product, reshape and kernel call.  No DTensor exists before
    ``torch.distributed.tensor`` is imported, and then its class is looked
    up once."""
    global _dtensor_type
    if _dtensor_type is None:
        mod = sys.modules.get("torch.distributed.tensor")
        if mod is None:
            return False
        _dtensor_type = mod.DTensor
    return isinstance(x, _dtensor_type)


def as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``; a plain tensor as a replicated DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constraint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements its logical axis names resolve
    to; ``x`` itself without a mesh."""
    mesh, rules = _current()
    if mesh is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constraint({logical}) vs rank-{x.ndim} tensor")
    target = placements(resolve_spec(logical, x.shape, mesh, rules), mesh)
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def _view(x: torch.Tensor, shape) -> torch.Tensor:
    try:
        return x.reshape(shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate
        whole = [p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in x.placements]
        return x.redistribute(x.device_mesh, whole).reshape(shape)


class _Reshaped(torch.autograd.Function):
    """A DTensor's reshape whose gradient reshapes back by the same rule:
    a gradient may arrive split where its value was not."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _view(g, ctx.shape), None


def reshaped(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  Under a mesh, a split that the new shape
    cannot keep evenly (40 heads over a 16-way model axis, say) is
    gathered first, all but the batch's (dim 0), and so is the gradient's:
    DTensor refuses such a view where the reference's compiler reshards."""
    if not is_dtensor(x):
        return x.reshape(*shape)       # ints: torch parses them faster
    return _Reshaped.apply(x, shape)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product uses it: under a mesh, all-gathered over the
    mesh axes of the ``fsdp`` rule (its gradient then reduce-scatters
    back), its tensor-parallel split kept; ``w`` itself otherwise.  This
    is the weight gather that the reference's compiler picks for FSDP;
    left to itself, DTensor would move the activations instead."""
    if not is_dtensor(w):
        return w
    mesh, rules = _current()
    if mesh is None or not rules.get("fsdp"):
        return w
    from torch.distributed.tensor import Replicate
    fsdp = rules["fsdp"]
    axes = {fsdp} if isinstance(fsdp, str) else set(fsdp)
    names = mesh.mesh_dim_names
    target = tuple(Replicate() if names[i] in axes else p
                   for i, p in enumerate(w.placements))
    if target == tuple(w.placements):
        return w
    return w.redistribute(mesh, target)


def settled(y: torch.Tensor) -> torch.Tensor:
    """A product's pending sums (a contraction split over the mesh, as in
    a row-parallel product) all-reduced at once, its splits kept; ``y``
    itself otherwise.  The reference's compiler settles them so; DTensor
    would instead carry them on and split the hidden dim."""
    if not is_dtensor(y) or not any(p.is_partial() for p in y.placements):
        return y
    from torch.distributed.tensor import Replicate
    return y.redistribute(y.device_mesh, [
        Replicate() if p.is_partial() else p for p in y.placements])


def redistribute(x: torch.Tensor, sh: "NamedSharding") -> torch.Tensor:
    """``x`` on ``sh``'s mesh and placements (a plain tensor taken as
    replicated); ``x`` itself when it is there already."""
    target = sh.placements
    x = as_dtensor(x, sh.mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(sh.mesh, target)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it: the reference's ``NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_sharding(mesh, shape: Sequence[int],
                   logical: Sequence[Optional[str]],
                   rules: Dict[str, Axis]) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(logical, shape, mesh, rules))
