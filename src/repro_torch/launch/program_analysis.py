"""Per-device cost of a traced torch program: the port's counterpart of
``repro/launch/hlo_analysis.py``, which reads a partitioned XLA module.
Torch has no such module, so this counts the program as it runs, on
meta tensors under a fake process group (``launch/dryrun.py``) or on real
ones.

``analyze()`` is a context manager that fills a ``Totals`` (the
reference's fields) with what one device does:

  * flops       — the matrix products, convolutions and attention calls
                  that ``torch.utils.flop_counter`` (``FlopCounterMode``'s
                  registry) counts, taken at the shapes of the local
                  shards, plus each hand-written kernel call at the cost
                  ``kernels/costs.py`` gives it (a kernel given meta
                  tensors books its cost instead of running);
  * bytes       — each op's operand and result bytes, once a tensor an op
                  (no fusion: every op reads and writes memory), views and
                  allocations free;
  * collectives — the operand bytes of each collective that DTensor
                  issues (``_c10d_functional`` all-gather, all-reduce,
                  reduce-scatter, all-to-all, broadcast), by kind, and
                  apart those of groups that span nodes (``hw.node_of``),
                  which ``hw.roofline_terms`` costs at the network's rate;
                  the count of calls is ``CommDebugMode``'s;
  * memory      — the bytes of the local tensors alive at each op's end,
                  whose most is ``peak_live_bytes`` (an estimate: nothing
                  is fused or freed early, as a compiler would).

A DTensor op is counted where DTensor runs it on the local shards (the
mode lets DTensor dispatch first); the global-shape propagation that
DTensor runs on fake tensors is not counted.  ``Totals.scaled`` and
``Totals.add`` combine runs: the dry run traces one microbatch and
multiplies it by the microbatch count, the reference's loop trip count.
``trip_warnings`` stays empty: nothing is a loop the count cannot see.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs
from repro_torch.launch import hw

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
         "set_", "resize_", "_local_scalar_dense"}


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    inter_node_bytes: float = 0.0
    by_collective: Dict[str, float] = field(default_factory=dict)
    trip_warnings: List[str] = field(default_factory=list)
    n_collectives: int = 0
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    top_collectives: List[Tuple[float, str]] = field(default_factory=list)
    peak_live_bytes: float = 0.0
    flops_by_op: Dict[str, float] = field(default_factory=dict)

    def note_flops(self, op: str, f: float) -> None:
        self.flops += f
        self.flops_by_op[op] = self.flops_by_op.get(op, 0.0) + f

    def note_bytes(self, op: str, b: float) -> None:
        self.bytes += b
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b

    def note_collective(self, kind: str, b: float, raw: str,
                        spans_nodes: bool = False) -> None:
        self.collective_bytes += b
        if spans_nodes:
            self.inter_node_bytes += b
        self.by_collective[kind] = self.by_collective.get(kind, 0.0) + b
        self.top_collectives.append((b, raw[:220]))
        self.top_collectives.sort(key=lambda x: -x[0])
        del self.top_collectives[12:]

    def scaled(self, k: float) -> "Totals":
        """These totals ``k`` times over (a loop of ``k`` trips); the
        peak stays."""
        return Totals(
            flops=self.flops * k, bytes=self.bytes * k,
            collective_bytes=self.collective_bytes * k,
            inter_node_bytes=self.inter_node_bytes * k,
            by_collective={n: b * k for n, b in self.by_collective.items()},
            trip_warnings=list(self.trip_warnings),
            n_collectives=int(self.n_collectives * k),
            bytes_by_op={n: b * k for n, b in self.bytes_by_op.items()},
            top_collectives=[(b * k, f"x{k:g} {r}")
                             for b, r in self.top_collectives],
            peak_live_bytes=self.peak_live_bytes,
            flops_by_op={n: f * k for n, f in self.flops_by_op.items()})

    def add(self, o: "Totals") -> "Totals":
        """Both runs, one after the other."""
        def merged(a, b):
            return {n: a.get(n, 0.0) + b.get(n, 0.0) for n in {*a, *b}}
        top = sorted(self.top_collectives + o.top_collectives,
                     key=lambda x: -x[0])[:12]
        return Totals(
            flops=self.flops + o.flops, bytes=self.bytes + o.bytes,
            collective_bytes=self.collective_bytes + o.collective_bytes,
            inter_node_bytes=self.inter_node_bytes + o.inter_node_bytes,
            by_collective=merged(self.by_collective, o.by_collective),
            trip_warnings=self.trip_warnings + o.trip_warnings,
            n_collectives=self.n_collectives + o.n_collectives,
            bytes_by_op=merged(self.bytes_by_op, o.bytes_by_op),
            top_collectives=top,
            peak_live_bytes=max(self.peak_live_bytes, o.peak_live_bytes),
            flops_by_op=merged(self.flops_by_op, o.flops_by_op))


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return isinstance(t, torch.Tensor) and is_fake(t)


class _Counter(TorchDispatchMode):
    """Counts the local ops of a program (module docstring)."""

    def __init__(self, totals: Totals):
        super().__init__()
        self.totals = totals
        self.live = 0
        self.spans: Dict[str, bool] = {}

    def _spans_nodes(self, group_name: str) -> bool:
        """Whether the group holds ranks of more than one node."""
        if group_name not in self.spans:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            self.spans[group_name] = len({hw.node_of(r)
                                          for r in ranks}) > 1
        return self.spans[group_name]

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor first; its local ops after
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(_is_fake(t) for t in outs):
            return out                  # DTensor's shape propagation
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        ins = _tensors((args, kwargs))
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            b = sum(_nbytes(t) for t in ins)
            kind = _COLLECTIVES[name]
            self.totals.note_collective(
                kind, b, f"{kind} {[tuple(t.shape) for t in ins]} "
                         f"{ins[0].dtype if ins else ''}",
                self._spans_nodes(kwargs.get("group_name", args[-1])))
            self.totals.n_collectives += 1
            return out
        if name in _FREE or ns == "_c10d_functional":
            return out
        if packet in flop_registry:
            self.totals.note_flops(name, flop_registry[packet](
                *args, **kwargs, out_val=out))
        aliases = {id(t) for t in ins}
        schema = func._schema
        view = (not schema.is_mutable and any(
            r.alias_info is not None for r in schema.returns))
        if view:
            return out
        seen, b = set(), 0
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                b += _nbytes(t)
        self.totals.note_bytes(name, b)
        for t in outs:
            if id(t) in aliases or t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.totals.peak_live_bytes = max(self.totals.peak_live_bytes,
                                          self.live)
        return out


@contextlib.contextmanager
def analyze():
    """Count what runs inside, per device; yields the ``Totals``."""
    from torch.distributed.tensor.debug import CommDebugMode
    totals = Totals()

    def booked(name: str, flops: float, nbytes: float) -> None:
        totals.note_flops(f"kernel:{name}", flops)
        totals.note_bytes(f"kernel:{name}", nbytes)

    comm = CommDebugMode()
    with costs.listening(booked), comm, _Counter(totals):
        yield totals
    counted = sum(comm.get_comm_counts().values())
    if counted != totals.n_collectives:
        totals.trip_warnings.append(
            f"CommDebugMode counted {counted} collectives, the local ops "
            f"{totals.n_collectives}")
    totals.n_collectives = counted
