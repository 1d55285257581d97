"""The kernels under a mesh.  A kernel takes pointers to storage, which a
DTensor has none of, so a wrapper given DTensors runs its kernel on the
local shards through ``torch.distributed.tensor.experimental.local_map``.

The layout is the lead operand's (q, x or r): a mesh dim either splits
one of the dims the kernel allows (batch and heads for K6-K8) or
replicates it.  Every other operand must be on the same layout, mapped to
its own dims, or replicated there, in which case it is cut to the layout
on each shard (a local slice, no communication; a plain tensor counts as
replicated).  Anything else, a partial sum, a split the kernel does not
take or one that differs from the lead's, raises: nothing is
redistributed over the network behind the caller's back.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.launch.sharding import as_dtensor, is_dtensor

Layout = Tuple[Optional[int], ...]      # a mesh dim -> the lead's dim


def any_dtensor(*args) -> bool:
    return any(map(is_dtensor, args))


def mesh_of(*args):
    return next(a.device_mesh for a in args if is_dtensor(a))


def layout(name: str, lead, mesh, allowed: Dict[int, str]) -> Layout:
    """The lead operand's layout; raises on a partial sum or a split of a
    dim outside ``allowed`` (dim -> its name, for the message)."""
    lead = as_dtensor(lead, mesh)
    out = []
    for p in lead.placements:
        if p.is_shard() and p.dim in allowed:
            out.append(p.dim)
        elif p.is_replicate():
            out.append(None)
        else:
            raise ValueError(
                f"{name}: the kernel takes its operands split over "
                f"{' and '.join(allowed.values())} only, not placed "
                f"{tuple(lead.placements)}")
    return tuple(out)


def _target(lay: Layout, dims: Dict[int, Optional[int]]) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[d]) if d is not None and dims.get(d) is not None
                 else Replicate() for d in lay)


def placed(name: str, t, mesh, lay: Layout,
           dims: Dict[int, Optional[int]]):
    """``t`` on the layout ``lay``, the lead's dim d being ``t``'s dim
    ``dims[d]`` (None: ``t`` stays replicated on a mesh dim that splits
    d).  A replicated ``t`` is cut to it locally; any other difference
    raises."""
    if t is None:
        return None
    t = as_dtensor(t, mesh)
    want = _target(lay, dims)
    if tuple(t.placements) == want:
        return t
    for i, (have, w) in enumerate(zip(t.placements, want)):
        if have == w:
            continue
        if have.is_replicate() and w.is_shard():
            split = math.prod(mesh.size(j) for j, x in enumerate(want)
                              if x == w)
            if t.shape[w.dim] % split == 0:
                continue
        raise ValueError(f"{name}: an operand of shape {tuple(t.shape)} "
                         f"placed {tuple(t.placements)} is not on the "
                         f"kernel's layout {want}")
    return t.redistribute(mesh, want)


def run(fn: Callable, mesh, args: Sequence, lay: Layout,
        out_dims: Sequence[Dict[int, Optional[int]]]):
    """``fn`` on the local shards of ``args`` (DTensors on their layouts,
    or None), its outputs placed by ``out_dims`` (one map an output)."""
    from torch.distributed.tensor.experimental import local_map
    outs = tuple(_target(lay, d) for d in out_dims)
    ins = tuple(None if a is None else tuple(a.placements) for a in args)
    # one output's placements go as a list: a tuple means one an output
    return local_map(fn, out_placements=list(outs[0]) if len(outs) == 1
                     else outs,
                     in_placements=ins, device_mesh=mesh,
                     redistribute_inputs=False)(*args)


SAME4 = {0: 0, 2: 2}            # [B, S, H, *] -> [B, S, H, *]
BH = {0: 0, 2: 1}               # [B, S, H, *] -> [B, H, ...]

