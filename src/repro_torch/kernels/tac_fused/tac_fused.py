"""The fused plane's batch step and admission, one CUDA kernel launch each
(``csrc/tac_fused.cu``), their plain PyTorch versions, and the packed
layouts that carry a batch to the card and its results back in one copy
each.

``fused_step`` computes ``tac_jax.fused_step`` (probe, gather, duplicate-key
composition, timestamp refresh, write-back, dirty bits, tallies) and
``fused_admit`` computes ``tac_jax.fused_admit`` (victim gather, row
scatter, directory writes).  Both update the directory (``state``, a
``TACState``: ``keys``, ``ts``, ``vals``, ``dirty``) and the pool
``pages [n_slots + 1, 1, V + 1]`` IN PLACE.  The kernels take a directory
of one bucket, which every ``FusedPlane`` has; the plain versions take any.
Each wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; it never falls back from one to the other.

Packed layouts, fields end to end (the 4-byte ones first, so every field
is aligned):

- step inputs, bytes: ``keys i32 [B] | ts f32 [B] | weights f32 [B, V] |
  fire bool [B] | valid bool [B]``;
- step outputs, int32 words: ``hit [B] | slots [B] | present [B] |
  tallies [2] | new_vals f32 bits [B, V]``;
- admit inputs, bytes: ``slots i32 [N] | kids i32 [N] | ts f32 [N] |
  rows f32 [N, V] | present bool [N] | dirty bool [N]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.page_gather.page_gather import (page_gather_plain,
                                                         page_scatter_plain)
from repro_torch.kernels.tac_probe.ops import bucket_of
from repro_torch.kernels.tac_probe.tac_probe import tac_probe_plain

# launches of each CUDA kernel (not of the plain versions) since the last
# reset
STEP_LAUNCHES = 0
ADMIT_LAUNCHES = 0

KINDS = ("sum", "max", "read")        # the kernel's kind code is the index
INT32_MAX = 2 ** 31 - 1

# ----------------------------------------------------------- packed layouts
_SIZE = {"i4": 4, "f4": 4, "b1": 1}
_NUMPY = {"i4": np.int32, "f4": np.float32, "b1": np.bool_}
_TORCH = {"i4": torch.int32, "f4": torch.float32, "b1": torch.bool}


def step_in_fields(B: int, V: int):
    return (("i4", B), ("f4", B), ("f4", B * V), ("b1", B), ("b1", B))


def admit_in_fields(N: int, V: int):
    return (("i4", N), ("i4", N), ("f4", N), ("f4", N * V), ("b1", N),
            ("b1", N))


def nbytes(fields) -> int:
    return sum(n * _SIZE[t] for t, n in fields)


def step_out_words(B: int, V: int) -> int:
    return 3 * B + 2 + B * V


def split(buf, fields):
    """1-D views of the packed byte buffer ``buf`` (a numpy or torch uint8
    array of ``nbytes(fields)``) as ``fields``."""
    types = _TORCH if isinstance(buf, torch.Tensor) else _NUMPY
    views, at = [], 0
    for t, n in fields:
        views.append(buf[at:at + n * _SIZE[t]].view(types[t]))
        at += n * _SIZE[t]
    return views


def fill(buf: np.ndarray, fields, *arrays) -> np.ndarray:
    """Write ``arrays`` (one a field, any shape of the field's size) into
    the packed numpy byte buffer ``buf``; returns ``buf``."""
    for view, a in zip(split(buf, fields), arrays):
        view[:] = np.asarray(a).reshape(-1)
    return buf


def unpack_step_out(out, B: int, V: int):
    """(hit, slots, present, tallies, new_vals [B, V]) as views of a packed
    step output (numpy or torch int32); ``hit`` and ``present`` as bool."""
    f32 = torch.float32 if isinstance(out, torch.Tensor) else np.float32
    return (out[:B] != 0, out[B:2 * B], out[2 * B:3 * B] != 0,
            out[3 * B:3 * B + 2], out[3 * B + 2:].view(f32).reshape(B, V))


def pack_step_out(hit, slots, present, tallies, new_vals) -> torch.Tensor:
    return torch.cat([hit.int(), slots.int(), present.int(), tallies.int(),
                      new_vals.float().contiguous().view(torch.int32)
                      .view(-1)])


def check_slots(slots: np.ndarray, n_slots: int) -> None:
    """Raise ``IndexError`` for an admit slot outside [0, n_slots): the
    packed admit's range check, made on the host array before packing."""
    if len(slots) and (slots.min() < 0 or slots.max() >= n_slots):
        raise IndexError(f"tac_fused_admit: slot outside [0, {n_slots})")


# ---------------------------------------------------------- plain versions
def _flat(t: torch.Tensor) -> torch.Tensor:
    """1-D view sharing storage (bool viewed as uint8 for reductions)."""
    t = t.view(-1)
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def fused_step_plain(state, pages, keys, ts, weights, fire, valid,
                     kind: str = "sum"):
    """The batch step in plain PyTorch, IN PLACE on ``state`` and
    ``pages``.  Returns ``(hit, slots, new_vals, present, tallies)``, as
    ``tac_jax.fused_step``'s fields of those names."""
    B = keys.shape[0]
    n_buckets, ways = state.keys.shape
    trash = pages.shape[0] - 1
    buckets = bucket_of(keys, n_buckets)
    _, hit, way = tac_probe_plain(keys.int(), buckets, state.keys,
                                  state.vals)
    hit = hit.bool()
    slots = torch.where(hit, buckets * ways + way.clamp(min=0), trash).int()
    # the row at the probe's way, valid or not, as the reference gathers it
    rows = page_gather_plain(slots, pages)
    hit = hit & valid
    slots = torch.where(hit, slots, trash).int()
    # flat directory index of a hit (bucket * ways + way); misses alias 0
    # with a neutral value, so the max-scatters below ignore them
    at = torch.where(hit, slots, 0).long()
    # timestamp refresh on hits (advisory fp32 copy; the fp64 eviction
    # order lives in the host shadow, §14)
    _flat(state.ts).scatter_reduce_(
        0, at, torch.where(hit, ts, -float("inf")), "amax")
    g = rows[:, 0, 1:]                          # [B, V] current value
    f = rows[:, 0, 0] > 0.5                     # [B] presence
    upd = torch.zeros_like(hit) if kind == "read" else hit & ~fire
    same = keys[:, None] == keys[None, :]
    M = same & upd[None, :] & torch.ones(
        (B, B), dtype=torch.bool, device=keys.device).tril()
    hasupd = M.any(dim=1)
    if kind == "max":
        m = torch.where(M[:, :, None], weights[None, :, :],
                        -float("inf")).amax(dim=1)
        new_v = torch.maximum(torch.where(f[:, None], g, -float("inf")), m)
    else:                                       # sum (count = sum of ones)
        new_v = torch.where(f[:, None], g, 0.0) + M.to(weights.dtype) @ weights
    present = f | hasupd
    new_v = torch.where(present[:, None], new_v, 0.0)
    if kind != "read":
        blocks = torch.cat([present[:, None].to(pages.dtype),
                            new_v.to(pages.dtype)], dim=1)[:, None, :]
        page_scatter_plain(torch.where(upd, slots, trash), blocks, pages)
        # the scratch row must stay "absent" for future miss gathers
        pages[trash].zero_()
        _flat(state.dirty).scatter_reduce_(0, at, upd.to(torch.uint8),
                                           "amax")
    tallies = torch.stack([hit.sum(), (valid & ~hit).sum()]).int()
    return hit, slots, new_v, present, tallies


def fused_admit_plain(state, pages, slots, keys, ts, rows, present, dirty):
    """The admission in plain PyTorch, IN PLACE.  Returns the victim rows
    ``[N, 1, V + 1]`` gathered before the overwrite.  Raises
    ``IndexError`` for a slot outside the directory."""
    n_dir = state.keys.numel()
    if slots.numel() and bool(((slots < 0) | (slots >= n_dir)).any()):
        raise IndexError(f"tac_fused_admit: slot outside [0, {n_dir})")
    victim_rows = page_gather_plain(slots, pages)
    blocks = torch.cat([present[:, None].to(pages.dtype),
                        rows.to(pages.dtype)], dim=1)[:, None, :]
    page_scatter_plain(slots, blocks, pages)
    pages[-1].zero_()
    # duplicate slots carry identical records, so any write order is exact
    at = slots.long()
    _flat(state.keys).scatter_(0, at, keys.int())
    _flat(state.ts).scatter_(0, at, ts.float())
    _flat(state.dirty).scatter_(0, at, dirty.to(torch.uint8))
    return victim_rows


# ----------------------------------------------------------------- kernels
# lanes of a probe partition and of a tail tile of the step kernel (its
# kTile); a larger batch keeps its tail's arrays in the workspace
STEP_TILE = 1024

_WORKSPACE = {}     # (device index, stream) -> the step's int32 workspace


def _lib():
    lib = cuda_build.load("tac_fused")
    if lib.tac_fused_step.argtypes is None:
        lib.tac_fused_step.argtypes = [ctypes.c_void_p] * 13 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.tac_fused_admit.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        for fn in (lib.tac_fused_step, lib.tac_fused_admit,
                   lib.tac_fused_tile, lib.tac_fused_step_blocks):
            fn.restype = ctypes.c_int
        lib.tac_fused_step_blocks.argtypes = [ctypes.c_int] * 2
        if lib.tac_fused_tile() != STEP_TILE:
            raise RuntimeError(f"tac_fused: the kernel's tile is "
                               f"{lib.tac_fused_tile()}, not {STEP_TILE}")
    return lib


def _check_plane(state, pages, what: str) -> None:
    """Device, type, shape and layout of a directory and its pool; the
    kernels take one bucket of W ways and a contiguous f32 pool
    [W + 1, 1, V + 1]."""
    dev = pages.device
    if any(t.device != dev for t in (state.keys, state.ts, state.dirty)):
        raise ValueError(f"{what}: directory and pool on different devices")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    if state.keys.dim() != 2 or state.keys.shape[0] != 1:
        raise ValueError(f"{what}: the kernel takes a directory of one "
                         f"bucket, not {tuple(state.keys.shape)}")
    W = state.keys.shape[1]
    if (state.keys.dtype, state.ts.dtype, state.dirty.dtype,
            pages.dtype) != (torch.int32, torch.float32, torch.bool,
                             torch.float32):
        raise TypeError(f"{what}: directory int32/f32/bool and an f32 pool "
                        f"expected")
    if state.ts.shape != state.keys.shape \
            or state.dirty.shape != state.keys.shape \
            or pages.dim() != 3 or pages.shape[:2] != (W + 1, 1):
        raise ValueError(f"{what}: pool [W + 1, 1, V + 1] for a directory "
                         f"of W = {W} ways expected")
    if not all(t.is_contiguous() for t in (state.keys, state.ts,
                                           state.dirty, pages)):
        raise ValueError(f"{what}: tensors must be contiguous")


def step_workspace_words(B: int, W: int, V: int):
    """int32 words of the step kernel's workspace at B lanes, W ways and V
    channels: ``ways`` (a ticket and a way a lane, kept clean), ``firsts``
    (a lane a way, kept clean; only past one tile) and ``scratch`` (each
    lane's partition, and past one tile the tail's lane and key arrays and
    the folds carried between tiles)."""
    many = B > STEP_TILE
    return 1 + B, W if many else 0, B + (7 * B + B * V if many else 0)


def _workspace(dev: torch.device, stream: int, B: int, W: int, V: int):
    """The step kernel's workspace for ``stream``, grown on demand:
    ``(ways, firsts, scratch)``.  ``ways`` holds a ticket at 0 and
    INT32_MAX, ``firsts`` INT32_MAX, which every launch leaves as it
    found; ``scratch`` needs no contents."""
    bufs = _WORKSPACE.setdefault((dev.index, stream), {})
    for name, n in zip(("ways", "firsts", "scratch"),
                       step_workspace_words(B, W, V)):
        buf = bufs.get(name)
        if buf is None or buf.numel() < n:
            if name == "scratch":
                buf = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
            else:
                buf = torch.full((max(n, 1),), INT32_MAX, dtype=torch.int32,
                                 device=dev)
                if name == "ways":
                    buf[0] = 0
            bufs[name] = buf
    return bufs["ways"], bufs["firsts"], bufs["scratch"]


def _launch_step(state, pages, keys, ts, weights, fire, valid, out,
                 kind: str) -> None:
    global STEP_LAUNCHES
    B = keys.shape[0]
    W = state.keys.shape[1]
    V = pages.shape[-1] - 1
    if kind not in KINDS:
        raise ValueError(f"tac_fused_step: kind {kind!r}")
    dev = pages.device
    ins = (keys, ts, weights, fire, valid)
    if any(t.device != dev for t in ins):
        raise ValueError("tac_fused_step: lanes and pool on different "
                         "devices")
    if tuple(t.numel() for t in ins) != (B, B, B * V, B, B) \
            or (keys.dtype, ts.dtype, weights.dtype, fire.dtype,
                valid.dtype) != (torch.int32, torch.float32, torch.float32,
                                 torch.bool, torch.bool) \
            or not all(t.is_contiguous() for t in ins):
        raise ValueError("tac_fused_step: contiguous keys i32 [B], ts f32 "
                         "[B], weights f32 [B, V], fire and valid bool [B] "
                         "expected")
    stream = cuda_build.stream_ptr(dev)
    ways, firsts, scratch = _workspace(dev, stream, B, W, V)
    err = _lib().tac_fused_step(
        keys.data_ptr(), ts.data_ptr(), weights.data_ptr(), fire.data_ptr(),
        valid.data_ptr(), state.keys.data_ptr(), state.ts.data_ptr(),
        state.dirty.data_ptr(), pages.data_ptr(), out.data_ptr(),
        ways.data_ptr(), firsts.data_ptr(), scratch.data_ptr(), B, W, V,
        KINDS.index(kind), stream)
    cuda_build.check(err, "tac_fused_step")
    STEP_LAUNCHES += 1


def _launch_admit(state, pages, slots, kids, ts, rows, present, dirty,
                  victims) -> None:
    global ADMIT_LAUNCHES
    N = slots.shape[0]
    W = state.keys.shape[1]
    V = pages.shape[-1] - 1
    ins = (slots, kids, ts, rows, present, dirty)
    if any(t.device != pages.device for t in ins):
        raise ValueError("tac_fused_admit: records and pool on different "
                         "devices")
    if tuple(t.numel() for t in ins) != (N, N, N, N * V, N, N) \
            or (slots.dtype, kids.dtype, ts.dtype, rows.dtype,
                present.dtype, dirty.dtype) != (
                    torch.int32, torch.int32, torch.float32, torch.float32,
                    torch.bool, torch.bool) \
            or not all(t.is_contiguous() for t in ins):
        raise ValueError("tac_fused_admit: contiguous slots and kids i32 "
                         "[N], ts f32 [N], rows f32 [N, V], present and "
                         "dirty bool [N] expected")
    err = _lib().tac_fused_admit(
        slots.data_ptr(), kids.data_ptr(), ts.data_ptr(), rows.data_ptr(),
        present.data_ptr(), dirty.data_ptr(), state.keys.data_ptr(),
        state.ts.data_ptr(), state.dirty.data_ptr(), pages.data_ptr(),
        victims.data_ptr(), N, W, V, cuda_build.stream_ptr(pages.device))
    cuda_build.check(err, "tac_fused_admit")
    ADMIT_LAUNCHES += 1


# ---------------------------------------------------------------- wrappers
def fused_step(state, pages, keys, ts, weights, fire, valid,
               kind: str = "sum"):
    """keys int32 [B]; ts f32 [B]; weights [B, V]; fire, valid bool [B].
    Returns ``(hit, slots, new_vals, present, tallies)`` and updates
    ``state`` and ``pages`` IN PLACE."""
    _check_plane(state, pages, "tac_fused_step")
    if pages.device.type == "cpu":
        return fused_step_plain(state, pages, keys, ts, weights, fire, valid,
                                kind)
    B, V = keys.shape[0], pages.shape[-1] - 1
    out = torch.empty(step_out_words(B, V), dtype=torch.int32,
                      device=pages.device)
    _launch_step(state, pages, keys.int().contiguous(),
                 ts.float().contiguous(), weights.float().contiguous(),
                 fire.bool().contiguous(), valid.bool().contiguous(), out,
                 kind)
    hit, slots, present, tallies, new_vals = unpack_step_out(out, B, V)
    return hit, slots, new_vals, present, tallies


def fused_step_packed(state, pages, packed, B: int,
                      kind: str = "sum") -> torch.Tensor:
    """``fused_step`` on packed step inputs (uint8, on the pool's device).
    Returns the packed step output (int32 words)."""
    _check_plane(state, pages, "tac_fused_step")
    V = pages.shape[-1] - 1
    fields = step_in_fields(B, V)
    if packed.dtype != torch.uint8 or packed.numel() != nbytes(fields):
        raise ValueError(f"tac_fused_step: packed inputs of "
                         f"{nbytes(fields)} bytes expected")
    keys, ts, weights, fire, valid = split(packed, fields)
    if pages.device.type == "cpu":
        hit, slots, new_vals, present, tallies = fused_step_plain(
            state, pages, keys, ts, weights.view(B, V), fire, valid, kind)
        return pack_step_out(hit, slots, present, tallies, new_vals)
    out = torch.empty(step_out_words(B, V), dtype=torch.int32,
                      device=pages.device)
    _launch_step(state, pages, keys, ts, weights, fire, valid, out, kind)
    return out


def fused_admit(state, pages, slots, keys, ts, rows, present, dirty):
    """slots, keys int32 [N]; ts [N]; rows [N, V]; present, dirty bool [N].
    Returns the victim rows ``[N, 1, V + 1]`` and updates ``state`` and
    ``pages`` IN PLACE.  Raises ``IndexError`` for a slot outside the
    directory (on a CUDA tensor that check reads one flag back)."""
    _check_plane(state, pages, "tac_fused_admit")
    if pages.device.type == "cpu":
        return fused_admit_plain(state, pages, slots, keys, ts, rows,
                                 present, dirty)
    W = state.keys.shape[1]
    if slots.numel() and bool(((slots < 0) | (slots >= W)).any()):
        raise IndexError(f"tac_fused_admit: slot outside [0, {W})")
    victims = torch.empty((slots.shape[0], 1, pages.shape[-1]),
                          dtype=pages.dtype, device=pages.device)
    _launch_admit(state, pages, slots.int().contiguous(),
                  keys.int().contiguous(), ts.float().contiguous(),
                  rows.float().contiguous(), present.bool().contiguous(),
                  dirty.bool().contiguous(), victims)
    return victims


def fused_admit_packed(state, pages, packed, N: int) -> torch.Tensor:
    """``fused_admit`` on packed admit inputs (uint8, on the pool's
    device), whose slots the caller checked with ``check_slots``.  Returns
    the victim rows."""
    _check_plane(state, pages, "tac_fused_admit")
    V = pages.shape[-1] - 1
    fields = admit_in_fields(N, V)
    if packed.dtype != torch.uint8 or packed.numel() != nbytes(fields):
        raise ValueError(f"tac_fused_admit: packed inputs of "
                         f"{nbytes(fields)} bytes expected")
    slots, kids, ts, rows, present, dirty = split(packed, fields)
    if pages.device.type == "cpu":
        return fused_admit_plain(state, pages, slots, kids, ts,
                                 rows.view(N, V), present, dirty)
    victims = torch.empty((N, 1, V + 1), dtype=pages.dtype,
                          device=pages.device)
    _launch_admit(state, pages, slots, kids, ts, rows, present, dirty,
                  victims)
    return victims
