"""Wire compression, in PyTorch: the port of ``repro/runtime/compression.py``.

* **Hint-channel delta codec** (DESIGN.md §13): ``delta_encode_keys``,
  ``delta_decode_keys`` and ``hint_batch_nbytes``, copied as they are; the
  engine uses them to size hint batches.
* **int8 gradient compression with error feedback**: ``make_compressor``
  returns a grad_transform for ``launch/steps.py``'s ``make_train_step``;
  the quantisation error carries into the next step (Karimireddy et al.
  2019).  ``quantize_int8`` takes a lossless scale-1 path for integer
  tensors and raises when a value cannot be represented exactly in int8,
  as the reference's does.  The reference's ``int8_allreduce`` is a
  collective over a mesh axis and comes with the port's launch modules.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

import torch

from repro_torch.optim.adamw import tree_map

_U64_MAX = (1 << 64) - 1
_ESCAPE = 0xFF


# --------------------------------------------------------- hint-key codec
def delta_encode_keys(keys: Iterable[int]) -> bytes:
    """Encode an integer key batch as sorted base + deltas (format above).

    Input order is NOT preserved (hints are order-free); duplicates are.
    Raises ``ValueError`` for negative keys or keys above 2**64 - 1 —
    the caller falls back to fixed-width for such batches.
    """
    ks = sorted(int(k) for k in keys)
    if ks and (ks[0] < 0 or ks[-1] > _U64_MAX):
        raise ValueError(f"key out of u64 range: "
                         f"[{ks[0]}, {ks[-1]}] not in [0, 2**64)")
    out = bytearray(len(ks).to_bytes(4, "little"))
    if not ks:
        return bytes(out)
    out += ks[0].to_bytes(8, "little")
    prev = ks[0]
    for k in ks[1:]:
        d = k - prev
        prev = k
        if d < _ESCAPE:
            out.append(d)
        else:
            out.append(_ESCAPE)
            out += d.to_bytes(8, "little")
    return bytes(out)


def delta_decode_keys(buf: bytes) -> List[int]:
    """Inverse of ``delta_encode_keys``: the sorted key multiset."""
    n = int.from_bytes(buf[:4], "little")
    if n == 0:
        if len(buf) != 4:
            raise ValueError("trailing bytes after empty batch")
        return []
    ks = [int.from_bytes(buf[4:12], "little")]
    i = 12
    for _ in range(n - 1):
        d = buf[i]
        i += 1
        if d == _ESCAPE:
            d = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        ks.append(ks[-1] + d)
    if i != len(buf):
        raise ValueError(f"trailing bytes: consumed {i} of {len(buf)}")
    return ks


def hint_batch_nbytes(keys: Iterable[Any], ts_bytes: int = 4) -> int:
    """Wire size of one flushed hint batch under the delta codec
    (DESIGN.md §13).  Plain int keys form one delta stream; int tuples
    (``WindowKey`` et al.) form one stream per position, grouped by
    arity; anything else (string keys, negatives) falls back to 8 bytes.
    Each hint additionally carries its access timestamp as float32
    (``ts_bytes``) — timestamps do not cluster like keys, so they ship
    uncompressed."""
    ints: List[int] = []
    tuple_streams: dict = {}        # arity -> list of position streams
    fallback = 0
    n = 0
    for k in keys:
        n += 1
        if isinstance(k, bool):
            fallback += 8
        elif isinstance(k, int):
            if 0 <= k <= _U64_MAX:
                ints.append(k)
            else:
                fallback += 8
        elif isinstance(k, tuple) and k and \
                all(isinstance(p, int) and 0 <= p <= _U64_MAX for p in k):
            streams = tuple_streams.setdefault(
                len(k), [[] for _ in range(len(k))])
            for i, p in enumerate(k):
                streams[i].append(p)
        else:
            fallback += 8
    total = fallback + ts_bytes * n
    if ints:
        total += len(delta_encode_keys(ints))
    for streams in tuple_streams.values():
        for stream in streams:
            total += len(delta_encode_keys(stream))
    return total


# ---------------------------------------------------- int8 grad compression
def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise to int8 with a per-tensor scale.

    Float tensors keep the gradient-compression semantics (lossy, max-abs
    scale).  INTEGER tensors take a lossless scale-1 path — a float scale
    would corrupt key deltas — and raise when any value falls outside
    [-127, 127] (callers escape to ``delta_encode_keys``)."""
    x = torch.as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        if x.numel() and int(x.to(torch.int64).abs().max()) > 127:
            raise ValueError(
                "integer payload exceeds int8 range; int8 quantisation "
                "would be lossy — delta-encode keys first "
                "(delta_encode_keys)")
        return x.to(torch.int8), torch.tensor(1.0, dtype=torch.float32,
                                              device=x.device)
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_compressor() -> Tuple[Callable, Callable]:
    """Returns (init_error_state, grad_transform(grads, err) ->
    (grads', err')) over trees of tensors (dicts, lists, tuples)."""

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def one(g, e):
        g32 = g.float() + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), g32 - deq

    def transform(grads, err):
        return _map_pair(one, grads, err)

    return init, transform


def _map_pair(fn, a, b) -> Tuple[Any, Any]:
    """``fn(leaf_a, leaf_b) -> (x, y)`` over two trees of one structure;
    returns the tree of the x and the tree of the y."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, dict):
        parts = {k: _map_pair(fn, a[k], b[k]) for k in a}
        return ({k: p[0] for k, p in parts.items()},
                {k: p[1] for k, p in parts.items()})
    parts = [_map_pair(fn, x, y) for x, y in zip(a, b)]
    return type(a)(p[0] for p in parts), type(a)(p[1] for p in parts)
