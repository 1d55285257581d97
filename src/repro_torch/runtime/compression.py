"""Hint-channel delta codec (DESIGN.md §13): a copy of the codec half of
``repro/runtime/compression.py`` (``delta_encode_keys``,
``delta_decode_keys``, ``hint_batch_nbytes``), which the engine uses to
size hint batches.  The int8 gradient compression of that module belongs
to the training path and is not part of this package yet.
"""
from __future__ import annotations

from typing import Any, Iterable, List

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
