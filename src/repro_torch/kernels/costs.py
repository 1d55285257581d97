"""What the hand-written kernels of the LM path cost: the flops each
launch does and the bytes it must move (each input read once, each output
written once), as functions of its shapes.

``chip_smoke.py`` bounds each kernel's time by them, and
``launch/program_analysis.py`` books each kernel call of a traced program
by them: a wrapper given meta tensors runs no kernel and no plain version,
it returns empty outputs of the right shapes and calls ``book``, which
hands the cost to whatever analysis is listening.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

Cost = Tuple[float, float]          # (flops, bytes)

_LISTENERS: List[Callable[[str, float, float], None]] = []


def book(name: str, cost: Cost) -> None:
    """Hand one kernel call's (flops, bytes) to the listening analyses."""
    for fn in list(_LISTENERS):
        fn(name, *cost)


@contextlib.contextmanager
def listening(fn: Callable[[str, float, float], None]):
    """Call ``fn(name, flops, bytes)`` for each kernel call booked inside."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


def flash_fwd(B: int, S: int, T: int, H: int, KV: int, d: int, dv: int,
              causal: bool, itemsize: int) -> Cost:
    """K6: 2 S T (d + dv) B H flops, halved when causal; q, k, v read and
    the output written once."""
    flops = 2 * S * T * (d + dv) * B * H / (2 if causal else 1)
    return flops, (B * S * H + B * T * KV) * (d + dv) * itemsize


def flash_bwd(B: int, S: int, T: int, H: int, KV: int, d: int, dv: int,
              causal: bool, itemsize: int) -> Cost:
    """K6's backward: 2.5 x the forward's flops; q, k, v, out, dout read,
    dq, dk, dv written, and the fp32 row log-sum-exps read."""
    flops = 2.5 * flash_fwd(B, S, T, H, KV, d, dv, causal, itemsize)[0]
    nbytes = 2 * (B * S * H * d + B * T * KV * d + B * T * KV * dv
                  + B * S * H * dv) * itemsize + 4 * B * H * S
    return flops, nbytes


def mamba_fwd(B: int, S: int, H: int, G: int, N: int, P: int, Q: int,
              itemsize: int) -> Cost:
    """K7: C B^T once per (b, chunk, group), 2 Q^2 N flops, and 2 Q^2 P +
    4 Q N P a (b h, chunk); x, dt, A, Bm, Cm read, y and the fp32 final
    state written."""
    nc = -(-S // Q)
    flops = (2 * Q * Q * N * G + (2 * Q * Q * P + 4 * Q * N * P) * H) \
        * B * nc
    nbytes = (2 * B * S * H * P * itemsize + B * S * H * 4 + B * H * 4
              + 2 * B * S * G * N * itemsize + B * H * N * P * 4)
    return flops, nbytes


def mamba_bwd(B: int, S: int, H: int, G: int, N: int, P: int, Q: int,
              itemsize: int) -> Cost:
    """K7's backward: 2 Q^2 (2 N + 2 P) + 8 Q N P a (b h, chunk) and 2 Q^2
    N a (b, group, chunk); x, dy, dx and Bm, Cm, dB, dC in the operands'
    type, dt, A and their gradients and the states in fp32."""
    nc = -(-S // Q)
    flops = (2 * Q * Q * (2 * N + 2 * P) + 8 * Q * N * P) * B * H * nc \
        + 2 * Q * Q * N * B * G * nc
    nbytes = (3 * B * S * H * P + 4 * B * S * G * N) * itemsize \
        + 4 * (2 * B * S * H + 2 * B * H + 3 * B * H * N * P)
    return flops, nbytes


def rwkv_fwd(B: int, S: int, H: int, N: int, itemsize: int) -> Cost:
    """K8: 4 N^2 flops a (b h, t); r, k, v, w read, y written, u and the
    fp32 states once."""
    return (4.0 * N * N * B * H * S,
            5 * B * S * H * N * itemsize + B * H * N * 4
            + 2 * B * H * N * N * 4)


def rwkv_bwd_flops(B: int, S: int, H: int, N: int, L: int = 16) -> int:
    """K8's backward counted from the chunked form that the reference
    differentiates (``models/ssm.py``: ``_rwkv6_chunked``), at chunks of
    ``L`` steps (the kernel's ``SAVE_EVERY``) entered from the states the
    forward saves.  A chunk of n steps a (b, h): 8 n N^2 flops of products
    with an N x N matrix (S0 dy_t, G v_j, G^T (k_j E_j) and the chunk's
    r-dy^T part of the state gradient), 15 N a pair of its steps (their
    decays 2, v_j . dy_t 2, s 3, the pair's parts of dr and dk 3 each and
    of dv 2) and 3 N^2 (the state gradient's decay and the row sums of G .
    S0 for dw); terms of O(n N) are left out.
    tests/test_torch_scan_bwd.py replays this form against the reference's
    gradient, counting the same."""
    per = lambda n: 8 * n * N * N + 15 * n * (n - 1) // 2 * N + 3 * N * N  # noqa
    full, last = divmod(S, L)
    return B * H * (full * per(L) + (per(last) if last else 0))


def rwkv_bwd(B: int, S: int, H: int, N: int, L: int = 16) -> Cost:
    """K8's backward (fp32): ``rwkv_bwd_flops``; r, k, v, w, dy read, their
    gradients written, the saved states read and u, du, the state
    gradients once."""
    nbytes = 4 * (9 * B * S * H * N + 2 * B * H * N + 3 * B * H * N * N)
    return rwkv_bwd_flops(B, S, H, N, L), nbytes
