"""The arithmetic the K5-K8 wrappers do around their kernels so that every
shape the JAX kernels take runs on the card: K5's choice of instance, K6's
covering pair and padding with the caller's scale, K7's chunk, K8's padded
state size.  A run on the card shows only that the kernel agrees with the
plain version; these show, on the CPU, that the padding and the chunking
themselves change nothing: the plain version on the padded inputs (or at
the kernel's chunk), sliced back, equals the plain version as the caller
called it, and the JAX kernel.  Meta tensors take the wrappers' card path
without a card."""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import (assert_close, assert_close_beside_the_reference,  # noqa: E402,F401,E501
                         mamba2_scan_ref64,
                         one_thread, to_np)

from repro.kernels.mamba2_scan.ops import mamba2_scan as j_mamba  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as da  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_scan as ms  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rs  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16


# ------------------------------------------------------------ K5 instances
@pytest.mark.parametrize("d,dv,dtype,want", [
    (128, 128, F32, ("workers", 128, 128)),       # the first instances
    (16, 16, F32, ("workers", 16, 16)),
    (96, 96, F32, ("lanes", 576, 512)),
    (64, 32, F32, ("lanes", 576, 512)),
    (256, 256, F32, ("lanes", 576, 512)),
    (576, 512, F32, ("lanes", 576, 512)),
    (128, 128, BF16, ("tensor_cores", 128, 128)),
    (96, 96, BF16, ("tensor_cores", 128, 128)),
    (64, 32, BF16, ("tensor_cores", 64, 64)),
    (8, 8, BF16, ("tensor_cores", 16, 16)),
    (256, 256, BF16, ("tensor_cores", 256, 256)),  # gemma-7b
    (200, 64, BF16, ("tensor_cores", 256, 256)),
    (576, 512, BF16, ("tensor_cores", 576, 512)),  # deepseek-v2's latent
    (264, 256, BF16, ("tensor_cores", 576, 512)),
    (100, 60, BF16, ("lanes", 576, 512)),         # rows of 200 bytes
    (1, 1, BF16, ("lanes", 576, 512)),
    (300, 100, F32, ("lanes", 576, 512)),
])
def test_decode_instance_covers_the_widths(d, dv, dtype, want):
    """``instance``: float32 at the square head dims keeps its instance;
    bf16 rows of whole 16-byte chunks go to the tensor cores, every other
    width to the CUDA-core lanes; the instance always holds (d, dv)."""
    route, DK, DV = da.instance(d, dv, dtype)
    assert (route, DK, DV) == want
    assert d <= DK and dv <= DV
    if route == "tensor_cores":
        assert d % 8 == 0 and dv % 8 == 0


@pytest.mark.parametrize("d,dv", [(577, 512), (576, 513), (0, 16),
                                  (1024, 64)])
def test_decode_instance_refuses_past_its_limit(d, dv):
    for dtype in (F32, BF16):
        with pytest.raises(ValueError, match="576"):
            da.instance(d, dv, dtype)


def _decode_case(B, H, d, dv, page, P, seed=0):
    rng = np.random.RandomState(seed)
    slots = B * P + 2
    q = torch.from_numpy(rng.randn(B, H, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(slots, page, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(slots, page, dv).astype(np.float32))
    pt = torch.from_numpy(rng.permutation(slots)[:B * P].reshape(B, P)
                          .astype(np.int32))
    lens = torch.from_numpy(rng.randint(0, P * page + 1, B).astype(np.int32))
    return q, kp, vp, pt, lens


@pytest.mark.parametrize("d,dv", [(96, 96), (40, 24), (200, 64)])
def test_decode_padded_q_with_the_callers_scale_is_the_callers_attention(
        d, dv):
    """The tensor-core route zero-pads q (never the pool) to the
    instance's DK and scores with 1/sqrt(d): the plain version on q and
    the pool's keys padded alike, with that scale, equals the caller's."""
    q, kp, vp, pt, lens = _decode_case(3, 4, d, dv, 8, 3)
    _, DK, _ = da.instance(d, dv, BF16)
    want = da.paged_decode_plain(q, kp, vp, pt, lens)
    pad = torch.nn.functional.pad
    got = da.paged_decode_plain(pad(q, (0, DK - d)), pad(kp, (0, DK - d)),
                                vp, pt, lens)   # scaled by 1/sqrt(DK)
    assert not torch.allclose(got, want, atol=1e-3)
    qs = pad(q, (0, DK - d)) * math.sqrt(DK / d)   # 1/sqrt(d) in effect
    got = da.paged_decode_plain(qs, pad(kp, (0, DK - d)), vp, pt, lens)
    assert_close(got.numpy(), want.numpy())


# ------------------------------------------------------ K6 covering pairs
@pytest.mark.parametrize("d,dv,want", [
    (80, 80, (80, 80)), (192, 128, (192, 128)), (24, 16, (24, 16)),
    (96, 96, (128, 128)), (48, 40, (64, 64)), (100, 60, (128, 128)),
    (40, 40, (64, 64)), (24, 24, (32, 32)), (20, 16, (24, 16)),
    (1, 1, (8, 8)), (160, 128, (192, 128)), (200, 100, (256, 256)),
    (256, 1, (256, 256))])
def test_flash_cover_pair_is_the_least_padded_instance(d, dv, want):
    pair = fa.cover_pair(d, dv)
    assert pair == want and pair in fa.PAIRS
    fits = [p for p in fa.PAIRS if p[0] >= d and p[1] >= dv]
    assert sum(pair) == min(map(sum, fits))


@pytest.mark.parametrize("d,dv", [(257, 64), (64, 257), (0, 8)])
def test_flash_cover_pair_refuses_past_256(d, dv):
    with pytest.raises(ValueError, match="256"):
        fa.cover_pair(d, dv)


def _flash_inputs(B, S, T, H, KV, d, dv, seed=0, dtype=F32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for shape in ((B, S, H, d), (B, T, KV, d), (B, T, KV, dv))]


@pytest.mark.parametrize("d,dv", [(96, 96), (48, 40), (100, 60), (40, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_pair_equals_the_callers_attention(d, dv, causal):
    """What the wrapper runs on the card at an uninstantiated pair, in
    plain PyTorch: q, k, v zero-padded to the covering pair, scores scaled
    by 1/sqrt(d) of the caller's d, the output sliced to dv.  Equal to the
    plain version on the caller's tensors; with the padded width's scale
    it would not be."""
    q, k, v = _flash_inputs(2, 24, 24, 4, 2, d, dv)
    pair = fa.cover_pair(d, dv)
    qp, kp, vp = fa.pad_to_pair(q, k, v, pair)
    assert qp.shape[-1] == kp.shape[-1] == pair[0] and vp.shape[-1] == pair[1]
    want = fa.flash_attention_plain(q, k, v, causal)
    got = fa.flash_attention_plain(qp, kp, vp, causal,
                                   scale=1 / math.sqrt(d))[..., :dv]
    assert_close(got.numpy(), want.numpy())
    wrong = fa.flash_attention_plain(qp, kp, vp, causal)[..., :dv]
    assert not torch.allclose(wrong, want, atol=1e-3)


@pytest.mark.parametrize("d,dv", [(96, 96), (48, 40)])
def test_flash_gradient_through_the_padding_is_the_callers(d, dv):
    """The padding and the slice sit outside ``FlashAttention``: autograd
    through them and the padded pair's attention (the plain version here,
    the pair's backward kernel on the card) gives the caller's gradient;
    the padded columns' gradients are dropped by the slice."""
    q, k, v = _flash_inputs(1, 20, 28, 4, 2, d, dv, seed=3)
    dout = torch.from_numpy(np.random.RandomState(4).randn(1, 20, 4, dv)
                            .astype(np.float32))
    want = fa.flash_attention_backward_plain(q, k, v, dout, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_plain(
        *fa.pad_to_pair(*leaves, fa.cover_pair(d, dv)), False,
        scale=1 / math.sqrt(d))[..., :dv]
    got = torch.autograd.grad(out, leaves, dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a.numpy(), b.numpy())


def test_flash_card_path_pads_books_and_slices_on_meta_tensors():
    """Meta tensors take the wrapper's card path: (96, 96) books the
    (128, 128) instance's cost and returns the caller's width."""
    q, k, v = (torch.empty((2, 64, 4, 96), device="meta") for _ in range(3))
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        out = fa.flash_attention_kernel(q, k, v, True)
    assert out.shape == (2, 64, 4, 96) and out.device.type == "meta"
    want = costs.flash_fwd(2, 64, 64, 4, 4, 128, 128, True, 4)
    assert booked == [("flash_attention", *want)]


# ---------------------------------------------------------- K7 the chunk
@pytest.mark.parametrize("Q,N,dtype,want", [
    (128, 64, BF16, 128), (31, 64, F32, 31), (256, 128, BF16, 128),
    (256, 128, F32, 64), (100, 100, F32, 64), (100, 64, F32, 100),
    (200, 16, F32, 128), (64, 128, F32, 64), (1000, 8, BF16, 128)])
def test_mamba_kernel_chunk(Q, N, dtype, want):
    """The chunk the kernel runs: the caller's up to the cap, 128 (64 in
    fp32 past N 64, where chunk 128's shared memory would pass the
    card's); never past the caller's."""
    assert ms.kernel_chunk(Q, N, dtype) == want
    assert ms.kernel_chunk(Q, N, dtype) <= ms.chunk_cap(N, dtype)


def _mamba_model_inputs(B, S, H, G, N, P, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(rng.randn(B * H) * 0.5)).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    Cm = rng.randn(B, S, G, N).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S,N,Q,dtype", [(384, 128, 256, "float32"),
                                         (384, 128, 256, "bfloat16"),
                                         (300, 100, 200, "float32"),
                                         (256, 16, 256, "float32")])
def test_mamba_sub_chunked_plain_equals_the_jax_kernel_at_the_callers_chunk(
        S, N, Q, dtype):
    """K7 at a chunk past 128 runs as chunks of ``kernel_chunk``: the plain
    version at that chunk (the kernel's arithmetic) against the Pallas
    kernel at the caller's chunk (S padded with zeros to a multiple of it,
    which the kernel needs and which adds nothing), within the reference's
    tolerances in bf16; in fp32 the Pallas kernel's own sums stray 2.1e-4
    to 4.2e-4 from the exact result (the reference's oracle in float64),
    past the tolerance, so there the port is held beside it
    (``assert_close_beside_the_reference``).  The final state, which the
    Pallas kernel drops, against the reference model's ``ssd_chunked`` at
    the caller's chunk, within the tolerances."""
    tdt = {"float32": F32, "bfloat16": BF16}[dtype]
    x, dt, A, Bm, Cm = _mamba_model_inputs(1, S, 3, 1, N, 16, seed=5)
    Qk = ms.kernel_chunk(Q, N, tdt)
    assert Qk < Q
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    args = [t.to(tdt) if i in (0, 3, 4) else t for i, t in enumerate(args)]
    y, state = ms.mamba2_scan_plain(*args, Qk)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pad = (-S) % Q
    jx, jB, jC = (np.pad(a[0].transpose(1, 0, 2), ((0, 0), (0, pad), (0, 0)))
                  for a in (x, Bm.repeat(3, axis=2), Cm.repeat(3, axis=2)))
    jdtv = np.pad(dt[0].T, ((0, 0), (0, pad)))
    ref = j_mamba(jnp.asarray(jx).astype(jdt), jnp.asarray(jdtv),
                  jnp.asarray(A), jnp.asarray(jB).astype(jdt),
                  jnp.asarray(jC).astype(jdt), chunk=Q)
    ref = np.asarray(ref, np.float32)[:, :S].transpose(1, 0, 2)[None]
    if dtype == "float32":
        exact = mamba2_scan_ref64(jx, jdtv, A, jB, jC)[0]
        exact = exact[:, :S].transpose(1, 0, 2)[None]
        assert_close_beside_the_reference(y.numpy(), ref, exact, dtype)
    else:
        assert_close(to_np(y), ref, dtype)
    grow = lambda a: np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))  # noqa: E731,E501
    x_, B_, C_ = (jnp.asarray(grow(to_np(args[i]))).astype(jdt)
                  for i in (0, 3, 4))
    _, ref_state = ssd_chunked(x_, jnp.asarray(grow(dt)), jnp.asarray(A),
                               B_, C_, Q)
    assert_close(state.float().numpy(), ref_state, dtype)


def test_mamba_card_path_at_n128_runs_the_kernels_chunk_on_meta_tensors():
    """Meta tensors take the wrapper's card path: N 128 at chunk 256 books
    the kernel's chunk, 128 in bf16, forward and, through ``Mamba2Scan``,
    backward (the backward takes N up to 128 since its chunk kernels walk
    the state in tiles of 64); past the forward's N the wrapper still
    refuses before anything is booked."""
    B, S, H, N, P = 1, 512, 4, 128, 64
    meta = dict(device="meta")
    x = torch.empty((B, S, H, P), dtype=BF16, **meta)
    dt = torch.empty((B, S, H), **meta)
    A = torch.empty((B * H,), **meta)
    bc = torch.empty((B, S, 1, N), dtype=BF16, **meta)
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        y, state = ms.mamba2_scan_kernel(x, dt, A, bc, bc, 256)
        assert y.shape == x.shape and state.shape == (B, H, N, P)
        assert booked == [("mamba2_scan",
                           *costs.mamba_fwd(B, S, H, 1, N, P, 128, 2))]
        xg = x.clone().requires_grad_()
        y, state = ms.mamba2_scan_kernel(xg, dt, A, bc, bc, 256)
        (dx,) = torch.autograd.grad(y, xg, torch.empty_like(y))
        assert dx.shape == x.shape and dx.device.type == "meta"
    assert booked[1:] == [
        ("mamba2_scan", *costs.mamba_fwd(B, S, H, 1, N, P, 128, 2)),
        ("mamba2_scan_bwd", *costs.mamba_bwd(B, S, H, 1, N, P, 128, 2))]
    with pytest.raises(ValueError, match="N <= 128"):
        ms.mamba2_scan_kernel(x.requires_grad_(), dt, A,
                              torch.empty((B, S, 1, 129), dtype=BF16, **meta),
                              torch.empty((B, S, 1, 129), dtype=BF16, **meta),
                              256)
    assert len(booked) == 3


# --------------------------------------------------- K8 padded state size
@pytest.mark.parametrize("N,want", [(1, 8), (8, 8), (12, 16), (24, 32),
                                    (33, 64), (48, 64), (64, 64)])
def test_rwkv_padded_n(N, want):
    assert rs.padded_n(N) == want


def test_rwkv_padded_n_refuses_past_64():
    with pytest.raises(ValueError, match="N <= 64"):
        rs.padded_n(65)


def _rwkv_model_inputs(B, S, H, N, seed=0):
    rng = np.random.RandomState(seed)
    r, v = (rng.randn(B, S, H, N).astype(np.float32) for _ in range(2))
    k = (rng.randn(B, S, H, N) * 0.3).astype(np.float32)
    w = (1 / (1 + np.exp(-rng.randn(B, S, H, N)))).astype(np.float32)
    u = (rng.randn(B * H, N) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, N, N) * 0.5).astype(np.float32)
    return [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("N", [12, 24, 48, 5])
def test_rwkv_padded_state_equals_the_callers_scan(N):
    """Zero k and v columns leave the padded state's extra rows and columns
    zero whatever w holds, and zero r adds nothing to y: the plain version
    on the padded inputs, sliced back, equals it on the caller's."""
    args = _rwkv_model_inputs(2, 40, 2, N, seed=N)
    n = rs.padded_n(N)
    padded = rs.pad_state_dim(*args, n)
    assert all(t.shape[-1] == n for t in padded)
    y, state = rs.rwkv6_scan_plain(*padded)
    want_y, want_state = rs.rwkv6_scan_plain(*args)
    assert_close(y[..., :N].numpy(), want_y.numpy())
    assert_close(state[..., :N, :N].numpy(), want_state.numpy())
    assert not y[..., N:].any() and not state[..., N:, :].any() \
        and not state[..., :, N:].any()


def test_rwkv_gradient_through_the_padding_is_the_callers():
    """The padding sits outside ``RWKV6Scan``: autograd through it and the
    padded scan gives the caller's gradient of every input."""
    args = _rwkv_model_inputs(1, 20, 2, 24, seed=9)
    dy = torch.from_numpy(np.random.RandomState(2).randn(1, 20, 2, 24)
                          .astype(np.float32))
    want = rs.rwkv6_scan_backward_plain(*args, dy)
    leaves = [t.clone().requires_grad_() for t in args]
    y, _ = rs.rwkv6_scan_plain(*rs.pad_state_dim(*leaves, 32))
    got = torch.autograd.grad(y[..., :24], leaves, dy)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a.numpy(), b.numpy())


def test_rwkv_card_path_pads_and_slices_on_meta_tensors():
    B, S, H, N = 2, 16, 3, 48
    r = torch.empty((B, S, H, N), device="meta")
    u = torch.empty((B * H, N), device="meta")
    booked = []
    with costs.listening(lambda name, fl, by: booked.append((name, fl, by))):
        y, state = rs.rwkv6_scan_kernel(r, r, r, r, u)
    assert y.shape == (B, S, H, N) and state.shape == (B, H, N, N)
    assert booked == [("rwkv6_scan", *costs.rwkv_fwd(B, S, H, 64, 4))]
