"""The gradients of K7 (the Mamba2 SSD scan) and K8 (the RWKV6 scan) on the
CPU.

The reference has no Pallas backward: it differentiates its pure-jnp
``ssd_chunked`` and ``_rwkv6_chunked`` (``repro/models/ssm.py``) and the
kernels' sequential oracles (``ref.py``).  Here the port's plain
backwards (autograd through the plain versions) are held against
``jax.vjp`` of all four on seeded numpy inputs, from a nonzero initial
state and with a nonzero gradient of the final state; the
``autograd.Function``s that route a gradient on the card equal the plain
backward on CPU tensors and count no launch; and the backward kernels'
plans (``csrc/mamba2_scan_bwd.cu``, ``csrc/rwkv6_scan_bwd.cu``) are
replayed in numpy in float64, kernel by kernel in their order, against
``jax.vjp``: K8's saved states every 16 steps, each stretch's own part of
the state gradient and its decay, the pass over the stretches, then
every stretch from its checkpoints, whole rows at once; K7's state
gradients at the chunk ends, each chunk's formulas with C B^T, dB and dC
a tile of heads, and the group sums in tile order.  Each replay with a
planted fault (K8's state gradient not decayed by w, or the pass without
the stretches' decay; K7's state gradients dropped between chunks, or dB
and dC of one tile of heads) must fail, and K7's bf16 roundings (hi +
lo halves of what it computes) replayed in torch must hold the gate
where one rounding of M and LG reads worse.  The chunked form that K8's
operations bound counts (``chip_smoke.rwkv_bwd_flops``) is replayed too,
with its count, against ``jax.vjp``."""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401

from repro.kernels.mamba2_scan.ref import mamba2_scan_ref  # noqa: E402
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_scan as ms  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rs  # noqa: E402

TOL = 2e-5
SM_SMEM = 233_472                    # shared memory of an SM (228 KB)


def assert_grads(port, ref, tol=TOL):
    """Each gradient within ``tol`` of the reference's, relative to its
    largest magnitude (at least 1)."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a = a.detach().double().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= tol * scale, \
            (np.abs(a - b).max(), scale)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------- inputs
def mamba_case(B, S, H, G, N, P, seed=0):
    """x, dt (softplus), A (-exp) per head, Bm, Cm, init and the two
    cotangents, as tests/test_kernels.py draws the scan's inputs."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)
    A = (-np.exp(0.5 * f(H))).astype(np.float32)
    Bm, Cm = f(B, S, G, N), f(B, S, G, N)
    init = 0.3 * f(B, H, N, P)
    dy, dstate = f(B, S, H, P), 0.3 * f(B, H, N, P)
    return x, dt, A, Bm, Cm, init, dy, dstate


def rwkv_case(B, S, H, N, seed=0):
    """r, k (x 0.3), v, w (sigmoid), u (x 0.1) per head, init and the two
    cotangents."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(B, S, H, N), 0.3 * f(B, S, H, N), f(B, S, H, N)
    w = (1 / (1 + np.exp(-f(B, S, H, N)))).astype(np.float32)
    u = 0.1 * f(H, N)
    init = 0.1 * f(B, H, N, N)
    dy, dstate = f(B, S, H, N), 0.3 * f(B, H, N, N)
    return r, k, v, w, u, init, dy, dstate


def per_row(a, B):
    """A per-head [H, ...] array as the wrappers' per (batch row, head)
    [B * H, ...]."""
    return np.broadcast_to(a, (B,) + a.shape).reshape((-1,) + a.shape[1:])


def mamba_ref_vjp(x, dt, A, Bm, Cm, init, dy, dstate, Q):
    (y, st), vjp = jax.vjp(
        lambda *a: jssm.ssd_chunked(*a[:5], Q, a[5]),
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, init)))
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


def rwkv_ref_vjp(r, k, v, w, u, init, dy, dstate, Q):
    _, vjp = jax.vjp(lambda *a: jssm._rwkv6_chunked(*a, Q),
                     *(jnp.asarray(a) for a in (r, k, v, w, u, init)))
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


def mamba_port_plain(x, dt, A, Bm, Cm, init, dy, dstate, Q):
    """The port's plain backward with A per head: dA summed over the batch
    rows, as the model's expand of A sums it."""
    B = x.shape[0]
    g = ms.mamba2_scan_backward_plain(
        t(x), t(dt), t(per_row(A, B)), t(Bm), t(Cm), Q, t(init), t(dy),
        t(dstate))
    return (g[0], g[1], g[2].reshape(B, -1).sum(0), *g[3:])


def rwkv_port_plain(r, k, v, w, u, init, dy, dstate):
    B = r.shape[0]
    g = rs.rwkv6_scan_backward_plain(
        t(r), t(k), t(v), t(w), t(per_row(u, B)), t(init), t(dy), t(dstate))
    return (*g[:4], g[4].reshape(B, *u.shape).sum(0), g[5])


# -------------------------------------------- plain backward vs reference
@pytest.mark.parametrize("B,S,H,G,N,P,Q", [
    (2, 64, 4, 2, 8, 16, 16),        # four chunks, two groups of two heads
    (1, 96, 3, 1, 16, 8, 32),        # three chunks, one group
    (2, 32, 2, 2, 4, 4, 32),         # one chunk, a group a head
])
def test_mamba2_plain_backward_matches_ssd_chunked(B, S, H, G, N, P, Q):
    case = mamba_case(B, S, H, G, N, P, seed=S + Q)
    assert_grads(mamba_port_plain(*case, Q), mamba_ref_vjp(*case, Q))


@pytest.mark.parametrize("BH,S,N,P,Q", [(3, 64, 8, 16, 16),
                                        (2, 50, 16, 8, 16),
                                        (2, 37, 4, 4, 8)])
def test_mamba2_plain_backward_matches_the_oracle(BH, S, N, P, Q):
    """The Pallas layout (H = G = 1), zero initial state, the oracle's
    per-step recurrence; ragged last chunks included."""
    x, dt, A, Bm, Cm, _, dy, _ = mamba_case(BH, S, 1, 1, N, P, seed=BH * S)
    A = np.repeat(A, BH)
    _, vjp = jax.vjp(mamba2_scan_ref, *(jnp.asarray(a) for a in (
        x[:, :, 0], dt[:, :, 0], A, Bm[:, :, 0], Cm[:, :, 0])))
    ref = vjp(jnp.asarray(dy[:, :, 0]))
    g = ms.mamba2_scan_backward_plain(t(x), t(dt), t(A), t(Bm), t(Cm), Q,
                                      None, t(dy))
    assert_grads([g[0][:, :, 0], g[1][:, :, 0], g[2], g[3][:, :, 0],
                  g[4][:, :, 0]], ref)


@pytest.mark.parametrize("B,S,H,N,Q", [(2, 64, 2, 8, 16), (1, 96, 3, 16, 32),
                                       (2, 32, 1, 32, 8)])
def test_rwkv6_plain_backward_matches_rwkv6_chunked(B, S, H, N, Q):
    case = rwkv_case(B, S, H, N, seed=S + N)
    assert_grads(rwkv_port_plain(*case), rwkv_ref_vjp(*case, Q))


@pytest.mark.parametrize("BH,S,N", [(3, 40, 8), (2, 17, 16)])
def test_rwkv6_plain_backward_matches_the_oracle(BH, S, N):
    r, k, v, w, u, _, dy, _ = rwkv_case(BH, S, 1, N, seed=S)
    u = np.repeat(u, BH, axis=0)
    _, vjp = jax.vjp(rwkv6_scan_ref, *(jnp.asarray(a[:, :, 0])
                                       for a in (r, k, v, w)),
                     jnp.asarray(u))
    ref = vjp(jnp.asarray(dy[:, :, 0]))
    g = rs.rwkv6_scan_backward_plain(t(r), t(k), t(v), t(w), t(u), None,
                                     t(dy))
    assert_grads([x[:, :, 0] for x in g[:4]] + [g[4]], ref)


# ------------------------------------------------ the Functions on the CPU
def test_mamba2_function_on_cpu_is_the_plain_backward():
    x, dt, A, Bm, Cm, init, dy, dstate = mamba_case(2, 40, 4, 2, 6, 8)
    A = per_row(A, 2)
    ms.LAUNCHES = ms.BWD_LAUNCHES = 0
    leaves = [t(a).requires_grad_() for a in (x, dt, A, Bm, Cm, init)]
    y, st = ms.Mamba2Scan.apply(*leaves[:5], 16, leaves[5])
    got = torch.autograd.grad([y, st], leaves, [t(dy), t(dstate)])
    plain = ms.mamba2_scan_backward_plain(*(t(a) for a in (
        x, dt, A, Bm, Cm)), 16, t(init), t(dy), t(dstate))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    py, pst = ms.mamba2_scan_plain(*(t(a) for a in (x, dt, A, Bm, Cm)), 16,
                                   t(init))
    assert torch.equal(y, py) and torch.equal(st, pst)
    # the wrapper on CPU tensors is the plain version, under autograd too
    leaves2 = [t(a).requires_grad_() for a in (x, dt, A, Bm, Cm, init)]
    y2, st2 = ms.mamba2_scan_kernel(*leaves2[:5], 16, leaves2[5])
    for a, b in zip(torch.autograd.grad([y2, st2], leaves2,
                                        [t(dy), t(dstate)]), plain):
        assert torch.equal(a, b)
    assert ms.LAUNCHES == 0 and ms.BWD_LAUNCHES == 0


def test_rwkv6_function_on_cpu_is_the_plain_backward():
    r, k, v, w, u, init, dy, dstate = rwkv_case(2, 37, 3, 8)
    u = per_row(u, 2)
    rs.LAUNCHES = rs.BWD_LAUNCHES = 0
    leaves = [t(a).requires_grad_() for a in (r, k, v, w, u, init)]
    y, st = rs.RWKV6Scan.apply(*leaves)
    got = torch.autograd.grad([y, st], leaves, [t(dy), t(dstate)])
    plain = rs.rwkv6_scan_backward_plain(*(t(a) for a in (
        r, k, v, w, u, init, dy, dstate)))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    leaves2 = [t(a).requires_grad_() for a in (r, k, v, w, u, init)]
    y2, st2 = rs.rwkv6_scan_kernel(*leaves2)
    for a, b in zip(torch.autograd.grad([y2, st2], leaves2,
                                        [t(dy), t(dstate)]), plain):
        assert torch.equal(a, b)
    assert rs.LAUNCHES == 0 and rs.BWD_LAUNCHES == 0


def test_functions_without_an_initial_state_return_no_init_gradient():
    x, dt, A, Bm, Cm, _, dy, _ = mamba_case(1, 32, 2, 1, 4, 4)
    leaves = [t(a).requires_grad_() for a in (x, dt, per_row(A, 1), Bm, Cm)]
    y, _ = ms.Mamba2Scan.apply(*leaves, 16, None)
    assert all(g is not None for g in torch.autograd.grad(y, leaves, t(dy)))
    r, k, v, w, u, _, dy, _ = rwkv_case(1, 20, 2, 8)
    leaves = [t(a).requires_grad_() for a in (r, k, v, w, per_row(u, 1))]
    y, _ = rs.RWKV6Scan.apply(*leaves, None)
    assert all(g is not None for g in torch.autograd.grad(y, leaves, t(dy)))


# ------------------------------------------- K8's backward plan, replayed
def rwkv_bwd_replay(r, k, v, w, u, init, dy, dstate, decay=True,
                    stretch_decay=True):
    """csrc/rwkv6_scan_bwd.cu's plan in float64, u per (b, h): the
    forward's saved states every ``SAVE_EVERY`` steps; (1) each stretch's
    own part of the gradient of the state entering it, G_loc (the running
    products of w formed forward), and its decay D; (2) the pass from the
    last stretch, G_start = D G_end + G_loc; (3) every stretch from its
    saved state and its G_end: the state recomputed forward with a
    checkpoint every ``BWD_SUB`` steps (dr, du's part), then each group
    of ``BWD_SUB`` steps recomputed from its checkpoint and walked back
    (dw, dk, dv), whole rows at once; (4) du's parts summed in order.
    The planted faults: with ``decay`` False G is not decayed by w within
    a stretch, with ``stretch_decay`` False the pass leaves out D.
    Returns the gradients and the scratch's arrays."""
    r, k, v, w, u, init, dy, dstate = (np.asarray(a, np.float64) for a in (
        r, k, v, w, u, init, dy, dstate))
    B, S, H, N = r.shape
    u = u.reshape(B, H, N)
    L, K = rs.SAVE_EVERY, rs.BWD_SUB
    ns = rs.saved_states(S)
    states = np.zeros((B, ns, H, N, N))
    P = init.copy()
    for t in range(S):
        if t % L == 0:
            states[:, t // L] = P
        P = w[:, t, :, :, None] * P + k[:, t, :, :, None] * v[:, t, :, None]
    gs = np.zeros((B, ns, H, N, N))
    dec, du_part = np.zeros((B, ns, H, N)), np.zeros((B, ns, H, N))
    for sv in range(ns):                 # (1)
        cw = np.ones((B, H, N))
        for t in range(sv * L, min(S, sv * L + L)):
            gs[:, sv] += (r[:, t] * cw)[..., None] * dy[:, t, :, None]
            cw = cw * w[:, t]
        dec[:, sv] = cw
    G = dstate.copy()                    # (2)
    for sv in reversed(range(ns)):
        loc = gs[:, sv].copy()
        gs[:, sv] = G
        G = (dec[:, sv][..., None] if stretch_decay else 1.0) * G + loc
    dinit = G
    vd = (v * dy).sum(-1)                                   # [B, S, H]
    bonus = (r * u[:, None] * k).sum(-1)
    dr, dk, dv, dw = (np.zeros_like(r) for _ in range(4))
    for sv in range(ns):                 # (3), each stretch on its own
        t0, t1 = sv * L, min(S, sv * L + L)
        P, ck = states[:, sv].copy(), []
        for t in range(t0, t1):
            if (t - t0) % K == 0:
                ck.append(P)
            dr[:, t] = (P * dy[:, t, :, None]).sum(-1) \
                + u * k[:, t] * vd[:, t, :, None]
            du_part[:, sv] += r[:, t] * k[:, t] * vd[:, t, :, None]
            P = w[:, t, :, :, None] * P \
                + k[:, t, :, :, None] * v[:, t, :, None]
        G = gs[:, sv].copy()
        for sb in reversed(range(len(ck))):
            hist = [ck[sb]]
            for t in range(t0 + sb * K, min(t1, t0 + sb * K + K) - 1):
                hist.append(w[:, t, :, :, None] * hist[-1]
                            + k[:, t, :, :, None] * v[:, t, :, None])
            for q in reversed(range(len(hist))):
                t = t0 + sb * K + q
                dw[:, t] = (G * hist[q]).sum(-1)
                dk[:, t] = (G * v[:, t, :, None]).sum(-1) \
                    + u * r[:, t] * vd[:, t, :, None]
                dv[:, t] = (G * k[:, t, :, :, None]).sum(-2) \
                    + bonus[:, t, :, None] * dy[:, t]
                G = (w[:, t, :, :, None] if decay else 1.0) * G \
                    + r[:, t, :, :, None] * dy[:, t, :, None]
    grads = (dr, dk, dv, dw, du_part.sum(1).reshape(B * H, N), dinit)
    return grads, dict(states=states, gs=gs, dec=dec, du=du_part)


def rwkv_replay_per_head(case, **kw):
    r, k, v, w, u, init, dy, dstate = case
    B, _, H, N = r.shape
    g, scratch = rwkv_bwd_replay(r, k, v, w, per_row(u, B), init, dy,
                                 dstate, **kw)
    return g[:4] + (g[4].reshape(B, H, N).sum(0), g[5]), scratch


@pytest.mark.parametrize("B,S,H,N,Q", [
    (2, 48, 2, 8, 16),               # three whole stretches
    (1, 40, 3, 16, 8),               # a last stretch of 8 steps
    (2, 24, 1, 32, 8),               # a last stretch of 8: two checkpoints
    (1, 16, 1, 64, 16),              # one stretch
    (1, 33, 2, 16, 11),              # a last stretch of 1: a group of one
])
def test_rwkv6_backward_plan_replays_the_reference_gradient(B, S, H, N, Q):
    case = rwkv_case(B, S, H, N, seed=N + S)
    grads, scratch = rwkv_replay_per_head(case)
    assert_grads(grads, rwkv_ref_vjp(*case, Q))
    want = rs.bwd_scratch_bytes(B, S, H, N)
    assert {k: a.size * 4 for k, a in scratch.items()} == want


def test_rwkv6_backward_replay_without_the_decay_is_rejected():
    case = rwkv_case(2, 48, 2, 16, seed=3)
    grads, _ = rwkv_replay_per_head(case, decay=False)
    with pytest.raises(AssertionError):
        assert_grads(grads, rwkv_ref_vjp(*case, 16), 2e-2)


def test_rwkv6_backward_replay_without_the_stretch_decay_is_rejected():
    """The pass over the stretches without their decay D, G_start = G_end
    + G_loc: the gate must fail it."""
    case = rwkv_case(2, 48, 2, 16, seed=3)
    grads, _ = rwkv_replay_per_head(case, stretch_decay=False)
    with pytest.raises(AssertionError):
        assert_grads(grads, rwkv_ref_vjp(*case, 16), 2e-2)


def rwkv_chunked_bwd(r, k, v, w, u, init, dy, dstate, L):
    """The gradient of the RWKV6 recurrence in the chunked form that the
    reference differentiates (``_rwkv6_chunked``), in float64: chunks of
    ``L`` steps entered from the forward's states, from the last chunk,
    with its products and pairs counted as ``chip_smoke.rwkv_bwd_flops``
    counts them (terms of O(L N) left out).  dw is dlog w / w, as the
    reference's log w gives it.  Returns (dr, dk, dv, dw, du summed over
    the batch rows, dinit) and the count."""
    r, k, v, w, dy = (np.moveaxis(np.asarray(a, np.float64), 1, 2)
                      for a in (r, k, v, w, dy))            # [B, H, S, N]
    u = np.asarray(u, np.float64)[None, :, None]             # [1, H, 1, N]
    B, H, S, N = r.shape
    starts = list(range(0, S, L))
    states, P = [], np.asarray(init, np.float64)
    for t0 in starts:                    # the forward's saved states
        states.append(P)
        for t in range(t0, min(t0 + L, S)):
            P = w[:, :, t, :, None] * P \
                + k[:, :, t, :, None] * v[:, :, t, None]
    dr, dk, dv, dlw = (np.zeros_like(r) for _ in range(4))
    vd = (v * dy).sum(-1, keepdims=True)                     # v_t . dy_t
    du = (r * k * vd).sum((0, 2))
    G, flops = np.asarray(dstate, np.float64), 0
    for c in reversed(range(len(starts))):
        sl = slice(starts[c], min(starts[c] + L, S))
        n = sl.stop - sl.start
        rc, kc, vc, dyc, S0 = r[:, :, sl], k[:, :, sl], v[:, :, sl], \
            dy[:, :, sl], states[c]
        lw = np.log(w[:, :, sl])
        cl = np.cumsum(lw, 2)                                # inclusive
        cp = cl - lw                                         # exclusive
        ce = cl[:, :, -1:]
        # the four products with an N x N matrix, 2 N^2 a step each
        a = np.einsum("bhij,bhtj->bhti", S0, dyc)            # S0 dy_t
        bv = np.einsum("bhim,bhtm->bhti", G, vc)             # G v_j
        kh = kc * np.exp(ce - cl)                            # k_j E_j
        dv_s = np.einsum("bhim,bhti->bhtm", G, kh)           # G^T k_j E_j
        G_own = np.einsum("bhti,bhtj->bhij", rc * np.exp(cp), dyc)
        # the pairs t > j: decays, v_j . dy_t, s, and their parts
        tri = np.tril(np.ones((n, n), bool), -1)[None, None, :, :, None]
        D = np.where(tri, np.exp(cp[:, :, :, None] - cl[:, :, None]), 0.0)
        A_ = np.einsum("bhjm,bhtm->bhtj", vc, dyc)
        s = np.einsum("bhtn,bhjn,bhtjn->bhtj", rc, kc, D)
        dr_p = np.einsum("bhtj,bhjn,bhtjn->bhtn", A_, kc, D)
        dk_p = np.einsum("bhtj,bhtn,bhtjn->bhjn", A_, rc, D)
        dr[:, :, sl] = np.exp(cp) * a + dr_p + u * kc * vd[:, :, sl]
        dk[:, :, sl] = np.exp(ce - cl) * bv + dk_p + u * rc * vd[:, :, sl]
        dv[:, :, sl] = dv_s + np.einsum("bhtj,bhtm->bhjm", s, dyc) \
            + (rc * u * kc).sum(-1, keepdims=True) * dyc
        # the gradients of the exclusive and inclusive sums of log w, then
        # of log w itself
        dcp = rc * np.exp(cp) * a + rc * dr_p
        dcl = -kc * dk_p - kh * bv
        dce = (kh * bv).sum(2) + np.exp(ce[:, :, 0]) * (G * S0).sum(-1)
        rev = lambda x: np.cumsum(x[:, :, ::-1], 2)[:, :, ::-1]  # noqa
        dlw[:, :, sl] = rev(dcl) + rev(dcp) - dcp + dce[:, :, None]
        G = np.exp(ce[:, :, 0])[..., None] * G + G_own
        flops += B * H * (8 * n * N * N + 15 * n * (n - 1) // 2 * N
                          + 3 * N * N)
    back = lambda x: np.moveaxis(x, 2, 1)  # noqa: E731
    return (back(dr), back(dk), back(dv), back(dlw / w), du, G), flops


@pytest.mark.parametrize("B,S,H,N,L,Q", [
    (2, 48, 2, 16, 16, 16),          # three whole chunks
    (1, 40, 3, 8, 16, 8),            # a last chunk of 8 steps
])
def test_rwkv6_backward_bound_counts_a_form_that_gives_the_gradient(
        B, S, H, N, L, Q):
    """K8's operations bound (``chip_smoke.rwkv_bwd_flops``) counts the
    chunked form of the gradient: that form, replayed with the same
    count, gives the reference's gradient.  At rwkv6-3b's training shape
    it needs fewer operations than the 14 a state element a step of the
    step-by-step recurrence, so the bytes bound the time."""
    import chip_smoke as c
    case = rwkv_case(B, S, H, N, seed=5 * N + S)
    grads, flops = rwkv_chunked_bwd(*case, L)
    assert_grads(grads, rwkv_ref_vjp(*case, Q))
    assert flops == c.rwkv_bwd_flops(B, S, H, N, L)
    B, S, H, N = c.SCAN_BWD_TIMED["rwkv6-3b train"]
    nbytes = 4 * (9 * B * S * H * N + 2 * B * H * N + 3 * B * H * N * N)
    assert c.rwkv_bwd_flops(B, S, H, N) < 14 * N * N * B * H * S
    assert c.bound(nbytes, ops=c.rwkv_bwd_flops(B, S, H, N))[1] == "bytes"


# ------------------------------------------- K7's backward plan, replayed
def bf16_hi_lo(a):
    """a as the sum of its bf16 rounding and the bf16 rounding of the
    remainder, the two halves the kernel multiplies."""
    hi = torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double()
    lo = (torch.from_numpy(np.asarray(a, np.float64)) - hi).float() \
        .bfloat16().double()
    return (hi + lo).numpy()


def bf16_once(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double() \
        .numpy()


def mamba_bwd_replay(x, dt, A, Bm, Cm, Q, init, dy, dstate, heads=1,
                     state_pass=True, one_tile=False, round_ops=None,
                     round_ml=None, out_type=None):
    """csrc/mamba2_scan_bwd.cu's bf16 plan in float64, A per (b, h): the
    forward's state entering each chunk; (a) each chunk's own part of the
    state gradient; (b) the walk from the last chunk; (c1) for each tile
    of ``heads`` heads of a group, dC summed over the tile's heads (the
    state part exp(cum) g s_prev^T and LG B) and, a head, W's row sums
    plus the inter term (rsi, over the chunk padded to 16); (c2) dx, W's
    column sums, V, x . d dtx and dB summed over the tile's heads, then
    dcum, da, ddt and dA's part a head; (d) dB and dC as the sums of each
    group's tiles in order, dA over the chunks.  ``round_ops`` (the
    operands the kernel splits into bf16 hi and lo: C exp(cum) in (a), dS,
    s_prev) and ``round_ml`` (M and LG) round what they are given, and
    ``out_type`` the outputs in x's type.  The planted faults: with
    ``state_pass`` False the state gradients between chunks are dropped,
    with ``one_tile`` (d) takes a group's first tile only.  Returns the
    gradients and the scratch's arrays."""
    ident = lambda a: a  # noqa: E731
    rop, rml = round_ops or ident, round_ml or ident
    out = out_type or ident
    x, dt, A, Bm, Cm, init, dy, dstate = (np.asarray(a, np.float64) for a in (
        x, dt, A, Bm, Cm, init, dy, dstate))
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    rep, nc = H // G, -(-S // Q)
    tiles = -(-rep // heads)
    pad = nc * Q - S
    zp = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((B, pad) + a.shape[2:])], 1)
    x_, dt_, B_, C_, g_ = (zp(a) for a in (x, dt, Bm, Cm, dy))
    A = A.reshape(B, H)
    group = np.arange(H) // rep
    tile = (np.arange(H) % rep) // heads
    dx, ddt = np.zeros_like(x_), np.zeros_like(dt_)
    dB_part, dC_part = (np.zeros((B, nc * Q, G * tiles, N)) for _ in range(2))
    dA_part = np.zeros((B, nc, H))
    s_prev, ds_loc, ds = (np.zeros((B, nc, H, N, P)) for _ in range(3))
    dec = np.zeros((B, nc, H))
    rsi = np.zeros((B, nc, H, ms.pad16(Q)))
    tri = np.tril(np.ones((Q, Q), bool))

    def chunk(c):
        sl = slice(c * Q, (c + 1) * Q)
        cum = np.cumsum(dt_[:, sl] * A[:, None], 1)         # [B, Q, H]
        Bh, Ch = B_[:, sl][:, :, group], C_[:, sl][:, :, group]
        return sl, cum, Bh, Ch

    def to_tiles(a):
        """[B, Q, H, N] per head -> [B, Q, G tiles, N], each tile's heads
        summed in order"""
        t = np.zeros(a.shape[:2] + (G * tiles, N))
        for h in range(H):
            t[:, :, group[h] * tiles + tile[h]] += a[:, :, h]
        return t

    s = init.copy()
    for c in range(nc):                  # the forward's states
        sl, cum, Bh, Ch = chunk(c)
        s_prev[:, c] = rop(s)
        E = np.exp(cum[:, -1:] - cum)
        s = np.exp(cum[:, -1])[..., None, None] * s + np.einsum(
            "bjh,bjhn,bjhp->bhnp", E * dt_[:, sl], Bh, x_[:, sl])
    for c in range(nc):                  # (a)
        sl, cum, Bh, Ch = chunk(c)
        ds_loc[:, c] = np.einsum("bihn,bihp->bhnp",
                                 rop(np.exp(cum)[..., None] * Ch), g_[:, sl])
        dec[:, c] = np.exp(cum[:, -1])
    cur = dstate.copy()                  # (b)
    for c in reversed(range(nc)):
        ds[:, c] = rop(cur) if (state_pass or c == nc - 1) else 0.0
        cur = ds_loc[:, c] + dec[:, c][..., None, None] * cur
    dinit = cur
    for c in range(nc):
        sl, cum, Bh, Ch = chunk(c)
        g, x_c, dt_c = g_[:, sl], x_[:, sl], dt_[:, sl]
        dS, sp = ds[:, c], s_prev[:, c]
        L = np.where(tri[None, :, :, None],
                     np.exp(cum[:, :, None] - cum[:, None]), 0.0)  # [B,i,j,H]
        M = np.einsum("bihn,bjhn->bijh", Ch, Bh) * L
        GD = np.einsum("bihp,bjhp->bijh", g, x_c) * dt_c[:, None]
        W, LG = M * GD, L * GD
        E = np.exp(cum[:, -1:] - cum)                       # [B, Q, H]
        # (c1)
        sg = np.einsum("bihp,bhnp->bihn", g, sp)             # g s_prev^T
        dC_part[:, sl] = to_tiles(np.exp(cum)[..., None] * sg + np.einsum(
            "bijh,bjhn->bihn", rml(LG), Bh))
        rsi[:, c, :, :Q] = np.moveaxis(W.sum(2) + np.exp(cum)
                                       * (Ch * sg).sum(-1), 1, 2)
        # (c2)
        xs = np.einsum("bjhp,bhnp->bjhn", x_c, dS)           # x dS^T
        d_dtx = np.einsum("bijh,bihp->bjhp", rml(M), g) \
            + E[..., None] * np.einsum("bjhn,bhnp->bjhp", Bh, dS)
        dx[:, sl] = dt_c[..., None] * d_dtx
        dB_part[:, sl] = to_tiles(np.einsum("bijh,bihn->bjhn", rml(LG), Ch)
                                  + (E * dt_c)[..., None] * xs)
        V = E * dt_c * (Bh * xs).sum(-1)
        dcum = np.moveaxis(rsi[:, c, :, :Q], 2, 1) - W.sum(1) - V
        dcum[:, -1] += np.exp(cum[:, -1]) * (sp * dS).sum((-2, -1)) \
            + V.sum(1)
        da = np.cumsum(dcum[:, ::-1], 1)[:, ::-1]
        ddt[:, sl] = A[:, None] * da + (x_c * d_dtx).sum(-1)
        dA_part[:, c] = (dt_c * da).sum(1)
    take = 1 if one_tile else tiles      # (d)
    dB = dB_part.reshape(B, nc * Q, G, tiles, N)[:, :, :, :take].sum(3)
    dC = dC_part.reshape(B, nc * Q, G, tiles, N)[:, :, :, :take].sum(3)
    grads = (out(dx[:, :S]), ddt[:, :S], dA_part.sum(1).reshape(B * H),
             out(dB[:, :S]), out(dC[:, :S]), dinit)
    return grads, dict(s_prev=s_prev, ds=ds, dec=dec,
                       dBC_part=np.stack([dB_part[:, :S], dC_part[:, :S]]),
                       dA_part=dA_part, ds_loc=ds_loc, rsi=rsi)


def mamba_replay_per_head(case, Q, **kw):
    x, dt, A, Bm, Cm, init, dy, dstate = case
    B = x.shape[0]
    g, scratch = mamba_bwd_replay(x, dt, per_row(A, B), Bm, Cm, Q, init, dy,
                                  dstate, **kw)
    return (g[0], g[1], g[2].reshape(B, -1).sum(0), *g[3:]), scratch


@pytest.mark.parametrize("B,S,H,G,N,P,Q", [
    (2, 64, 4, 2, 8, 16, 16),        # a tile a group of two heads
    (1, 96, 6, 1, 16, 8, 32),        # three tiles of two heads
    (2, 32, 2, 2, 4, 4, 32),         # one chunk, a head a group
    (1, 64, 8, 2, 8, 8, 16),         # two groups of two tiles
])
def test_mamba2_backward_plan_replays_the_reference_gradient(B, S, H, G, N,
                                                             P, Q):
    heads = 2 if (H // G) % 2 == 0 else 1     # tiles of two where they fit
    case = mamba_case(B, S, H, G, N, P, seed=Q + heads)
    grads, scratch = mamba_replay_per_head(case, Q, heads=heads)
    assert_grads(grads, mamba_ref_vjp(*case, Q))
    want = ms.bwd_scratch_bytes(B, S, H, G, N, P, Q, torch.bfloat16, heads)
    assert {k: a.size * 4 for k, a in scratch.items()} == want


@pytest.mark.parametrize("S,Q", [(50, 16), (37, 8)])
def test_mamba2_backward_plan_with_a_ragged_last_chunk(S, Q):
    """A last chunk shorter than Q, zero-padded as the forward pads it:
    the replay against the port's plain backward (which pads the same
    way) and, from a zero state, against the oracle."""
    case = mamba_case(2, S, 3, 1, 8, 8, seed=S)
    grads, _ = mamba_replay_per_head(case, Q, heads=2)
    assert_grads(grads, mamba_port_plain(*case, Q))
    x, dt, A, Bm, Cm, _, dy, _ = mamba_case(3, S, 1, 1, 8, 8, seed=S + 1)
    A = np.repeat(A, 3)
    g, _ = mamba_bwd_replay(x, dt, A, Bm, Cm, Q, np.zeros((3, 1, 8, 8)), dy,
                            np.zeros((3, 1, 8, 8)))
    _, vjp = jax.vjp(mamba2_scan_ref, *(jnp.asarray(a) for a in (
        x[:, :, 0], dt[:, :, 0], A, Bm[:, :, 0], Cm[:, :, 0])))
    assert_grads([g[0][:, :, 0], g[1][:, :, 0], g[2], g[3][:, :, 0],
                  g[4][:, :, 0]], vjp(jnp.asarray(dy[:, :, 0])))


def test_mamba2_backward_replay_without_the_state_pass_is_rejected():
    case = mamba_case(2, 64, 2, 1, 8, 8, seed=7)
    grads, _ = mamba_replay_per_head(case, 16, state_pass=False)
    with pytest.raises(AssertionError):
        assert_grads(grads, mamba_ref_vjp(*case, 16), 2e-2)


def test_mamba2_backward_replay_with_one_head_tile_is_rejected():
    """dB and dC summed over one tile of heads of each group only (the
    first of two): the gate must fail it."""
    case = mamba_case(2, 64, 4, 1, 8, 8, seed=7)
    grads, _ = mamba_replay_per_head(case, 16, heads=2, one_tile=True)
    with pytest.raises(AssertionError):
        assert_grads(grads, mamba_ref_vjp(*case, 16), 2e-2)


def test_mamba2_backward_bf16_roundings_hold_the_gate():
    """The bf16 kernel's roundings replayed: bf16 inputs, the operands it
    computes (C exp(cum), dS, s_prev, M, LG) as bf16 hi + lo, fp32-exact
    products, against float64 on the same bf16 inputs, each gradient's
    error of its largest magnitude (dx, ddt, dA, dB, dC, dinit).  With
    dx, dB and dC in bf16, as the kernel writes them, the worst reads
    3.1e-3: within the 2e-2 gate by a margin of 5 and more.  Where M and
    LG are rounded to bf16 once, the bf16 outputs read about the same
    (their own rounding leads), but ddt, which leaves in fp32, goes from
    2.9e-6 to 1.6e-3: past the fp32 gate's 1e-4, within which the split
    keeps it by a margin of 30.  Before the outputs' rounding the split
    products read 4.0e-6 and one rounding 2.5e-3."""
    B, S, H, G, N, P, Q = 1, 256, 4, 1, 32, 32, 64
    case = list(mamba_case(B, S, H, G, N, P, seed=11))
    for i in (0, 3, 4, 6):               # x, Bm, Cm, dy in bf16
        case[i] = bf16_once(case[i])
    exact, _ = mamba_replay_per_head(case, Q)

    def errors(**kw):
        got, _ = mamba_replay_per_head(case, Q, round_ops=bf16_hi_lo, **kw)
        return [np.abs(a - b).max() / np.abs(b).max()
                for a, b in zip(got, exact)]

    split = errors(round_ml=bf16_hi_lo, out_type=bf16_once)
    once = errors(round_ml=bf16_once, out_type=bf16_once)
    split_sums = max(errors(round_ml=bf16_hi_lo))
    once_sums = max(errors(round_ml=bf16_once))
    assert max(split) <= 2e-2 / 5, split
    assert split[1] <= 1e-4 / 30 < 1e-4 < once[1], (split[1], once[1])
    assert once_sums > 100 * split_sums, (once_sums, split_sums)
    assert max(once) > max(split), (once, split)


# ------------------------------------------------------ the sources' plans
def constexpr(name: str, source: str) -> int:
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_backward_constants_match_the_sources():
    assert constexpr("kSave", "rwkv6_scan") == rs.SAVE_EVERY
    assert constexpr("kSave", "rwkv6_scan_bwd") == rs.SAVE_EVERY
    assert constexpr("kSub", "rwkv6_scan_bwd") == rs.BWD_SUB
    assert constexpr("kMaxQ", "mamba2_scan_bwd") == ms.MAX_CHUNK
    assert constexpr("kMaxNP", "mamba2_scan_bwd") == ms.MAX_NP
    assert constexpr("kMaxHeads", "mamba2_scan_bwd") == ms.MAX_HEADS
    text = (cuda_build.CSRC / "rwkv6_scan_bwd.cu").read_text()
    pieces = {int(n): (int(ra), int(ca)) for n, ra, ca in re.findall(
        r"struct Piece<(\d+)> \{ static constexpr int RA = (\d+), "
        r"CA = (\d+); \};", text)}
    assert pieces == rs.BWD_PIECE


@pytest.mark.parametrize("N", rs.HEAD_DIMS)
def test_rwkv6_backward_block_fits_the_card(N):
    """A block of the stretch walk holds whole rows in whole warps, within
    the card's shared memory; at rwkv6's N 64 two blocks fit an SM."""
    ra, ca = rs.BWD_PIECE[N]
    assert N % ra == 0 and N % ca == 0 and rs.SAVE_EVERY % rs.BWD_SUB == 0
    assert rs.bwd_threads(N) % 32 == 0 and rs.bwd_threads(N) <= 1024
    assert 32 % (N // ca) == 0            # a row's lanes within one warp
    assert rs.bwd_smem_bytes(N) <= rs.SMEM_LIMIT
    if N == 64:
        assert 2 * (rs.bwd_smem_bytes(N) + 1024) <= SM_SMEM


@pytest.mark.parametrize("Q,N,P", [(128, 64, 64), (32, 16, 16), (16, 4, 8)])
def test_mamba2_backward_blocks_fit_the_card(Q, N, P):
    """Every block's shared memory within the card's limit in both types,
    the largest at the kernel's largest chunk and state (zamba2-2.7b's);
    there the bf16 chunk kernels fit two blocks an SM."""
    for dtype in (torch.float32, torch.bfloat16):
        assert all(b <= ms.SMEM_LIMIT
                   for b in ms.bwd_smem_bytes(Q, N, P, ms.MAX_HEADS, dtype))
    bf16 = ms.bwd_smem_bytes(128, 64, 64, ms.MAX_HEADS, torch.bfloat16)
    assert 2 * (bf16[1] + 1024) <= SM_SMEM
    assert ms.bwd_smem_bytes(128, 64, 64, 1, torch.float32)[1] \
        <= ms.SMEM_LIMIT


def test_mamba2_backward_plan_at_zamba2s_training_shape():
    """zamba2-2.7b's 80 heads (4 x 2048 tokens, Q 128) on 132 SMs of two
    blocks: tiles of 10 heads, 8 a group, 512 blocks (0.97 of the last
    wave), and dB and dC parts of 8 planes, not 80."""
    pl = ms.bwd_plan(4, 2048, 80, 1, 64, 64, 128, sms=132, per_sm=2)
    assert (pl["heads"], pl["tiles"], pl["blocks"]) == (10, 8, 512)
    assert pl["scratch"]["dBC_part"] == 2 * 4 * 4 * 2048 * 8 * 64
    assert pl["smem"][1] == 113_168
