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
``jax.vjp``: K8's saved states every 16 steps, the recomputed stretch,
the column tiles' partial row sums and their sum; K7's state gradients
at the chunk ends, each chunk's formulas, the per-head parts of dB and
dC and their group sums.  Each replay with its planted fault (K8's state
gradient not decayed by w, K7's state gradients dropped between chunks)
must fail."""
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
def rwkv_bwd_replay(r, k, v, w, u, init, dy, dstate, decay=True):
    """csrc/rwkv6_scan_bwd.cu's arithmetic in float64, u per (b, h): the
    forward's saved states every ``SAVE_EVERY`` steps; for each column
    tile, the stretches from the last: the states recomputed forward
    from the saved one (dr's partial), then the backward walk (dw's and
    dk's partials, dv, du's partial, G); then the tiles' partials summed
    in order.  With ``decay`` False the planted fault: G not decayed by
    w.  Returns the gradients and the scratch's arrays."""
    r, k, v, w, u, init, dy, dstate = (np.asarray(a, np.float64) for a in (
        r, k, v, w, u, init, dy, dstate))
    B, S, H, N = r.shape
    u = u.reshape(B, H, N)
    L, C = rs.SAVE_EVERY, min(N, rs.BWD_COLS)
    T = rs.bwd_tiles(N)
    n_save = rs.saved_states(S)
    states = np.zeros((B, n_save, H, N, N))
    P = init.copy()
    for s in range(S):
        if s % L == 0:
            states[:, s // L] = P
        P = w[:, s, :, :, None] * P + k[:, s, :, :, None] * v[:, s, :, None]
    part = np.zeros((3, T, B, S, H, N))
    du_part = np.zeros((T, B, H, N))
    dv = np.zeros_like(r)
    dinit = np.zeros_like(init)
    bonus = (r * u[:, None] * k).sum(-1)                    # [B, S, H]
    for tile in range(T):
        cols = slice(tile * C, (tile + 1) * C)
        G = dstate[..., cols].copy()
        for sv in reversed(range(n_save)):
            t0, n = sv * L, min(L, S - sv * L)
            vd = (v[:, t0:t0 + n, :, cols] * dy[:, t0:t0 + n, :, cols]) \
                .sum(-1)                                    # [B, n, H]
            Pc, hist = states[:, sv][..., cols], []
            for s in range(t0, t0 + n):
                hist.append(Pc)
                part[0, tile, :, s] = (Pc * dy[:, s, :, None, cols]).sum(-1) \
                    + u * k[:, s] * vd[:, s - t0, :, None]
                Pc = w[:, s, :, :, None] * Pc \
                    + k[:, s, :, :, None] * v[:, s, :, None, cols]
            for s in reversed(range(t0, t0 + n)):
                part[2, tile, :, s] = (G * hist[s - t0]).sum(-1)
                part[1, tile, :, s] = (G * v[:, s, :, None, cols]).sum(-1) \
                    + u * r[:, s] * vd[:, s - t0, :, None]
                dv[:, s, :, cols] = (G * k[:, s, :, :, None]).sum(-2) \
                    + bonus[:, s, :, None] * dy[:, s, :, cols]
                du_part[tile] += r[:, s] * k[:, s] * vd[:, s - t0, :, None]
                G = (w[:, s, :, :, None] if decay else 1.0) * G \
                    + r[:, s, :, :, None] * dy[:, s, :, None, cols]
        dinit[..., cols] = G
    dr, dk, dw = part.sum(1)
    grads = (dr, dk, dv, dw, du_part.sum(0).reshape(B * H, N), dinit)
    return grads, dict(states=states, partials=part, du=du_part)


@pytest.mark.parametrize("B,S,H,N,Q", [
    (2, 48, 2, 8, 16),               # one tile, three whole stretches
    (1, 40, 3, 16, 8),               # two tiles, a last stretch of 8
    (2, 24, 1, 32, 8),               # four tiles, a last stretch of 8
    (1, 16, 1, 64, 16),              # eight tiles, one stretch
])
def test_rwkv6_backward_plan_replays_the_reference_gradient(B, S, H, N, Q):
    case = rwkv_case(B, S, H, N, seed=N)
    grads, scratch = rwkv_bwd_replay(*case[:4], per_row(case[4], B),
                                     *case[5:])
    ref = rwkv_ref_vjp(*case, Q)
    assert_grads(grads[:4] + (grads[4].reshape(B, H, N).sum(0), grads[5]),
                 ref)
    want = rs.bwd_scratch_bytes(B, S, H, N)
    assert {k: a.size * 4 for k, a in scratch.items()} == want


def test_rwkv6_backward_replay_without_the_decay_is_rejected():
    case = rwkv_case(2, 48, 2, 16, seed=3)
    ref = rwkv_ref_vjp(*case, 16)
    grads, _ = rwkv_bwd_replay(*case[:4], per_row(case[4], 2), *case[5:],
                               decay=False)
    with pytest.raises(AssertionError):
        assert_grads(grads[:4] + (grads[4].reshape(2, 2, 16).sum(0),
                                  grads[5]), ref, 2e-2)


# ------------------------------------------- K7's backward plan, replayed
def mamba_bwd_replay(x, dt, A, Bm, Cm, Q, init, dy, dstate, state_pass=True):
    """csrc/mamba2_scan_bwd.cu's arithmetic in float64, A per (b, h): the
    forward's state entering each chunk; kernel (a) each chunk's own part
    of the state gradient; (b) the walk from the last chunk; (c) each
    chunk's formulas with dB and dC per head; (d) their sums over each
    group's heads and dA's over the chunks.  With ``state_pass`` False the
    planted fault: the state gradients between chunks dropped.  Returns
    the gradients and the scratch's arrays."""
    x, dt, A, Bm, Cm, init, dy, dstate = (np.asarray(a, np.float64) for a in (
        x, dt, A, Bm, Cm, init, dy, dstate))
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    rep, nc = H // G, -(-S // Q)
    pad = nc * Q - S
    zp = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((B, pad) + a.shape[2:])], 1)
    x_, dt_, B_, C_, g_ = (zp(a) for a in (x, dt, Bm, Cm, dy))
    A = A.reshape(B, H)
    heads = np.arange(H) // rep
    dx, ddt = np.zeros_like(x_), np.zeros_like(dt_)
    dB_part, dC_part = np.zeros((B, nc * Q, H, N)), np.zeros((B, nc * Q, H, N))
    dA_part = np.zeros((B, nc, H))
    s_prev = np.zeros((B, nc, H, N, P))
    ds = np.zeros((B, nc, H, N, P))
    dec = np.zeros((B, nc, H))
    tri = np.tril(np.ones((Q, Q), bool))

    def chunk(c):
        sl = slice(c * Q, (c + 1) * Q)
        cum = np.cumsum(dt_[:, sl] * A[:, None], 1)         # [B, Q, H]
        Bh, Ch = B_[:, sl][:, :, heads], C_[:, sl][:, :, heads]
        dtx = dt_[:, sl, :, None] * x_[:, sl]              # [B, Q, H, P]
        return sl, cum, Bh, Ch, dtx

    s = init.copy()
    for c in range(nc):                  # the forward's states
        sl, cum, Bh, Ch, dtx = chunk(c)
        s_prev[:, c] = s
        E = np.exp(cum[:, -1:] - cum)
        s = np.exp(cum[:, -1])[..., None, None] * s \
            + np.einsum("bjh,bjhn,bjhp->bhnp", E, Bh, dtx)
    for c in range(nc):                  # (a)
        sl, cum, Bh, Ch, dtx = chunk(c)
        ds[:, c] = np.einsum("bih,bihn,bihp->bhnp", np.exp(cum), Ch, g_[:, sl])
        dec[:, c] = np.exp(cum[:, -1])
    cur = dstate.copy()                  # (b)
    for c in reversed(range(nc)):
        loc = ds[:, c].copy()
        ds[:, c] = cur if (state_pass or c == nc - 1) else 0.0
        cur = loc + dec[:, c][..., None, None] * cur
    dinit = cur
    for c in range(nc):                  # (c)
        sl, cum, Bh, Ch, dtx = chunk(c)
        g, dS, sp = g_[:, sl], ds[:, c], s_prev[:, c]
        L = np.where(tri[None, :, :, None],
                     np.exp(cum[:, :, None] - cum[:, None]), 0.0)  # [B,i,j,H]
        CB = np.einsum("bihn,bjhn->bijh", Ch, Bh)
        M = CB * L
        E = np.exp(cum[:, -1:] - cum)                       # [B, Q, H]
        d_dtx = np.einsum("bijh,bihp->bjhp", M, g) \
            + E[..., None] * np.einsum("bjhn,bhnp->bjhp", Bh, dS)
        dx[:, sl] = dt_[:, sl, :, None] * d_dtx
        GD = np.einsum("bihp,bjhp->bijh", g, dtx)
        W, LG = M * GD, L * GD
        sg = np.einsum("bhnp,bihp->bihn", sp, g)            # s_prev g_i
        sx = np.einsum("bhnp,bjhp->bjhn", dS, dtx)          # dS dtx_j
        dC_part[:, sl] = np.einsum("bijh,bjhn->bihn", LG, Bh) \
            + np.exp(cum)[..., None] * sg
        dB_part[:, sl] = np.einsum("bijh,bihn->bjhn", LG, Ch) \
            + E[..., None] * sx
        V = E * (Bh * sx).sum(-1)
        dcum = W.sum(2) - W.sum(1) + np.exp(cum) * (Ch * sg).sum(-1) - V
        dcum[:, -1] += np.exp(cum[:, -1]) * (sp * dS).sum((-2, -1)) \
            + V.sum(1)
        da = np.cumsum(dcum[:, ::-1], 1)[:, ::-1]
        ddt[:, sl] = A[:, None] * da + (x_[:, sl] * d_dtx).sum(-1)
        dA_part[:, c] = (dt_[:, sl] * da).sum(1)
    dB = dB_part.reshape(B, nc * Q, G, rep, N).sum(3)    # (d)
    dC = dC_part.reshape(B, nc * Q, G, rep, N).sum(3)
    grads = (dx[:, :S], ddt[:, :S], dA_part.sum(1).reshape(B * H),
             dB[:, :S], dC[:, :S], dinit)
    return grads, dict(s_prev=s_prev, ds=ds, dec=dec,
                       dBC_part=np.stack([dB_part[:, :S], dC_part[:, :S]]),
                       dA_part=dA_part)


def mamba_replay_per_head(case, Q, **kw):
    x, dt, A, Bm, Cm, init, dy, dstate = case
    B = x.shape[0]
    g, scratch = mamba_bwd_replay(x, dt, per_row(A, B), Bm, Cm, Q, init, dy,
                                  dstate, **kw)
    return (g[0], g[1], g[2].reshape(B, -1).sum(0), *g[3:]), scratch


@pytest.mark.parametrize("B,S,H,G,N,P,Q", [
    (2, 64, 4, 2, 8, 16, 16),        # group sums over two heads
    (1, 96, 6, 1, 16, 8, 32),        # one group of six heads
    (2, 32, 2, 2, 4, 4, 32),         # one chunk
])
def test_mamba2_backward_plan_replays_the_reference_gradient(B, S, H, G, N,
                                                             P, Q):
    case = mamba_case(B, S, H, G, N, P, seed=Q)
    grads, scratch = mamba_replay_per_head(case, Q)
    assert_grads(grads, mamba_ref_vjp(*case, Q))
    want = ms.bwd_scratch_bytes(B, S, H, G, N, P, Q, torch.float32)
    assert {k: a.size * 4 for k, a in scratch.items()} == want


@pytest.mark.parametrize("S,Q", [(50, 16), (37, 8)])
def test_mamba2_backward_plan_with_a_ragged_last_chunk(S, Q):
    """A last chunk shorter than Q, zero-padded as the forward pads it:
    the replay against the port's plain backward (which pads the same
    way) and, from a zero state, against the oracle."""
    case = mamba_case(2, S, 3, 1, 8, 8, seed=S)
    grads, _ = mamba_replay_per_head(case, Q)
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


# ------------------------------------------------------ the sources' plans
def constexpr(name: str, source: str) -> int:
    text = (cuda_build.CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_backward_constants_match_the_sources():
    assert constexpr("kSave", "rwkv6_scan") == rs.SAVE_EVERY
    assert constexpr("kSave", "rwkv6_scan_bwd") == rs.SAVE_EVERY
    assert constexpr("kCols", "rwkv6_scan_bwd") == rs.BWD_COLS
    assert constexpr("kMaxQ", "mamba2_scan_bwd") == ms.MAX_CHUNK
    assert constexpr("kMaxNP", "mamba2_scan_bwd") == ms.MAX_NP


@pytest.mark.parametrize("N", rs.HEAD_DIMS)
def test_rwkv6_backward_block_fits_the_card(N):
    """A block of N threads (one a state row) and its shared memory
    within the card's limit at every state size the kernel takes."""
    assert rs.bwd_smem_bytes(N) <= rs.SMEM_LIMIT
    assert rs.bwd_tiles(N) * min(N, rs.BWD_COLS) == N


@pytest.mark.parametrize("Q,N,P", [(128, 64, 64), (32, 16, 16), (16, 4, 8)])
def test_mamba2_backward_blocks_fit_the_card(Q, N, P):
    """Both blocks' shared memory within the card's limit, the largest
    at the kernel's largest chunk and state (zamba2-2.7b's)."""
    assert all(b <= ms.SMEM_LIMIT for b in ms.bwd_smem_bytes(Q, N, P))
    assert ms.bwd_smem_bytes(128, 64, 64)[1] <= ms.SMEM_LIMIT
