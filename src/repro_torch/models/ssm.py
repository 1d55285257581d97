"""Mamba2 (SSD, chunked) and RWKV6 (Finch, data-dependent decay) blocks, in
PyTorch: the port of ``repro/models/ssm.py``.

Prefill runs ``ssd_chunked``, the hand-written SSD scan
(``kernels/mamba2_scan``, K7), on the card, with its plain version on the
CPU; Mamba2 decode is the O(1)-per-token state update in plain PyTorch, as
in the reference.  ``rwkv6_time_mix`` runs the hand-written RWKV6 scan
(``kernels/rwkv6_scan``, K8) at every length, decode's single step
included: K8 computes the sequential recurrence where the reference takes
its chunked closed form (``_rwkv6_chunked``) for lengths that divide into
chunks and steps one token at a time for the others; all three are the
same function up to rounding.

Training: the reference's bf16 gradient boundaries sit on the Mamba2
projections.  On the CPU autograd differentiates the scans' plain
versions; on the card the scan wrappers route a gradient through their
backward kernels themselves (K7: ``csrc/mamba2_scan_bwd.cu``, fp32 and
bf16; K8: ``csrc/rwkv6_scan_bwd.cu``, fp32, the type every model path
gives it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.mamba2_scan.mamba2_scan import mamba2_scan_kernel
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan_kernel
from repro_torch.models.layers import (bf16_grad, dense, full, normal,
                                       rms_norm)

Params = Dict[str, Any]


# ------------------------------------------------------------------- mamba2
def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return d_in, heads, s.head_dim, s.state_dim, conv_dim


def init_mamba2(gen, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """Projections stored per segment (z/x/B/C/dt and per-stream convs), as
    in the reference."""
    s: SSMConfig = cfg.ssm
    D = cfg.d_model
    d_in, H, P, N, conv_dim = mamba2_dims(cfg)
    gn = s.n_groups * N
    K = s.conv_kernel
    f32 = torch.float32
    return {
        "w_z": normal(gen, (D, d_in), D, dtype),
        "w_x": normal(gen, (D, d_in), D, dtype),
        "w_Bm": normal(gen, (D, gn), D, dtype),
        "w_Cm": normal(gen, (D, gn), D, dtype),
        "w_dt": normal(gen, (D, H), D, dtype),
        "conv_x": normal(gen, (K, d_in), K, dtype),
        "conv_B": normal(gen, (K, gn), K, dtype),
        "conv_C": normal(gen, (K, gn), K, dtype),
        "conv_bx": full(gen, (d_in,), 0.0, dtype),
        "conv_bB": full(gen, (gn,), 0.0, dtype),
        "conv_bC": full(gen, (gn,), 0.0, dtype),
        "A_log": full(gen, (H,), 0.0, f32),
        "D_skip": full(gen, (H,), 1.0, f32),
        "dt_bias": full(gen, (H,), 0.0, f32),
        "norm": full(gen, (d_in,), 0.0, dtype),
        "w_out": normal(gen, (d_in, D), d_in, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x [B,S,C]; w [K,C].  The K taps are summed
    in fp32 and rounded to x's type before the bias, as the reference's
    convolution in x's type does."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    wf = w.to(x.dtype).float()
    y = sum(xp[:, k:k + S] * wf[k] for k in range(K))
    return y.to(x.dtype) + b


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba2 §6).  xs [B,S,H,P]; dt [B,S,H]; A [H] (<0);
    Bm/Cm [B,S,G,N].  Returns (y [B,S,H,P], final_state [B,H,N,P])."""
    B_, S, H, P = xs.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {Q}")
    A_bh = A.float().reshape(1, H).expand(B_, H).reshape(B_ * H)
    return mamba2_scan_kernel(xs.contiguous(), dt.float().contiguous(), A_bh,
                              Bm.to(xs.dtype).contiguous(),
                              Cm.to(xs.dtype).contiguous(), Q, init_state)


def mamba2_block(p: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """Train/prefill Mamba2 block.  x [B,S,D] -> [B,S,D]."""
    return mamba2_block_with_state(p, x, cfg)[0]


def mamba2_block_with_state(p: Params, x: torch.Tensor, cfg: ModelConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    s: SSMConfig = cfg.ssm
    B, S, D = x.shape
    d_in, H, P, N, conv_dim = mamba2_dims(cfg)
    # the reference's bf16 gradient boundaries on the projections
    z = bf16_grad(dense(x, p["w_z"]))
    x_pre = bf16_grad(dense(x, p["w_x"]))
    B_pre = bf16_grad(dense(x, p["w_Bm"]))
    C_pre = bf16_grad(dense(x, p["w_Cm"]))
    dt = bf16_grad(dense(x, p["w_dt"]))
    conv_tail = torch.cat([x_pre, B_pre, C_pre],
                          dim=-1)[:, -(s.conv_kernel - 1):, :]

    def conv(v, w, b):
        return F.silu(_causal_conv(v, w, b).float()).to(x.dtype)

    xs = conv(x_pre, p["conv_x"], p["conv_bx"]).reshape(B, S, H, P)
    Bm = conv(B_pre, p["conv_B"], p["conv_bB"]).reshape(B, S, s.n_groups, N)
    Cm = conv(C_pre, p["conv_C"], p["conv_bC"]).reshape(B, S, s.n_groups, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk)
    y = y + (p["D_skip"][:, None] * xs.float()).to(y.dtype)
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return dense(y, p["w_out"]), state, conv_tail


def mamba2_decode(p: Params, x: torch.Tensor, conv_state: torch.Tensor,
                  ssd_state: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token Mamba2 step.  x [B,1,D]; conv_state [B,K-1,conv_dim];
    ssd_state [B,H,N,P]."""
    s: SSMConfig = cfg.ssm
    B = x.shape[0]
    d_in, H, P, N, conv_dim = mamba2_dims(cfg)
    gn = s.n_groups * N
    x0 = x[:, 0]
    z = dense(x0, p["w_z"])
    new_pre = torch.cat([dense(x0, p["w_x"]), dense(x0, p["w_Bm"]),
                         dense(x0, p["w_Cm"])], dim=-1)
    dt = dense(x0, p["w_dt"])

    window = torch.cat([conv_state, new_pre[:, None, :]], dim=1)
    conv_state = window[:, 1:, :]
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv_b = torch.cat([p["conv_bx"], p["conv_bB"], p["conv_bC"]], dim=-1)
    xBC = torch.einsum("bkc,kc->bc", window.float(), conv_w.float()) \
        + conv_b.float()
    xBC = F.silu(xBC).to(x.dtype)

    xs = xBC[..., :d_in].reshape(B, H, P).float()
    Bm = xBC[..., d_in:d_in + gn].reshape(B, s.n_groups, N)
    Cm = xBC[..., d_in + gn:].reshape(B, s.n_groups, N)
    dt = F.softplus(dt.float() + p["dt_bias"])             # [B,H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                  # [B,H]
    rep = H // s.n_groups
    Bh = torch.repeat_interleave(Bm.float(), rep, dim=1)    # [B,H,N]
    Ch = torch.repeat_interleave(Cm.float(), rep, dim=1)
    dBx = dt[..., None, None] * Bh[..., :, None] * xs[..., None, :]
    state = ssd_state.float() * dA[..., None, None] + dBx
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y + p["D_skip"][:, None] * xs
    y = y.reshape(B, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return dense(y, p["w_out"])[:, None, :], conv_state, \
        state.to(ssd_state.dtype)


# --------------------------------------------------------------------- rwkv6
LORA_MIX = 32
LORA_DECAY = 64


def init_rwkv6(gen, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    D = cfg.d_model
    H = cfg.num_heads
    N = cfg.ssm.head_dim
    assert H * N == D, (H, N, D)
    f32 = torch.float32
    return {
        "mu_base": full(gen, (D,), 0.0, dtype),
        "mu": full(gen, (5, D), 0.0, dtype),               # r,k,v,w,g lerp
        "lora_A": normal(gen, (D, 5 * LORA_MIX), D, dtype),
        "lora_B": normal(gen, (5, LORA_MIX, D), LORA_MIX, dtype),
        "w0": full(gen, (D,), -0.6, f32),                  # decay base
        "decay_A": normal(gen, (D, LORA_DECAY), D, dtype),
        "decay_B": normal(gen, (LORA_DECAY, D), LORA_DECAY, dtype),
        "wr": normal(gen, (D, D), D, dtype),
        "wk": normal(gen, (D, D), D, dtype),
        "wv": normal(gen, (D, D), D, dtype),
        "wg": normal(gen, (D, D), D, dtype),
        "u": full(gen, (H, N), 0.0, f32),                  # bonus
        "ln_scale": full(gen, (D,), 1.0, f32),
        "ln_bias": full(gen, (D,), 0.0, f32),
        "wo": normal(gen, (D, D), D, dtype),
        "cm_mu_k": full(gen, (D,), 0.0, dtype),
        "cm_mu_r": full(gen, (D,), 0.0, dtype),
        "cm_wk": normal(gen, (D, cfg.d_ff), D, dtype),
        "cm_wv": normal(gen, (cfg.d_ff, D), cfg.d_ff, dtype),
        "cm_wr": normal(gen, (D, D), D, dtype),
    }


def _group_norm_heads(y: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, H: int,
                      eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm with one group per head; y [...,D]."""
    shp = y.shape
    y = y.reshape(*shp[:-1], H, shp[-1] // H).float()
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = (y - mu) * torch.rsqrt(var + eps)
    y = y.reshape(shp)
    return y * scale + bias


def rwkv6_time_mix(p: Params, x: torch.Tensor, shift_state: torch.Tensor,
                   wkv_state: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D]; shift_state [B,D] (x_{-1}); wkv_state [B,H,N,N] fp32.
    Returns (out, new_shift, new_wkv)."""
    B, S, D = x.shape
    H = cfg.num_heads
    N = cfg.ssm.head_dim
    x_prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]],
                       dim=1)
    dx = x_prev - x
    xxx = x + dx * p["mu_base"]
    st = torch.tanh(dense(xxx, p["lora_A"])).reshape(B, S, 5, LORA_MIX)
    adj = torch.einsum("bsfr,frd->bsfd", st, p["lora_B"].to(st.dtype))
    mix = x[:, :, None, :] + dx[:, :, None, :] * (p["mu"] + adj)
    xr, xk, xv, xw, xg = [mix[:, :, i, :] for i in range(5)]

    r = dense(xr, p["wr"]).reshape(B, S, H, N).float()
    kk = dense(xk, p["wk"]).reshape(B, S, H, N).float()
    v = dense(xv, p["wv"]).reshape(B, S, H, N).float()
    g = F.silu(dense(xg, p["wg"]).float())
    ww = p["w0"] + dense(torch.tanh(dense(xw, p["decay_A"])),
                         p["decay_B"]).float()
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, N)      # decay in (0,1)
    u_bh = p["u"].float().reshape(1, H, N).expand(B, H, N).reshape(B * H, N)
    y, new_state = rwkv6_scan_kernel(r, kk, v, w.contiguous(), u_bh,
                                     wkv_state.float())
    y = y.reshape(B, S, D)                                 # fp32
    y = _group_norm_heads(y, p["ln_scale"], p["ln_bias"], H)
    y = (y * g).to(x.dtype)
    return dense(y, p["wo"]), x[:, -1, :], new_state.to(wkv_state.dtype)


def rwkv6_channel_mix(p: Params, x: torch.Tensor, shift_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    x_prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]],
                       dim=1)
    dx = x_prev - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    k = torch.square(F.relu(dense(xk, p["cm_wk"]).float())).to(x.dtype)
    out = torch.sigmoid(dense(xr, p["cm_wr"]).float()).to(x.dtype) \
        * dense(k, p["cm_wv"])
    return out, x[:, -1, :]
