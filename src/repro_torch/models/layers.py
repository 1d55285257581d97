"""Model layers of the dense subset, in PyTorch: the port of
``repro/models/layers.py``.

Conventions, as in the reference
---------------------------------
* Parameters are nested dict-like trees of tensors with the reference's
  names and ``[in, out]`` layouts (``p["wq"]``, ``p.get("bq")``).
* Activations default to bf16; softmax and recurrence accumulate in fp32.
  Where the reference asks an einsum for an fp32 result from bf16 inputs
  (``preferred_element_type=float32``), the port takes the product in fp32
  of the bf16 values, which is the same function.
* ``blocked_attention`` is the hand-written flash-attention kernel
  (``kernels/flash_attention``, K6) on the card and its plain version on
  the CPU; the reference's blocks and ``attn_impl`` only tile the same
  function, so the port has neither and the kernel chooses its tiles.
* The reference's sharding annotations (``constraint``) and its bf16
  gradient casts return their input on one device in the forward pass;
  the port leaves them out until a mesh or a training slice needs them.

MLA and MoE layers come with a later slice of the port (ROADMAP.md §1,
"Model zoo: MLA and MoE"); ``models/lm.py`` raises for their configs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_kernel

Params = Dict[str, Any]
NEG_INF = -1e30


# --------------------------------------------------------------------- basics
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          out_dtype=None) -> torch.Tensor:
    ct = torch.promote_types(x.dtype, w.dtype)
    if x.device.type == "cpu":
        # the product accumulated in fp32 and rounded once, as XLA and
        # cuBLAS take it; torch's CPU bf16 matmul rounds partial sums
        y = torch.matmul(x.float(), w.float()).to(ct)
    else:
        y = torch.matmul(x.to(ct), w.to(ct))
    out = out_dtype or x.dtype
    if b is not None:
        y = y.to(out) + b
    return y.to(out)


def matmul_f32(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, b, preferred_element_type=float32)``: the product of
    the given values, taken and returned in fp32."""
    return torch.einsum(eq, a.float(), b.float())


# ----------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [*] -> (sin, cos) each [*, dim/2] fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; sin/cos [S, D/2] (or broadcastable)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    s = sin[..., :, None, :]
    c = cos[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ------------------------------------------------------------------ attention
def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool) -> torch.Tensor:
    """Flash-style attention.  q [B,S,H,dk]; k [B,T,KV,dk]; v [B,T,KV,dv];
    H = KV*G.  Returns [B,S,H,dv] in q's type.  The kernel tiles by itself
    and bounds-checks ragged S and T; the causal mask starts at position 0
    (the reference's ``q_offset=0``, which every caller passes)."""
    return flash_attention_kernel(q, k, v, causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention.  q [B,1,H,dk]; caches [B,T,KV,d*].  The cache
    is read-only (positions < pos, or <= pos when k_new is None) and the
    new token's (k_new, v_new) [B,1,KV,d*] is merged via online softmax."""
    B, _, H, dk = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    dv = v_cache.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    qh = q.reshape(B, KV, G, dk)
    s = matmul_f32(qh, k_cache, "bhgd,bkhd->bhgk") * scale
    limit = int(pos) if k_new is not None else int(pos) + 1
    valid = (torch.arange(T, device=q.device) < limit)[None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                      # [B,KV,G]
    if k_new is not None:
        s_self = matmul_f32(qh, k_new, "bhgd,bxhd->bhg") * scale
        m = torch.maximum(m, s_self)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = matmul_f32(p.to(v_cache.dtype), v_cache, "bhgk,bkhd->bhgd")
    if k_new is not None:
        p_self = torch.exp(s_self - m)                      # [B,KV,G]
        l = l + p_self
        o = o + p_self[..., None] * v_new.reshape(B, KV, 1, dv).float()
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, 1, H, dv).to(q.dtype)


# ------------------------------------------------------------- initialisers
def normal(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """The reference's ``normal(shape) / sqrt(fan_in)``, drawn in fp32 from
    ``gen`` on its device, then cast."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x / math.sqrt(fan_in)).to(dtype)


def full(gen: torch.Generator, shape, value: float, dtype) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=gen.device)


# ------------------------------------------------------------- attention core
def init_attention(gen, cfg: ModelConfig, d_in: Optional[int] = None,
                   heads: Optional[int] = None,
                   dtype=torch.bfloat16) -> Params:
    D = d_in or cfg.d_model
    H = heads or cfg.num_heads
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    p: Params = {
        "wq": normal(gen, (D, H * hd), D, dtype),
        "wk": normal(gen, (D, KV * hd), D, dtype),
        "wv": normal(gen, (D, KV * hd), D, dtype),
        "wo": normal(gen, (H * hd, cfg.d_model), H * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = full(gen, (H * hd,), 0.0, dtype)
        p["bk"] = full(gen, (KV * hd,), 0.0, dtype)
        p["bv"] = full(gen, (KV * hd,), 0.0, dtype)
    if cfg.qk_norm:
        p["q_norm"] = full(gen, (hd,), 0.0, dtype)
        p["k_norm"] = full(gen, (hd,), 0.0, dtype)
    return p


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              heads: Optional[int] = None, causal: bool = True,
              kv_x: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill).  x [B,S,D]."""
    B, S, _ = x.shape
    H = heads or cfg.num_heads
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    src = kv_x if kv_x is not None else x
    T = src.shape[1]
    q = dense(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = dense(src, p["wk"], p.get("bk")).reshape(B, T, KV, hd)
    v = dense(src, p["wv"], p.get("bv")).reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        pos_q = positions if positions is not None \
            else torch.arange(S, device=x.device)
        sin, cos = rope_angles(pos_q, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        sin_k, cos_k = rope_angles(torch.arange(T, device=x.device), hd,
                                   cfg.rope_theta)
        k = apply_rope(k, sin_k, cos_k)
    o = blocked_attention(q, k, v, causal=causal)
    o = o.to(x.dtype).reshape(B, S, H * hd)
    return dense(o, p["wo"])


def attention_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, cfg: ModelConfig, *,
                     heads: Optional[int] = None, use_rope: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step.  x [B,1,D]; caches [B,T,KV,hd] (read-only; the new
    token occupies logical slot ``pos``).  Returns (out, k_new, v_new) —
    the caller writes (k_new, v_new) into its cache at ``pos``."""
    B = x.shape[0]
    H = heads or cfg.num_heads
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(B, 1, H, hd)
    k = dense(x, p["wk"], p.get("bk")).reshape(B, 1, KV, hd)
    v = dense(x, p["wv"], p.get("bv")).reshape(B, 1, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        sin, cos = rope_angles(torch.tensor([int(pos)], device=x.device), hd,
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    k = k.to(cache_k.dtype)
    v = v.to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, pos, k_new=k, v_new=v)
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    return dense(o, p["wo"]), k, v


# ------------------------------------------------------------------------ FFN
def init_ffn(gen, d_model: int, d_ff: int, dtype=torch.bfloat16) -> Params:
    return {"w_gate": normal(gen, (d_model, d_ff), d_model, dtype),
            "w_up": normal(gen, (d_model, d_ff), d_model, dtype),
            "w_down": normal(gen, (d_ff, d_model), d_ff, dtype)}


def ffn(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    g = dense(x, p["w_gate"])
    u = dense(x, p["w_up"])
    h = act_fn(act)(g.float()).to(x.dtype) * u
    return dense(h, p["w_down"])
