"""Model layers of every assigned architecture, in PyTorch: the port of
``repro/models/layers.py`` (attention, MLA, FFN, MoE).

Conventions, as in the reference
---------------------------------
* Parameters are nested dict-like trees of tensors with the reference's
  names and ``[in, out]`` layouts (``p["wq"]``, ``p.get("bq")``).
* Activations default to bf16; softmax and recurrence accumulate in fp32.
  Where the reference asks an einsum for an fp32 result from bf16 inputs
  (``preferred_element_type=float32``), the port takes the product in fp32
  of the bf16 values, which is the same function.
* ``blocked_attention`` is the hand-written flash-attention kernel
  (``kernels/flash_attention``, K6) on the card, with its hand-written
  backward when a gradient is asked, and its plain version on the CPU; the
  reference's blocks and ``attn_impl`` only tile the same function, so the
  port has neither and the kernel chooses its tiles.  Every layer here is
  differentiable: ``attention``, ``mla_attention``, ``ffn`` and
  ``moe_ffn`` (with its load-balance aux loss) are also the training
  forward.
* ``bf16_grad`` is the reference's bf16 gradient boundary: the identity,
  whose cotangent is rounded to bf16.
* The reference's sharding annotations (``constraint``) and its MoE
  ``expert_scheme`` branches (the same function under other shardings)
  return their input on one device; the port leaves them out until a mesh
  needs them.
* MLA's prefill decompresses K/V and runs the kernel at ``(nope + rope,
  v_head)``; its absorbed decode and the MoE dispatch and combine are plain
  torch, as the reference's are plain jnp.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_kernel

Params = Dict[str, Any]
NEG_INF = -1e30


class _BF16Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_grad(x: torch.Tensor) -> torch.Tensor:
    """Identity with a bf16 gradient boundary: cotangents crossing this
    point are rounded to bf16 (the reference halves the volume of every
    activation-gradient all-reduce upstream with it).  With no graph
    being recorded (serving) it is ``x`` itself."""
    if not torch.is_grad_enabled():
        return x
    return _BF16Grad.apply(x)


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


# ------------------------------------------------------------------------ MLA
def init_mla(gen, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    m: MLAConfig = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": normal(gen, (D, m.q_lora_rank), D, dtype),
        "q_norm": full(gen, (m.q_lora_rank,), 0.0, dtype),
        "w_uq": normal(gen, (m.q_lora_rank, H * qk), m.q_lora_rank, dtype),
        "w_dkv": normal(gen, (D, m.kv_lora_rank), D, dtype),
        "w_kr": normal(gen, (D, m.qk_rope_head_dim), D, dtype),
        "kv_norm": full(gen, (m.kv_lora_rank,), 0.0, dtype),
        "w_ukv": normal(gen, (m.kv_lora_rank,
                              H * (m.qk_nope_head_dim + m.v_head_dim)),
                        m.kv_lora_rank, dtype),
        "wo": normal(gen, (H * m.v_head_dim, D), H * m.v_head_dim, dtype),
    }


def mla_latents(p: Params, x: torch.Tensor, cfg: ModelConfig, positions
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache entries of tokens ``x`` [B,S,D] at ``positions`` [S]: the
    normed KV latent [B,S,kv_lora] and the rotated shared key [B,S,rope]."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    ckv = rms_norm(dense(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    sin, cos = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    kr = dense(x, p["w_kr"]).reshape(B, S, 1, m.qk_rope_head_dim)
    return ckv, apply_rope(kr, sin, cos).reshape(B, S, m.qk_rope_head_dim)


def _mla_queries(p: Params, x: torch.Tensor, cfg: ModelConfig, positions
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [B,S,H,nope], rotated q_rope [B,S,H,rope])."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    nope, rope_d = m.qk_nope_head_dim, m.qk_rope_head_dim
    cq = rms_norm(dense(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = dense(cq, p["w_uq"]).reshape(B, S, cfg.num_heads, nope + rope_d)
    sin, cos = rope_angles(positions, rope_d, cfg.rope_theta)
    return q[..., :nope], apply_rope(q[..., nope:], sin, cos)


def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """MLA prefill: K/V decompressed from the latent, every head its own
    KV head, through the kernel at (nope + rope, v_head).  x [B,S,D]."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_queries(p, x, cfg, positions)
    ckv, k_rope = mla_latents(p, x, cfg, positions)
    kv = dense(ckv, p["w_ukv"]).reshape(B, S, H, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(
        B, S, H, rope_d)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = blocked_attention(q, k, kv[..., nope:].contiguous(), causal=True)
    o = o.to(x.dtype).reshape(B, S, H * vd)
    return dense(o, p["wo"])


def mla_decode(p: Params, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, pos, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed MLA decode: scores and values in the kv_lora latent space
    against the read-only caches ([B,T,kv_lora], [B,T,rope]; positions <
    pos), the new token merged by online softmax.  Returns (out, ckv_new
    [B,1,kv_lora], kr_new [B,1,rope]) for the caller's cache write."""
    m: MLAConfig = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    at = torch.tensor([int(pos)], device=x.device)
    q_nope, q_rope = _mla_queries(p, x, cfg, at)
    ckv_t, kr_t = mla_latents(p, x, cfg, at)
    ckv_t = ckv_t.to(cache_ckv.dtype)                       # [B,1,r]
    kr_t = kr_t.to(cache_kr.dtype)
    w_ukv = p["w_ukv"].reshape(r, H, nope + vd)
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]       # [r,H,*]
    q_eff = matmul_f32(q_nope[:, 0], w_uk, "bhn,rhn->bhr")
    qr = q_rope[:, 0].float()
    T = cache_ckv.shape[1]
    scale = 1.0 / math.sqrt(nope + rope_d)
    ckv_f = cache_ckv.float()
    s = (torch.einsum("bhr,btr->bht", q_eff, ckv_f)
         + torch.einsum("bhd,btd->bht", qr, cache_kr.float())) * scale
    valid = (torch.arange(T, device=x.device) < int(pos))[None, None, :]
    s = torch.where(valid, s, NEG_INF)
    s_self = (torch.einsum("bhr,bxr->bh", q_eff, ckv_t.float())
              + torch.einsum("bhd,bxd->bh", qr, kr_t.float())) * scale
    mx = torch.maximum(s.amax(dim=-1), s_self)
    pattn = torch.exp(s - mx[..., None])
    p_self = torch.exp(s_self - mx)
    l = pattn.sum(dim=-1) + p_self
    ctx = torch.einsum("bht,btr->bhr", pattn, ckv_f) \
        + p_self[..., None] * ckv_t.float()
    ctx = ctx / torch.clamp(l, min=1e-30)[..., None]
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float())
    o = o.reshape(B, 1, H * vd).to(x.dtype)
    return dense(o, p["wo"]), ckv_t, kr_t


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


# ------------------------------------------------------------------------ MoE
def init_moe(gen, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    mo: MoEConfig = cfg.moe
    D, E, F_ = cfg.d_model, mo.num_experts, mo.d_ff
    p: Params = {
        "router": normal(gen, (D, E), D, dtype).float(),
        "w_gate": normal(gen, (E, D, F_), D, dtype),
        "w_up": normal(gen, (E, D, F_), D, dtype),
        "w_down": normal(gen, (E, F_, D), F_, dtype),
    }
    if mo.num_shared_experts:
        p["shared"] = init_ffn(gen, D, mo.num_shared_experts
                               * (mo.shared_d_ff or F_), dtype)
    return p


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert has a batch row: ceil(K S / E x capacity_factor)."""
    mo: MoEConfig = cfg.moe
    return max(1, int(math.ceil(mo.num_experts_per_tok * S / mo.num_experts
                                * mo.capacity_factor)))


def moe_route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The reference's routing of x [B,S,D]: fp32 softmax over the experts,
    the top K (ties to the lower index, as ``lax.top_k``), gates
    renormalised; each choice's position in its expert's buffer counts the
    earlier choices (s-major, k-minor) of the same expert in its batch
    row, and a choice at or past the capacity is dropped (gate 0).
    Returns (probs [B,S,E], gates, idx, pos, keep [B,S,K])."""
    mo: MoEConfig = cfg.moe
    B, S, _ = x.shape
    E, K = mo.num_experts, mo.num_experts_per_tok
    probs = torch.softmax(matmul_f32(x, p["router"], "bsd,de->bse"), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[..., :K], order.indices[..., :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # the choices to each expert counted along [S*K] (an inner-axis scan)
    onehot = F.one_hot(idx.reshape(B, S * K), E).to(torch.int32)
    counts = torch.cumsum(onehot.transpose(1, 2), dim=-1).transpose(1, 2)
    pos = torch.gather(counts, 2, idx.reshape(B, S * K, 1)).reshape(
        B, S, K) - 1
    keep = pos < moe_capacity(cfg, S)
    return probs, torch.where(keep, gates, 0.0), idx, pos, keep


def _expert_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bec*,e**->bec*", ..., preferred_element_type=bfloat16)`` of
    a [B,E,C,X] and w [E,X,Y]: the product in fp32, rounded to bf16 once,
    in a's type; one batched product over the experts, each expert's
    weights read once for all B x C rows."""
    B, E, C, X = a.shape
    rows = a.transpose(0, 1).reshape(E, B * C, X)
    if a.device.type == "cpu":
        y = torch.bmm(rows.float(), w.float())
    else:
        y = torch.bmm(rows, w.to(a.dtype))
    y = y.reshape(E, B, C, -1).transpose(0, 1)
    return y.to(torch.bfloat16).to(a.dtype)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity MoE grouped by batch row (GShard style): x [B,S,D] is
    dispatched into [B,E,C,D], each expert's gated FFN runs as batched
    matrix products, and each token's K outputs are gathered back and
    summed by their gates in fp32; the shared experts' FFN is added.
    Returns (y, Switch-style load-balance aux loss)."""
    mo: MoEConfig = cfg.moe
    B, S, D = x.shape
    E, K = mo.num_experts, mo.num_experts_per_tok
    C = moe_capacity(cfg, S)
    probs, gates, idx, pos, keep = moe_route(p, x, cfg)
    pos_c = torch.clamp(pos, 0, C - 1)
    rows = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    # the reference adds each kept token at its slot and zeros for the
    # dropped ones; here the dropped ones go to a spare slot C, dropped
    buf = x.new_zeros((B, E, C + 1, D)).index_put_(
        (rows, idx, torch.where(keep, pos, C)),
        x[:, :, None, :].expand(B, S, K, D))[:, :, :C]
    g = _expert_product(buf, p["w_gate"])
    u = _expert_product(buf, p["w_up"])
    h = act_fn(cfg.hidden_act)(g.float()).to(x.dtype) * u
    y_buf = _expert_product(h, p["w_down"])
    y = y_buf[rows, idx, pos_c]                             # [B,S,K,D]
    y = (y.float() * gates[..., None]).sum(dim=2).to(x.dtype)
    if "shared" in p:
        y = y + ffn(p["shared"], x, cfg.hidden_act)
    me = probs.mean(dim=(0, 1))
    ce = (F.one_hot(idx, E).sum(2).reshape(B * S, E) > 0).float().mean(0)
    return y, (me * ce).sum() * E
