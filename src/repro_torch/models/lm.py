"""Model builders, in PyTorch: the port of ``repro/models/lm.py``.

    model = build_model(cfg, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    logits, cache = model.prefill({"tokens": tokens})
    logits, cache = model.decode(cache, {"tokens": tok, "pos": pos})
    loss, metrics = model.train_loss(params, batch)

A vision model's prefill also takes ``frontend_embeds`` [B, n_img,
embed_dim] (its image tokens come first, so decode positions count them);
an encoder-decoder's takes ``frames`` [B, T_enc, embed_dim].

A model is an ``nn.Module`` whose parameters keep the reference's names and
``[in, out]`` layouts; the reference's stacked layer axis becomes a
``ModuleList`` (``layers.0.attn.wq``).  ``params_from_jax`` carries a JAX
parameter tree (as numpy arrays) across, so the tests can run both packages
on the same weights.  Caches are the reference's pytrees (dicts, tuples and
lists of tensors, stacked over layers where the reference stacks them; the
position an int32 scalar on the host); decode returns a new cache and
leaves the one it was given unchanged.

Builders: the decoder (dense, MoE with a dense prefix, MLA, a vision
frontend), zamba2 (Mamba2 + shared attention), rwkv6 and the
encoder-decoder; together every architecture of the registry.

Training takes its parameters as an argument, ``train_loss(params,
batch)``, in the reference's layout: each stacked layer axis a leading
dimension (``stack_layers`` of ``init_tree``'s or ``params_from_jax``'s
tree), so that gradients, optimizer state and checkpoints are the
reference's leaf for leaf.  The loss is the reference's: the mean
next-token cross-entropy over sequence chunks (``chunked_xent``, each
chunk's [B, chunk, V] logits recomputed in the backward), plus 0.01 times
the MoE load-balance loss, with a vision model's image positions dropped.
``remat="block"`` recomputes each stacked layer in the backward
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (act_fn, apply_rope, attention,
                                       attention_decode, bf16_grad,
                                       decode_attention, dense, ffn, full,
                                       init_attention, init_ffn, init_mla,
                                       init_moe,
                                       matmul_f32, mla_attention, mla_decode,
                                       mla_latents, moe_ffn, normal,
                                       rms_norm, rope_angles)

Params = Dict[str, Any]
Batch = Dict[str, Any]

XENT_CHUNK = 256


# ------------------------------------------------------------------ utilities
def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _pos(pos) -> torch.Tensor:
    """The decode position as the reference's int32 scalar, on the host."""
    return torch.tensor(int(pos), dtype=torch.int32)


def _update_at(a: torch.Tensor, new: torch.Tensor, pos, axis: int
               ) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim`` on a copy: the start index is
    clamped so that ``new`` fits, as in JAX."""
    n = new.shape[axis]
    start = min(max(int(pos), 0), a.shape[axis] - n)
    out = a.clone()
    out.narrow(axis, start, n).copy_(new)
    return out


def _embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["embed"])


def logits_last(h_last: torch.Tensor, w_head: torch.Tensor) -> torch.Tensor:
    """h_last [B,D] -> [B,V] fp32."""
    return matmul_f32(h_last, w_head, "bd,dv->bv")


def _xent_chunk(hc, w_head, tc, mc) -> torch.Tensor:
    logits = matmul_f32(hc, w_head, "bsd,dv->bsv")
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
    return ((lse - tgt) * mc).sum()


def chunked_xent(h: torch.Tensor, w_head: torch.Tensor, targets,
                 mask=None, chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Mean next-token cross-entropy without materialising [B,S,V]: the
    sequence in chunks, each chunk's fp32 logits recomputed in the backward
    (the reference's ``jax.checkpoint``), the sums taken in chunk order."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    targets = torch.as_tensor(targets).to(h.device).long()
    m = torch.ones((B, S), dtype=torch.float32, device=h.device) \
        if mask is None else torch.as_tensor(mask).to(h.device).float()
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        loss = loss + checkpoint(_xent_chunk, h[:, sl], w_head,
                                 targets[:, sl], m[:, sl],
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        cnt = cnt + m[:, sl].sum()
    return loss / torch.clamp(cnt, min=1.0)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``remat="block"``
    when a graph is being recorded."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class ParamTree(nn.Module):
    """A nested tree of parameters under the reference's names: tensors
    become (frozen) parameters, dicts sub-trees and lists ``ModuleList``s.
    Layer code reads it like the reference's dicts (``p["wq"]``,
    ``p.get("bq")``)."""

    def _fill(self, tree: Params, device=None) -> None:
        for name, val in tree.items():
            if isinstance(val, dict):
                sub = ParamTree()
                sub._fill(val, device)
                self.add_module(name, sub)
            elif isinstance(val, (list, tuple)):
                subs = []
                for v in val:
                    sub = ParamTree()
                    sub._fill(v, device)
                    subs.append(sub)
                self.add_module(name, nn.ModuleList(subs))
            else:
                t = torch.as_tensor(val)
                self.register_parameter(name, nn.Parameter(
                    t if device is None else t.to(device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Model(ParamTree):
    """One architecture's parameters and its serving entry points."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)

    def init_tree(self, gen: torch.Generator) -> Params:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator) -> "Model":
        """Draw every parameter from ``gen`` with the reference's
        distributions (not its numbers: the generators differ)."""
        return self.load_params(self.init_tree(gen))

    def load_params(self, tree: Params) -> "Model":
        """Install a parameter tree (e.g. ``params_from_jax``'s) on the
        model's device, replacing what it held."""
        for name in list(self._parameters) + list(self._modules):
            delattr(self, name)
        self._fill(tree, self.device)
        return self

    def _tokens(self, batch: Batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"]).to(self.device)

    def prefill(self, batch: Batch):
        raise NotImplementedError

    def decode(self, cache, batch: Batch):
        raise NotImplementedError

    def train_loss(self, params: Params, batch: Batch):
        """(loss, metrics) of ``batch`` (``tokens``, ``targets``, an
        optional ``loss_mask``, and the frontend's inputs) under
        ``params`` in the reference's layout (module docstring)."""
        raise NotImplementedError

    def _layers(self, p: Params, name: str) -> List[Params]:
        return layer_views(p[name], _stacked(self.cfg)[name])



def build_model(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.ssm and cfg.ssm.kind == "rwkv6":
        return RWKV6LM(cfg, device)
    if cfg.ssm and cfg.ssm.kind == "mamba2":
        return ZambaLM(cfg, device)
    if cfg.encoder_decoder:
        return EncDecLM(cfg, device)
    return DecoderLM(cfg, device)


def _unstack(tree: Any, L: int) -> List[Any]:
    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        if t.shape[0] != L:
            raise ValueError(f"params_from_jax: a stacked leaf has "
                             f"{t.shape[0]} layers, the config {L}")
        return t[i].clone()
    return [pick(tree, i) for i in range(L)]


def _to_torch(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_torch(v) for v in x]
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _stacked(cfg: ModelConfig) -> Dict[str, int]:
    """The reference's stacked (scanned) layer trees and their lengths."""
    if cfg.encoder_decoder:
        return {"enc_layers": cfg.num_encoder_layers,
                "dec_layers": cfg.num_layers}
    prefix = cfg.moe.first_k_dense if cfg.moe else 0
    return {"layers": cfg.num_layers - prefix}


def params_from_jax(cfg: ModelConfig, tree: Params) -> Params:
    """The reference's parameter tree for ``cfg`` (its leaves as numpy
    arrays, bf16 as ``ml_dtypes.bfloat16``) as the port's tree of CPU
    tensors: each stacked layer axis (``layers``: the layers after the
    dense prefix; ``enc_layers``, ``dec_layers``) unstacked into a list,
    for ``Model.load_params``; ``prefix_layers`` is a list already.  A tree
    without stacked layers (one layer's parameters) is converted as it
    is."""
    out = _to_torch(tree)
    for name, n in _stacked(cfg).items():
        if name in out:
            out[name] = _unstack(out[name], n)
    return out


def stack_layers(cfg: ModelConfig, tree: Params) -> Params:
    """The port's tree (``init_tree``'s, ``params_from_jax``'s: each
    stacked layer axis a list) in the reference's layout, each of those
    lists stacked along a new leading axis: training's parameters."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lp[k] for lp in layers]) for k in layers[0]}
        return torch.stack(layers)
    out = dict(tree)
    for name in _stacked(cfg):
        if name in out:
            out[name] = stack(out[name])
    return out


def layer_views(stacked: Params, n: int) -> List[Params]:
    """A stacked layer tree as ``n`` per-layer trees of views
    (``torch.unbind``), through which each layer's gradient lands in its
    slice of the stacked leaf."""
    if isinstance(stacked, dict):
        parts = {k: layer_views(v, n) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if stacked.shape[0] != n:
        raise ValueError(f"a stacked leaf has {stacked.shape[0]} layers, "
                         f"the config {n}")
    return list(torch.unbind(stacked))


# ===================================================================== dense
def _init_block(gen, cfg: ModelConfig, dtype, d_ff=None) -> Params:
    """A block: MLA or standard attention, then the MoE or (with ``d_ff``,
    or without MoE) a dense FFN."""
    p = {"ln1": full(gen, (cfg.d_model,), 0.0, dtype),
         "ln2": full(gen, (cfg.d_model,), 0.0, dtype),
         "attn": init_mla(gen, cfg, dtype) if cfg.mla
         else init_attention(gen, cfg, dtype=dtype)}
    if cfg.moe and d_ff is None:
        p["moe"] = init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = init_ffn(gen, cfg.d_model, d_ff or cfg.d_ff, dtype)
    return p


def _mlp(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "moe" in p:
        return moe_ffn(p["moe"], h, cfg)[0]
    return ffn(p["ffn"], h, cfg.hidden_act)


def _block_fwd(p, h: torch.Tensor, cfg: ModelConfig):
    """Pre-norm transformer block for training; returns (h, moe_aux)."""
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + (mla_attention(p["attn"], hn, cfg) if cfg.mla
             else attention(p["attn"], hn, cfg))
    hn = rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = moe_ffn(p["moe"], hn, cfg)
    else:
        f = ffn(p["ffn"], hn, cfg.hidden_act)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f, aux


def _block_prefill(p, h: torch.Tensor, cfg: ModelConfig):
    """Pre-norm transformer block that also returns this layer's cache
    entries: (k, v) [B,S,KV,hd], or MLA's (ckv [B,S,kv_lora], kr
    [B,S,rope])."""
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)
    if cfg.mla:
        kv = mla_latents(p["attn"], hn, cfg, positions)
        a = mla_attention(p["attn"], hn, cfg)
    else:
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        k = dense(hn, p["attn"]["wk"], p["attn"].get("bk")).reshape(
            B, S, KV, hd)
        v = dense(hn, p["attn"]["wv"], p["attn"].get("bv")).reshape(
            B, S, KV, hd)
        if cfg.qk_norm:
            k = rms_norm(k, p["attn"]["k_norm"], cfg.norm_eps)
        sin, cos = rope_angles(positions, hd, cfg.rope_theta)
        kv = (apply_rope(k, sin, cos), v)
        a = attention(p["attn"], hn, cfg)
    h = h + a
    return h + _mlp(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg), kv


def _block_decode(p, h: torch.Tensor, cache, pos, cfg: ModelConfig):
    """One decode block.  ``cache`` is read-only; returns the new token's
    cache entries for the caller to write (append-merge decode)."""
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        a, n0, n1 = mla_decode(p["attn"], hn, cache[0], cache[1], pos, cfg)
    else:
        a, n0, n1 = attention_decode(p["attn"], hn, cache[0], cache[1],
                                     pos, cfg)
    h = h + a
    return h + _mlp(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg), (n0, n1)


class DecoderLM(Model):
    """Decoder-only transformer: standard attention or MLA, dense FFN or
    MoE after ``first_k_dense`` dense prefix blocks, and an optional
    vision frontend whose projected image tokens precede the text."""

    def init_tree(self, gen) -> Params:
        cfg, dt = self.cfg, _dtype(self.cfg)
        n_prefix = cfg.moe.first_k_dense if cfg.moe else 0
        p: Params = {
            "embed": (torch.randn((cfg.vocab_size, cfg.d_model),
                                  generator=gen, device=gen.device)
                      * 0.02).to(dt),
            "final_norm": full(gen, (cfg.d_model,), 0.0, dt),
            "layers": [_init_block(gen, cfg, dt)
                       for _ in range(cfg.num_layers - n_prefix)],
        }
        if n_prefix:
            p["prefix_layers"] = [
                _init_block(gen, cfg, dt, cfg.moe.dense_d_ff or cfg.d_ff)
                for _ in range(n_prefix)]
        if not cfg.tie_embeddings:
            p["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.d_model, dt)
        fe = cfg.frontend
        if fe:
            p["frontend_proj"] = {
                "w1": normal(gen, (fe.embed_dim, cfg.d_model), fe.embed_dim,
                             dt),
                "w2": normal(gen, (cfg.d_model, cfg.d_model), cfg.d_model,
                             dt)}
        return p

    def head(self, p=None) -> torch.Tensor:
        p = self if p is None else p
        return p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]

    def _prefix(self):
        return self.get("prefix_layers", [])

    def embed_input(self, batch: Batch, p=None) -> torch.Tensor:
        """Token embeddings, after the projected image tokens when the
        model has a frontend: gelu(frontend_embeds w1) w2.  ``p``: the
        parameters (the model's own by default)."""
        p = self if p is None else p
        h = _embed(p, self._tokens(batch))
        if self.cfg.frontend:
            fp = p["frontend_proj"]
            img = torch.as_tensor(batch["frontend_embeds"]).to(
                self.device, _dtype(self.cfg))
            img = dense(act_fn("gelu")(dense(img, fp["w1"]).float()).to(
                img.dtype), fp["w2"])
            h = torch.cat([img, h], dim=1)
        return h

    def train_loss(self, params: Params, batch: Batch):
        cfg = self.cfg
        h = self.embed_input(batch, params)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for lp in params.get("prefix_layers", []):
            h, a = _block_fwd(lp, h, cfg)
            aux = aux + a
        auxs = []
        for lp in self._layers(params, "layers"):
            h, a = _remat(cfg, _block_fwd, lp, h, cfg)
            auxs.append(a)
        aux = aux + torch.stack(auxs).sum()
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        if cfg.frontend:
            h = h[:, cfg.frontend.num_tokens:, :]
        loss = chunked_xent(h, self.head(params), batch["targets"],
                            batch.get("loss_mask"))
        total = loss + 0.01 * aux if cfg.moe else loss
        return total, {"xent": loss, "moe_aux": aux}

    def prefill(self, batch: Batch):
        cfg = self.cfg
        h = self.embed_input(batch)
        prefix_kv = []
        for lp in self._prefix():
            h, kv = _block_prefill(lp, h, cfg)
            prefix_kv.append(kv)
        ks, vs = [], []
        for lp in self["layers"]:
            h, (k, v) = _block_prefill(lp, h, cfg)
            ks.append(k)
            vs.append(v)
        h = rms_norm(h, self["final_norm"], cfg.norm_eps)
        logits = logits_last(h[:, -1, :], self.head())
        cache = {"kv": (torch.stack(ks), torch.stack(vs)),
                 "pos": _pos(h.shape[1] - 1)}
        if prefix_kv:
            cache["prefix_kv"] = prefix_kv
        return logits, cache

    def decode(self, cache, batch: Batch):
        """One token a row at absolute position ``pos`` (image tokens
        included)."""
        cfg = self.cfg
        h = _embed(self, self._tokens(batch))
        pos = int(batch["pos"])
        new_prefix = []
        for lp, kv in zip(self._prefix(), cache.get("prefix_kv", [])):
            h, (n0, n1) = _block_decode(lp, h, kv, pos, cfg)
            new_prefix.append((_update_at(kv[0], n0, pos, axis=1),
                               _update_at(kv[1], n1, pos, axis=1)))
        c0, c1 = cache["kv"]
        nks, nvs = [], []
        for i, lp in enumerate(self["layers"]):
            h, (n0, n1) = _block_decode(lp, h, (c0[i], c1[i]), pos, cfg)
            nks.append(n0)
            nvs.append(n1)
        ck = _update_at(c0, torch.stack(nks), pos, axis=2)
        cv = _update_at(c1, torch.stack(nvs), pos, axis=2)
        h = rms_norm(h, self["final_norm"], cfg.norm_eps)
        logits = logits_last(h[:, -1, :], self.head())
        new_cache = {"kv": (ck, cv), "pos": _pos(pos)}
        if new_prefix:
            new_cache["prefix_kv"] = new_prefix
        return logits, new_cache


# ------------------------------------------------------------ zamba2 (hybrid)
class ZambaLM(Model):
    """Mamba2 backbone with one shared attention block applied every
    ``hybrid_attn_every`` layers over concat(hidden, embedding)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__(cfg, device)
        self.shared_cfg = cfg.replace(
            num_heads=cfg.hybrid_attn_heads or cfg.num_heads)

    def init_tree(self, gen) -> Params:
        cfg, dt = self.cfg, _dtype(self.cfg)
        D = cfg.d_model
        return {
            "embed": (torch.randn((cfg.vocab_size, D), generator=gen,
                                  device=gen.device) * 0.02).to(dt),
            "layers": [{"ln": full(gen, (D,), 0.0, dt),
                        "mamba": ssm_mod.init_mamba2(gen, cfg, dt)}
                       for _ in range(cfg.num_layers)],
            "shared": {
                "ln1": full(gen, (2 * D,), 0.0, dt),
                "ln2": full(gen, (D,), 0.0, dt),
                "attn": init_attention(gen, self.shared_cfg, d_in=2 * D,
                                       dtype=dt),
                "ffn": init_ffn(gen, D, cfg.d_ff, dt)},
            "final_norm": full(gen, (D,), 0.0, dt),
            "lm_head": normal(gen, (D, cfg.vocab_size), D, dt),
        }

    def _shared_block(self, h, x0, sp=None):
        """The shared attention block over concat(h, x0), with the
        reference's bf16 gradient boundaries; ``sp``: its parameters (the
        model's own by default)."""
        sp = self["shared"] if sp is None else sp
        cfg = self.cfg
        z = torch.cat([h, x0], dim=-1)
        a = attention(sp["attn"], rms_norm(z, sp["ln1"], cfg.norm_eps),
                      self.shared_cfg, heads=self.shared_cfg.num_heads)
        h = bf16_grad(h + a)
        f = ffn(sp["ffn"], rms_norm(h, sp["ln2"], cfg.norm_eps),
                cfg.hidden_act)
        return bf16_grad(h + f)

    def _mamba_layer(self, lp, h):
        y = ssm_mod.mamba2_block(lp["mamba"],
                                 rms_norm(h, lp["ln"], self.cfg.norm_eps),
                                 self.cfg)
        return bf16_grad(h + y)

    def train_loss(self, params: Params, batch: Batch):
        cfg = self.cfg
        h = _embed(params, self._tokens(batch))
        x0 = h
        layers = self._layers(params, "layers")
        for i, j, shared in self._segments():
            if shared:
                h = self._shared_block(h, x0, params["shared"])
            for lp in layers[i:j]:
                h = _remat(cfg, self._mamba_layer, lp, h)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        loss = chunked_xent(h, params["lm_head"], batch["targets"],
                            batch.get("loss_mask"))
        return loss, {"xent": loss}

    def _shared_block_decode(self, h, x0, kv, pos):
        sp, cfg = self["shared"], self.cfg
        z = torch.cat([h, x0], dim=-1)
        a, k_new, v_new = attention_decode(
            sp["attn"], rms_norm(z, sp["ln1"], cfg.norm_eps), kv[0], kv[1],
            pos, self.shared_cfg, heads=self.shared_cfg.num_heads)
        h = h + a
        f = ffn(sp["ffn"], rms_norm(h, sp["ln2"], cfg.norm_eps),
                cfg.hidden_act)
        new_kv = (_update_at(kv[0], k_new, pos, axis=1),
                  _update_at(kv[1], v_new, pos, axis=1))
        return h + f, new_kv

    def _segments(self):
        """(start, end, shared block first?) over the layers."""
        L, every = self.cfg.num_layers, self.cfg.hybrid_attn_every
        i = 0
        while i < L:
            j = min(L, i + (every or L))
            yield i, j, bool(every) and i % every == 0
            i = j

    def prefill(self, batch: Batch):
        cfg = self.cfg
        h = _embed(self, self._tokens(batch))
        x0 = h
        B, S, _ = h.shape
        convs, ssds, shared_kv = [], [], []
        sp = self["shared"]
        for i, j, shared in self._segments():
            if shared:
                hn = rms_norm(torch.cat([h, x0], dim=-1), sp["ln1"],
                              cfg.norm_eps)
                KVh, hd = cfg.num_kv_heads, cfg.head_dim
                k = dense(hn, sp["attn"]["wk"]).reshape(B, S, KVh, hd)
                v = dense(hn, sp["attn"]["wv"]).reshape(B, S, KVh, hd)
                sin, cos = rope_angles(torch.arange(S, device=h.device), hd,
                                       cfg.rope_theta)
                shared_kv.append((apply_rope(k, sin, cos), v))
                h = self._shared_block(h, x0)
            for lp in self["layers"][i:j]:
                y, st, ct = ssm_mod.mamba2_block_with_state(
                    lp["mamba"], rms_norm(h, lp["ln"], cfg.norm_eps), cfg)
                h = h + y
                ssds.append(st)
                convs.append(ct)
        h = rms_norm(h, self["final_norm"], cfg.norm_eps)
        logits = logits_last(h[:, -1, :], self["lm_head"])
        return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds),
                        "shared_kv": shared_kv, "x0_last": x0[:, -1, :],
                        "pos": _pos(S - 1)}

    def decode(self, cache, batch: Batch):
        cfg = self.cfg
        h = _embed(self, self._tokens(batch))
        x0 = h
        pos = int(batch["pos"])
        new_conv, new_ssd, new_shared = [], [], []
        for i, j, shared in self._segments():
            if shared:
                h, kv2 = self._shared_block_decode(
                    h, x0, cache["shared_kv"][len(new_shared)], pos)
                new_shared.append(kv2)
            for li in range(i, j):
                lp = self["layers"][li]
                y, c2, s2 = ssm_mod.mamba2_decode(
                    lp["mamba"], rms_norm(h, lp["ln"], cfg.norm_eps),
                    cache["conv"][li], cache["ssd"][li], cfg)
                h = h + y
                new_conv.append(c2)
                new_ssd.append(s2)
        h = rms_norm(h, self["final_norm"], cfg.norm_eps)
        logits = logits_last(h[:, -1, :], self["lm_head"])
        return logits, {"conv": torch.stack(new_conv),
                        "ssd": torch.stack(new_ssd),
                        "shared_kv": new_shared, "x0_last": x0[:, -1, :],
                        "pos": _pos(pos)}


# --------------------------------------------------------------------- rwkv6
class RWKV6LM(Model):
    """RWKV6 (Finch): time mix + channel mix per layer, attention-free."""

    def init_tree(self, gen) -> Params:
        cfg, dt = self.cfg, _dtype(self.cfg)
        D = cfg.d_model
        return {
            "embed": (torch.randn((cfg.vocab_size, D), generator=gen,
                                  device=gen.device) * 0.02).to(dt),
            "ln0": full(gen, (D,), 0.0, dt),
            "layers": [{"ln1": full(gen, (D,), 0.0, dt),
                        "ln2": full(gen, (D,), 0.0, dt),
                        "mix": ssm_mod.init_rwkv6(gen, cfg, dt)}
                       for _ in range(cfg.num_layers)],
            "final_norm": full(gen, (D,), 0.0, dt),
            "lm_head": normal(gen, (D, cfg.vocab_size), D, dt),
        }

    def _layer(self, lp, h, s_att, s_wkv, s_chan):
        cfg = self.cfg
        a, sa2, sw2 = ssm_mod.rwkv6_time_mix(
            lp["mix"], rms_norm(h, lp["ln1"], cfg.norm_eps), s_att, s_wkv,
            cfg)
        h = h + a
        c, sc2 = ssm_mod.rwkv6_channel_mix(
            lp["mix"], rms_norm(h, lp["ln2"], cfg.norm_eps), s_chan)
        return h + c, sa2, sw2, sc2

    def _backbone(self, h, states):
        s_att, s_wkv, s_chan = states
        sa, sw, sc = [], [], []
        for i, lp in enumerate(self["layers"]):
            h, sa2, sw2, sc2 = self._layer(lp, h, s_att[i], s_wkv[i],
                                           s_chan[i])
            sa.append(sa2)
            sw.append(sw2)
            sc.append(sc2)
        return rms_norm(h, self["final_norm"], self.cfg.norm_eps), \
            (torch.stack(sa), torch.stack(sw), torch.stack(sc))

    def train_loss(self, params: Params, batch: Batch):
        cfg = self.cfg
        h = rms_norm(_embed(params, self._tokens(batch)), params["ln0"],
                     cfg.norm_eps)
        s_att, s_wkv, s_chan = self._zero_states(h.shape[0])
        for i, lp in enumerate(self._layers(params, "layers")):
            h = _remat(cfg, self._layer, lp, h, s_att[i], s_wkv[i],
                       s_chan[i])[0]
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        loss = chunked_xent(h, params["lm_head"], batch["targets"],
                            batch.get("loss_mask"))
        return loss, {"xent": loss}

    def _zero_states(self, B: int):
        cfg, dt = self.cfg, _dtype(self.cfg)
        L, H, N, D = cfg.num_layers, cfg.num_heads, cfg.ssm.head_dim, \
            cfg.d_model
        z = dict(device=self.device)
        return (torch.zeros((L, B, D), dtype=dt, **z),
                torch.zeros((L, B, H, N, N), dtype=torch.float32, **z),
                torch.zeros((L, B, D), dtype=dt, **z))

    def prefill(self, batch: Batch):
        tokens = self._tokens(batch)
        h = rms_norm(_embed(self, tokens), self["ln0"], self.cfg.norm_eps)
        h, (sa, sw, sc) = self._backbone(h, self._zero_states(h.shape[0]))
        logits = logits_last(h[:, -1, :], self["lm_head"])
        return logits, {"shift_att": sa, "wkv": sw, "shift_chan": sc,
                        "pos": _pos(tokens.shape[1] - 1)}

    def decode(self, cache, batch: Batch):
        h = rms_norm(_embed(self, self._tokens(batch)), self["ln0"],
                     self.cfg.norm_eps)
        h, (sa, sw, sc) = self._backbone(
            h, (cache["shift_att"], cache["wkv"], cache["shift_chan"]))
        logits = logits_last(h[:, -1, :], self["lm_head"])
        return logits, {"shift_att": sa, "wkv": sw, "shift_chan": sc,
                        "pos": _pos(int(cache["pos"]) + 1)}


# ----------------------------------------------------------- encoder-decoder
class EncDecLM(Model):
    """Encoder-decoder (seamless): a linear projection of the frames and
    ``num_encoder_layers`` non-causal blocks; decoder blocks of causal
    self-attention, cross-attention on the encoder output (no RoPE) and
    the FFN."""

    def init_tree(self, gen) -> Params:
        cfg, dt = self.cfg, _dtype(self.cfg)
        D, fe = cfg.d_model, cfg.frontend

        def enc_layer():
            return {"ln1": full(gen, (D,), 0.0, dt),
                    "ln2": full(gen, (D,), 0.0, dt),
                    "attn": init_attention(gen, cfg, dtype=dt),
                    "ffn": init_ffn(gen, D, cfg.d_ff, dt)}

        def dec_layer():
            return {"ln1": full(gen, (D,), 0.0, dt),
                    "ln2": full(gen, (D,), 0.0, dt),
                    "ln3": full(gen, (D,), 0.0, dt),
                    "self_attn": init_attention(gen, cfg, dtype=dt),
                    "cross_attn": init_attention(gen, cfg, dtype=dt),
                    "ffn": init_ffn(gen, D, cfg.d_ff, dt)}

        return {
            "embed": (torch.randn((cfg.vocab_size, D), generator=gen,
                                  device=gen.device) * 0.02).to(dt),
            "frontend_proj": normal(gen, (fe.embed_dim, D), fe.embed_dim,
                                    dt),
            "enc_layers": [enc_layer() for _ in
                           range(cfg.num_encoder_layers)],
            "enc_norm": full(gen, (D,), 0.0, dt),
            "dec_layers": [dec_layer() for _ in range(cfg.num_layers)],
            "final_norm": full(gen, (D,), 0.0, dt),
            "lm_head": normal(gen, (D, cfg.vocab_size), D, dt),
        }

    def _enc_layer(self, lp, h):
        cfg = self.cfg
        h = h + attention(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                          cfg, causal=False)
        return h + ffn(lp["ffn"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                       cfg.hidden_act)

    def encode(self, frames, params: Optional[Params] = None
               ) -> torch.Tensor:
        """The encoder's output; ``params`` in the reference's layout for
        training (the model's own by default)."""
        cfg = self.cfg
        p = self if params is None else params
        h = dense(torch.as_tensor(frames).to(self.device, _dtype(cfg)),
                  p["frontend_proj"])
        layers = self["enc_layers"] if params is None \
            else self._layers(params, "enc_layers")
        for lp in layers:
            h = _remat(cfg, self._enc_layer, lp, h)
        return rms_norm(h, p["enc_norm"], cfg.norm_eps)

    def _dec_block(self, lp, h, enc_out):
        cfg = self.cfg
        h = h + attention(lp["self_attn"], rms_norm(h, lp["ln1"],
                                                    cfg.norm_eps),
                          cfg, causal=True)
        h = h + attention(lp["cross_attn"], rms_norm(h, lp["ln2"],
                                                     cfg.norm_eps),
                          cfg, causal=False, kv_x=enc_out, use_rope=False)
        return h + ffn(lp["ffn"], rms_norm(h, lp["ln3"], cfg.norm_eps),
                       cfg.hidden_act)

    def train_loss(self, params: Params, batch: Batch):
        cfg = self.cfg
        enc_out = self.encode(batch["frames"], params)
        h = _embed(params, self._tokens(batch))
        for lp in self._layers(params, "dec_layers"):
            h = _remat(cfg, self._dec_block, lp, h, enc_out)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        loss = chunked_xent(h, params["lm_head"], batch["targets"],
                            batch.get("loss_mask"))
        return loss, {"xent": loss}

    def prefill(self, batch: Batch):
        """Cache: the decoder's self-attention K/V ``k``, ``v`` [L,B,S,KV,hd]
        and the encoder bank's cross-attention K/V ``xk``, ``xv``
        [L,B,T_enc,KV,hd]."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        h = _embed(self, self._tokens(batch))
        B, S, _ = h.shape
        Te = enc_out.shape[1]
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        sin, cos = rope_angles(torch.arange(S, device=h.device), hd,
                               cfg.rope_theta)
        ks, vs, xks, xvs = [], [], [], []
        for lp in self["dec_layers"]:
            hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
            ks.append(apply_rope(dense(hn, lp["self_attn"]["wk"]).reshape(
                B, S, KV, hd), sin, cos))
            vs.append(dense(hn, lp["self_attn"]["wv"]).reshape(B, S, KV, hd))
            xks.append(dense(enc_out, lp["cross_attn"]["wk"]).reshape(
                B, Te, KV, hd))
            xvs.append(dense(enc_out, lp["cross_attn"]["wv"]).reshape(
                B, Te, KV, hd))
            h = self._dec_block(lp, h, enc_out)
        h = rms_norm(h, self["final_norm"], cfg.norm_eps)
        logits = logits_last(h[:, -1, :], self["lm_head"])
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "xk": torch.stack(xks), "xv": torch.stack(xvs),
                        "pos": _pos(S - 1)}

    def decode(self, cache, batch: Batch):
        cfg = self.cfg
        h = _embed(self, self._tokens(batch))
        B = h.shape[0]
        pos = int(batch["pos"])
        H, hd = cfg.num_heads, cfg.head_dim
        nks, nvs = [], []
        for i, lp in enumerate(self["dec_layers"]):
            a, k_new, v_new = attention_decode(
                lp["self_attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                cache["k"][i], cache["v"][i], pos, cfg)
            h = h + a
            nks.append(k_new)
            nvs.append(v_new)
            # cross-attention over the whole encoder bank
            xk, xv = cache["xk"][i], cache["xv"][i]
            q = dense(rms_norm(h, lp["ln2"], cfg.norm_eps),
                      lp["cross_attn"]["wq"]).reshape(B, 1, H, hd)
            o = decode_attention(q, xk, xv, xk.shape[1] - 1)
            h = h + dense(o.reshape(B, 1, H * hd).to(h.dtype),
                          lp["cross_attn"]["wo"])
            h = h + ffn(lp["ffn"], rms_norm(h, lp["ln3"], cfg.norm_eps),
                        cfg.hidden_act)
        h = rms_norm(h, self["final_norm"], cfg.norm_eps)
        logits = logits_last(h[:, -1, :], self["lm_head"])
        return logits, {
            "k": _update_at(cache["k"], torch.stack(nks), pos, axis=2),
            "v": _update_at(cache["v"], torch.stack(nvs), pos, axis=2),
            "xk": cache["xk"], "xv": cache["xv"], "pos": _pos(pos)}
