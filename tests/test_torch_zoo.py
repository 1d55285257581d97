"""The rest of the model zoo against the reference package on the CPU: the
MLA and MoE layers, the vision frontend's embedding, an encoder block and
the cross-attention decode of the encoder-decoder, each on the
reference's initialised parameters and the same numpy inputs; the MoE
routing bit for bit; and flash attention (K6) at the ``(d, dv)`` pairs
the zoo reaches, its plain version against the Pallas kernel in interpret
mode.  Whole smoke models: tests/test_torch_lm.py."""
import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import assert_close, one_thread, to_np, tol  # noqa: E402,F401

from repro.configs import get_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.lm import build_model as j_build  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as tfa_mod  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.lm import build_model, params_from_jax  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _x(shape, dtype, seed=0, scale=1.0):
    a = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _params(cfg, jtree):
    return params_from_jax(cfg, jax.tree.map(np.asarray, jtree))


def _smoke(arch, dtype="float32", **moe):
    jcfg, tcfg = (get_smoke_config(arch).replace(dtype=dtype),
                  t_smoke(arch).replace(dtype=dtype))
    if moe:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("S,T,H,KV,d,dv,bq,bk,causal", [
    (64, 64, 8, 2, 24, 16, 32, 32, True),     # deepseek-v2 smoke MLA
    (64, 64, 8, 2, 8, 8, 32, 16, True),       # command-r / qwen2.5 smoke
    (64, 64, 4, 4, 192, 128, 32, 32, True),   # deepseek-v2 MLA, narrow
    (64, 64, 4, 4, 192, 128, 64, 32, False),
    (32, 48, 4, 4, 16, 16, 16, 16, False),    # cross-attention, S != T
    (48, 32, 4, 2, 24, 16, 16, 32, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_pairs_match_reference_kernel(S, T, H, KV, d, dv, bq,
                                                      bk, causal, dtype):
    """The kernel's plain version at the zoo's other (d, dv) pairs and at
    S != T against the Pallas kernel (interpret mode) behind the
    reference's GQA wrapper."""
    rng = np.random.RandomState(3)
    arrays = [rng.randn(2, S, H, d).astype(np.float32),
              rng.randn(2, T, KV, d).astype(np.float32),
              rng.randn(2, T, KV, dv).astype(np.float32)]
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    ref = j_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk)
    out = tfa_mod.flash_attention_kernel(tq, tk, tv, causal)
    assert out.dtype == tdt and out.shape == (2, S, H, dv)
    assert_close(to_np(out), ref, dtype)


def _config_pairs(cfg):
    """The (d, dv) a config's attention reaches (none for rwkv6)."""
    if cfg.ssm and cfg.ssm.kind == "rwkv6":
        return set()
    if cfg.mla:
        m = cfg.mla
        return {(m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)}
    return {(cfg.head_dim, cfg.head_dim)}


def test_every_registry_head_dim_pair_is_instantiated(monkeypatch):
    """Every (d, dv) of the registry's full and smoke configs is among the
    kernel's instantiated pairs, and the wrapper's list is the CUDA
    source's FLASH_PAIRS: every pair the zoo reaches runs on an instance
    of its own, unpadded (``cover_pair`` is the pair itself).
    card.  The smoke models' prefills are also run, recording every call
    of the kernel's wrapper."""
    src = (tfa_mod.cuda_build.CSRC / "flash_attention.cu").read_text()
    block = re.search(r"#define FLASH_PAIRS\(X\)(.*?)\n\n", src, re.S)
    cuda_pairs = {(int(a), int(b)) for a, b in
                  re.findall(r"X\((\d+), (\d+)\)", block.group(1))}
    assert cuda_pairs == set(tfa_mod.PAIRS)
    want = set()
    for arch in ARCH_IDS:
        want |= _config_pairs(get_config(arch)) | _config_pairs(
            t_smoke(arch))
    assert want <= set(tfa_mod.PAIRS)
    assert all(tfa_mod.cover_pair(*p) == p for p in want)
    assert {(24, 16), (192, 128), (8, 8)} <= want
    seen = set()
    kernel = tfa_mod.flash_attention_kernel

    def record(q, k, v, causal=True):
        seen.add((q.shape[-1], v.shape[-1]))
        return kernel(q, k, v, causal)

    monkeypatch.setattr(tl, "flash_attention_kernel", record)
    for arch in ARCH_IDS:
        cfg = t_smoke(arch).replace(dtype="float32")
        model = build_model(cfg, "cpu").init_params(
            torch.Generator().manual_seed(0))
        model.prefill(_batch(cfg, 1, 8))
    assert seen <= set(tfa_mod.PAIRS)
    assert seen == {p for a in ARCH_IDS for p in _config_pairs(t_smoke(a))}


def test_flash_attention_plain_version_takes_pairs_outside_the_kernel():
    """On the CPU any (d, dv) runs the plain version; on the card a pair
    outside ``PAIRS`` with d, dv <= 256 runs on the covering instance,
    padded (meta tensors take the card's path without a card), one past
    256 on the wide kernel, unpadded, and only a width below 1 is
    refused."""
    q = torch.zeros((1, 4, 2, 48))
    out = tfa_mod.flash_attention_kernel(q, q, torch.zeros((1, 4, 2, 40)))
    assert out.shape == (1, 4, 2, 40)
    assert (48, 40) not in tfa_mod.PAIRS
    assert tfa_mod.cover_pair(48, 40) == (64, 64)
    qm = q.to("meta")
    out = tfa_mod.flash_attention_kernel(qm, qm, torch.zeros(
        (1, 4, 2, 40), device="meta"))
    assert out.shape == (1, 4, 2, 40) and out.device.type == "meta"
    big = torch.zeros((1, 4, 2, 264), device="meta")
    out = tfa_mod.flash_attention_kernel(big, big, torch.zeros(
        (1, 4, 2, 64), device="meta"))
    assert out.shape == (1, 4, 2, 64) and tfa_mod.cover_pair(264, 64) is None
    empty = torch.zeros((1, 4, 2, 0), device="meta")
    with pytest.raises(ValueError, match=">= 1"):
        tfa_mod.flash_attention_kernel(empty, empty, empty)


# ------------------------------------------------------------------------ MLA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_and_decode_match_reference(dtype):
    jcfg, tcfg = _smoke("deepseek-v2-236b", dtype)
    jp = jl.init_mla(jax.random.PRNGKey(4), jcfg, DTYPES[dtype][0])
    jp["q_norm"] = jp["q_norm"] + 0.2
    tp = _params(tcfg, jp)
    jx, tx = _x((2, 24, jcfg.d_model), dtype)
    assert_close(to_np(tl.mla_attention(tp, tx, tcfg)),
                 jax.jit(jl.mla_attention, static_argnums=2)(jp, jx, jcfg),
                 dtype)
    m = jcfg.mla
    T, pos = 16, 11
    jck, tck = _x((2, T, m.kv_lora_rank), dtype, seed=5)
    jkr, tkr = _x((2, T, m.qk_rope_head_dim), dtype, seed=6)
    ref = jax.jit(jl.mla_decode, static_argnums=5)(
        jp, jx[:, :1], jck, jkr, jnp.int32(pos), jcfg)
    out = tl.mla_decode(tp, tx[:, :1], tck, tkr, pos, tcfg)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        assert_close(to_np(o), r, dtype)


# ------------------------------------------------------------------------ MoE
def _j_route(jp, jx, jcfg):
    """The reference's routing lines of ``moe_ffn`` (layers.py:456-469)."""
    mo = jcfg.moe
    B, S, _ = jx.shape
    E, K = mo.num_experts, mo.num_experts_per_tok
    C = max(1, int(np.ceil(K * S / E * mo.capacity_factor)))
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jx.astype(jnp.float32),
                                      jp["router"]), axis=-1)
    gates, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot.reshape(B, S * K, E), axis=1) - 1
    pos = (pos_all.reshape(B, S, K, E) * onehot).sum(-1)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < C)


@pytest.mark.parametrize("capacity_factor", [1.5, 16.0])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_routing_bit_equal_to_reference(arch, capacity_factor):
    """idx, pos and keep of every choice equal the reference's bit for bit
    in fp32, with choices dropped (the smoke configs' 1.5) and without
    (16); 1.5 drops some here."""
    jcfg, tcfg = _smoke(arch, capacity_factor=capacity_factor)
    jp = jl.init_moe(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = _params(tcfg, jp)
    jx, tx = _x((3, 40, jcfg.d_model), "float32", seed=2)
    idx, pos, keep = _j_route(jp, jx, jcfg)
    _, gates, t_idx, t_pos, t_keep = tl.moe_route(tp, tx, tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert bool((gates[~t_keep] == 0).all())
    assert (not keep.all()) == (capacity_factor == 1.5)


def test_moe_routing_breaks_ties_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index first, as
    ``lax.top_k`` does (no choice dropped at this capacity)."""
    _, tcfg = _smoke("qwen3-moe-30b-a3b", capacity_factor=16.0)
    E = tcfg.moe.num_experts
    router = torch.zeros((tcfg.d_model, E))
    router[0, 5] = router[0, 2] = 1.0                   # a tie, 2 and 5
    _, gates, idx, _, _ = tl.moe_route({"router": router},
                                       torch.ones((1, 3, tcfg.d_model)), tcfg)
    assert idx[0, :, :2].tolist() == [[2, 5]] * 3
    assert torch.allclose(gates[0, :, :2], torch.full((3, 2), 0.5))


@pytest.mark.parametrize("capacity_factor", [1.5, 16.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_moe_ffn_matches_reference(arch, dtype, capacity_factor):
    """The layer's output and aux loss (deepseek-v2's with its shared
    expert).  The reference rounds each expert product to bf16 whatever
    the input type (``preferred_element_type=bfloat16``), so in fp32 a sum
    taken in another order can land one bf16 step away: the output is
    held within the bf16 tolerance, and all but two of its 5120 elements
    within fp32's (over 40 draws of weights and inputs, each fp32 case had
    at most one element outside it)."""
    jcfg, tcfg = _smoke(arch, dtype, capacity_factor=capacity_factor)
    jp = jl.init_moe(jax.random.PRNGKey(6), jcfg, DTYPES[dtype][0])
    tp = _params(tcfg, jp)
    jx, tx = _x((2, 40, jcfg.d_model), dtype, seed=3)
    ref_y, ref_aux = jax.jit(jl.moe_ffn, static_argnums=2)(jp, jx, jcfg)
    y, aux = tl.moe_ffn(tp, tx, tcfg)
    assert y.dtype == tx.dtype and y.shape == ref_y.shape
    assert_close(to_np(y), ref_y, "bfloat16")
    ref = np.asarray(ref_y, np.float32)
    t = tol(dtype)
    off = np.abs(to_np(y) - ref) > t + t * np.abs(ref)
    assert off.size == 5120 and off.sum() <= 2
    assert_close(aux.numpy(), ref_aux)


# ---------------------------------------------- vision frontend, enc-dec parts
def _batch(cfg, B, S, seed=0):
    """Tokens and the vision or encoder inputs of ``cfg`` as tensors (an
    encoder bank of S - 3 frames, never the prompt's length)."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    fe = cfg.frontend
    if fe and fe.kind == "vision":
        batch["frontend_embeds"] = torch.from_numpy(
            rng.randn(B, fe.num_tokens, fe.embed_dim).astype(np.float32))
    if cfg.encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.randn(B, S - 3, fe.embed_dim).astype(np.float32))
    return batch


def _reference_model(arch, dtype):
    jcfg, tcfg = _smoke(arch, dtype)
    jm = j_build(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(tcfg, "cpu").load_params(
        params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_embedding_matches_reference(dtype):
    """The projected image tokens before the token embeddings: the first
    layer's input, as the reference's ``embed_input`` builds it."""
    jcfg, jp, tm = _reference_model("llava-next-mistral-7b", dtype)
    batch = _batch(tm.cfg, 2, 12)
    jdt = DTYPES[dtype][0]
    fp = jp["frontend_proj"]
    img = jl.dense(jax.nn.gelu(jl.dense(
        jnp.asarray(batch["frontend_embeds"].numpy()).astype(jdt),
        fp["w1"])), fp["w2"])
    ref = jnp.concatenate([img, jnp.take(jp["embed"], jnp.asarray(
        batch["tokens"].numpy()), axis=0)], axis=1)
    out = tm.embed_input(batch)
    assert out.shape == ref.shape == (2, jcfg.frontend.num_tokens + 12,
                                      jcfg.d_model)
    assert_close(to_np(out), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_block_and_cross_attention_decode_match_reference(dtype):
    """One encoder block (non-causal attention, FFN) of the reference's
    ``encode``, and the decoder's cross-attention decode over the whole
    encoder bank (``decode_attention`` at T_enc - 1, no new token)."""
    jcfg, tcfg = _smoke("seamless-m4t-large-v2", dtype)
    jdt = DTYPES[dtype][0]
    jp = jl.init_attention(jax.random.PRNGKey(7), jcfg, dtype=jdt)
    jf = jl.init_ffn(jax.random.PRNGKey(8), jcfg.d_model, jcfg.d_ff, jdt)
    tp, tf = _params(tcfg, jp), _params(tcfg, jf)
    jx, tx = _x((2, 21, jcfg.d_model), dtype)

    def j_block(p, f, h):
        h = h + jl.attention(p, jl.rms_norm(h, jnp.zeros_like(h[0, 0])),
                             jcfg, causal=False)
        return h + jl.ffn(f, jl.rms_norm(h, jnp.zeros_like(h[0, 0])),
                          jcfg.hidden_act)

    zero = torch.zeros(tcfg.d_model, dtype=tx.dtype)
    h = tx + tl.attention(tp, tl.rms_norm(tx, zero), tcfg, causal=False)
    h = h + tl.ffn(tf, tl.rms_norm(h, zero), tcfg.hidden_act)
    assert_close(to_np(h), jax.jit(j_block)(jp, jf, jx), dtype)
    H, KV, hd = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    jq, tq = _x((2, 1, H, hd), dtype, seed=1)
    jk, tk = _x((2, 21, KV, hd), dtype, seed=2)
    jv, tv = _x((2, 21, KV, hd), dtype, seed=3)
    ref = jl.decode_attention(jq, jk, jv, jnp.int32(20))
    assert_close(to_np(tl.decode_attention(tq, tk, tv, 20)), ref, dtype)


def test_params_from_jax_unstacks_by_the_reference_stacks():
    """deepseek-v2 stacks the layers after its dense prefix and keeps the
    prefix as a list; the encoder-decoder stacks encoder and decoder."""
    _, jp, tm = _reference_model("deepseek-v2-236b", "float32")
    cfg = tm.cfg
    assert len(tm["layers"]) == cfg.num_layers - cfg.moe.first_k_dense
    assert len(tm["prefix_layers"]) == cfg.moe.first_k_dense
    np.testing.assert_array_equal(
        tm["layers"][1]["moe"]["w_up"].numpy(),
        np.asarray(jp["layers"]["moe"]["w_up"][1]))
    np.testing.assert_array_equal(
        tm["prefix_layers"][0]["ffn"]["w_down"].numpy(),
        np.asarray(jp["prefix_layers"][0]["ffn"]["w_down"]))
    _, jp, tm = _reference_model("seamless-m4t-large-v2", "float32")
    assert (len(tm["enc_layers"]), len(tm["dec_layers"])) == \
        (tm.cfg.num_encoder_layers, tm.cfg.num_layers)
    np.testing.assert_array_equal(
        tm["dec_layers"][1]["cross_attn"]["wk"].numpy(),
        np.asarray(jp["dec_layers"]["cross_attn"]["wk"][1]))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(cfg.replace(num_layers=5),
                        jax.tree.map(np.asarray, j_build(
                            get_smoke_config("deepseek-v2-236b")).init_params(
                                jax.random.PRNGKey(0))))


def test_build_model_picks_the_reference_builder():
    assert isinstance(build_model(t_smoke("seamless-m4t-large-v2"), "cpu"),
                      tlm.EncDecLM)
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-236b",
                 "llava-next-mistral-7b"):
        assert isinstance(build_model(t_smoke(arch), "cpu"), tlm.DecoderLM)
