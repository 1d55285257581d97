"""The port's model layers against the reference package on the CPU (every
layer of the dense, Mamba2 and RWKV6 families, on the same numpy inputs
and the reference's initialised parameters; MLA, MoE and the
encoder-decoder's in tests/test_torch_zoo.py), and the port's model
invariants: parameter counts and prefill/decode consistency.  Layers agree
within the reference's ``_tol``; the attention and scans run their plain
versions here (the kernels run on the card).  Whole models:
tests/test_torch_lm.py."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import assert_close, one_thread, to_np  # noqa: E402,F401

from repro.configs import count_params, get_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.lm import build_model, params_from_jax  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODELS = ["gemma-7b", "zamba2-2.7b", "rwkv6-3b", "qwen3-moe-30b-a3b",
          "deepseek-v2-236b", "llava-next-mistral-7b",
          "seamless-m4t-large-v2"]


def rel(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    port = to_np(port) if isinstance(port, torch.Tensor) else port
    return float(np.abs(port - ref).max() / (np.abs(ref).max() + 1e-9))


def jnp_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch_tree(tree):
    """A reference pytree (dicts, tuples, lists of arrays) as the same
    structure of CPU tensors; int32 scalars stay int32."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch_tree(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _x(shape, dtype, seed=0, scale=1.0):
    a = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _params(cfg, jtree):
    """One layer's reference parameters as the port's tree (no stacked
    ``layers``, so converted as they are)."""
    return params_from_jax(cfg, jnp_np(jtree))


# --------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    jx, tx = _x((2, 5, 64), dtype)
    js, ts = _x((64,), dtype, seed=1, scale=0.1)
    assert_close(to_np(tl.rms_norm(tx, ts, 1e-6)),
                 jl.rms_norm(jx, js, 1e-6), dtype)


def test_rope_matches_reference():
    pos = np.arange(7) * 3
    js, jc = jl.rope_angles(jnp.asarray(pos), 16, 10000.0)
    ts, tc = tl.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    assert_close(ts.numpy(), js)
    assert_close(tc.numpy(), jc)
    jx, tx = _x((2, 7, 4, 16), "float32")
    assert_close(tl.apply_rope(tx, ts, tc).numpy(), jl.apply_rope(jx, js, jc))


@pytest.mark.parametrize("S,causal,impl", [(64, True, "masked"),
                                           (64, True, "balanced"),
                                           (45, True, "masked"),
                                           (45, False, "masked")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_attention_matches_reference(S, causal, impl, dtype):
    """Masked and balanced (the reference's two tilings of the one function
    the port computes), and S = 45, which the reference pads to its
    16-blocks and the port's kernel takes as it is."""
    jq, tq = _x((2, S, 4, 16), dtype)
    jk, tk = _x((2, S, 2, 16), dtype, seed=1)
    jv, tv = _x((2, S, 2, 16), dtype, seed=2)
    ref = jl.blocked_attention(jq, jk, jv, causal=causal, q_block=16,
                               kv_block=16, impl=impl)
    out = tl.blocked_attention(tq, tk, tv, causal=causal)
    assert out.shape == ref.shape
    assert_close(to_np(out), ref, dtype)


def _smoke(arch, dtype="float32"):
    return get_smoke_config(arch).replace(dtype=dtype), \
        t_smoke(arch).replace(dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_and_decode_match_reference(dtype):
    jcfg, tcfg = _smoke("qwen2.5-32b")                 # qkv bias, GQA
    jdt = DTYPES[dtype][0]
    jp = jl.init_attention(jax.random.PRNGKey(0), jcfg, dtype=jdt)
    jp["bq"] = jp["bq"] + 0.1                          # nonzero biases
    tp = _params(tcfg, jp)
    jx, tx = _x((2, 12, jcfg.d_model), dtype)
    assert_close(to_np(tl.attention(tp, tx, tcfg)),
                 jax.jit(jl.attention, static_argnums=2)(jp, jx, jcfg),
                 dtype)
    T, pos = 16, 9
    KV, hd = jcfg.num_kv_heads, jcfg.head_dim
    jck, tck = _x((2, T, KV, hd), dtype, seed=3)
    jcv, tcv = _x((2, T, KV, hd), dtype, seed=4)
    ref = jax.jit(jl.attention_decode, static_argnums=5)(
        jp, jx[:, :1], jck, jcv, jnp.int32(pos), jcfg)
    out = tl.attention_decode(tp, tx[:, :1], tck, tcv, pos, tcfg)
    for o, r in zip(out, ref):
        assert_close(to_np(o), r, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches_reference(dtype):
    jp = jl.init_ffn(jax.random.PRNGKey(1), 64, 128, DTYPES[dtype][0])
    jx, tx = _x((2, 5, 64), dtype)
    tp = _params(t_smoke("gemma-7b"), jp)
    for act in ("silu", "gelu"):
        assert_close(to_np(tl.ffn(tp, tx, act)),
                     jl.ffn(jp, jx, act), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_and_decode_match_reference(dtype):
    jcfg, tcfg = _smoke("zamba2-2.7b", dtype)
    jp = jssm.init_mamba2(jax.random.PRNGKey(2), jcfg, DTYPES[dtype][0])
    jp["A_log"] = jp["A_log"] + 0.3                    # decays other than 1
    tp = _params(tcfg, jp)
    jx, tx = _x((2, 64, jcfg.d_model), dtype)
    ref = jax.jit(jssm.mamba2_block_with_state, static_argnums=2)(
        jp, jx, jcfg)
    out = tssm.mamba2_block_with_state(tp, tx, tcfg)
    for o, r in zip(out, ref):                         # y, state, conv tail
        assert o.shape == r.shape
        assert_close(to_np(o), r, dtype)
    ref = jax.jit(jssm.mamba2_decode, static_argnums=4)(
        jp, jx[:, :1], ref[2], ref[1], jcfg)
    out = tssm.mamba2_decode(tp, tx[:, :1], out[2], out[1], tcfg)
    for o, r in zip(out, ref):
        assert_close(to_np(o), r, dtype)


@pytest.mark.parametrize("S", [64, 45, 200, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_time_and_channel_mix_match_reference(S, dtype):
    """From nonzero shift and wkv states.  The reference takes its chunked
    closed form at S = 64 and steps one token at a time at S = 45, 200 (no
    multiple of its chunk) and 1 (decode); the port runs its scan kernel at
    every length."""
    jcfg, tcfg = _smoke("rwkv6-3b", dtype)
    jp = jssm.init_rwkv6(jax.random.PRNGKey(3), jcfg, DTYPES[dtype][0])
    jp["u"] = jp["u"] + 0.2
    tp = _params(tcfg, jp)
    D, H, N = jcfg.d_model, jcfg.num_heads, jcfg.ssm.head_dim
    jx, tx = _x((2, S, D), dtype)
    jsh, tsh = _x((2, D), dtype, seed=5)
    jw, tw = _x((2, H, N, N), "float32", seed=6, scale=0.3)
    ref = jax.jit(jssm.rwkv6_time_mix, static_argnums=4)(
        jp, jx, jsh, jw, jcfg)
    out = tssm.rwkv6_time_mix(tp, tx, tsh, tw, tcfg)
    for o, r in zip(out, ref):
        assert o.dtype == DTYPES[str(r.dtype)][1]
        assert_close(to_np(o), r, dtype)
    ref = jax.jit(jssm.rwkv6_channel_mix)(jp, jx, jsh)
    out = tssm.rwkv6_channel_mix(tp, tx, tsh)
    for o, r in zip(out, ref):
        assert_close(to_np(o), r, dtype)


# ----------------------------------------------------------- model invariants
B, S = 2, 32


@pytest.mark.parametrize("arch", MODELS)
def test_port_prefill_decode_consistency(arch):
    """decode(prefill(x[:-1]), x[-1]) agrees with prefill(x) in the port
    alone (tests/test_models.py's check, fp32, rel < 1e-3, MoE without
    capacity drops; the same image embeddings or encoder frames on both
    sides, the frames neither S - 1 nor S long), on weights of the port's
    own generator."""
    cfg = t_smoke(arch).replace(dtype="float32")
    if cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=16.0))
    model = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(8)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32))
    extra, n_img, fe = {}, 0, cfg.frontend
    if fe and fe.kind == "vision":
        n_img = fe.num_tokens
        extra["frontend_embeds"] = torch.from_numpy(rng.randn(
            B, n_img, fe.embed_dim).astype(np.float32))
    if cfg.encoder_decoder:
        extra["frames"] = torch.from_numpy(rng.randn(
            B, S - 8, fe.embed_dim).astype(np.float32))
    lg_full, _ = model.prefill({"tokens": toks, **extra})
    _, cache = model.prefill({"tokens": toks[:, :S - 1], **extra})
    t_old = S - 1 + n_img
    cache = tserve._grow_kv(cache, t_old, t_old + 1)
    lg_dec, new_cache = model.decode(cache, {"tokens": toks[:, S - 1:],
                                             "pos": t_old})
    assert rel(lg_dec, lg_full.numpy()) < 1e-3
    assert int(new_cache["pos"]) == t_old


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_analytic_or_raises(arch):
    """Every architecture of the registry builds and holds exactly
    ``count_params(cfg)`` parameters."""
    cfg = t_smoke(arch)
    model = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == count_params(cfg)
