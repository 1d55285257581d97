"""The port's whole smoke models and LM serving driver against the
reference package on the CPU: gemma-7b, zamba2-2.7b, rwkv6-3b,
qwen3-moe-30b-a3b (MoE), deepseek-v2-236b (MLA, MoE after a dense
prefix), llava-next-mistral-7b (vision frontend) and seamless-m4t-large-v2
(encoder-decoder), and a dense model with biases, on the same weights,
carried across by ``params_from_jax``, and ``launch/serve.py``'s pager and
driver.

Both packages take the same numpy inputs.  Outputs agree within ``rel`` = max |port - ref| /
max |ref| of each output: 1e-3 in fp32 (tests/test_models.py's metric) and
2e-2 in bf16, except zamba2 in bf16 (see ``BF16_REL``).  The attention and
scans run their plain versions here (the kernels run on the card)."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread, to_np  # noqa: E402,F401

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.lm import build_model as j_build  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import build_model, params_from_jax  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODELS = ["gemma-7b", "zamba2-2.7b", "rwkv6-3b", "qwen3-moe-30b-a3b",
          "deepseek-v2-236b", "llava-next-mistral-7b",
          "seamless-m4t-large-v2"]
# zamba2's smoke model in bf16 amplifies rounding: the reference disagrees
# with ITSELF by 0.027-0.063 (rel, prefill logits, token seeds 0-2) when
# only its attention blocks change from 32 to 16, the same function.  The
# fp32 comparison (1e-3) is the one that holds the function there.
BF16_REL = {"gemma-7b": 2e-2, "rwkv6-3b": 2e-2, "zamba2-2.7b": 0.1,
            "qwen3-moe-30b-a3b": 2e-2, "deepseek-v2-236b": 2e-2,
            "llava-next-mistral-7b": 2e-2, "seamless-m4t-large-v2": 2e-2}


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


# --------------------------------------------------------------- whole models
B, S = 2, 32
FRAMES = 24                    # the encoder bank: neither S - 1 nor S long


def inputs(cfg):
    """The prefill batch as numpy: tokens, and the image embeddings of a
    vision model or the frames of an encoder-decoder; and the number of
    image tokens before the text (decode positions count them)."""
    batch = {"tokens": np.random.RandomState(7).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)}
    rng = np.random.RandomState(11)
    fe = cfg.frontend
    if fe and fe.kind == "vision":
        batch["frontend_embeds"] = rng.randn(
            B, fe.num_tokens, fe.embed_dim).astype(np.float32)
        return batch, fe.num_tokens
    if cfg.encoder_decoder:
        batch["frames"] = rng.randn(B, FRAMES, fe.embed_dim).astype(
            np.float32)
    return batch, 0


def part(batch):
    """The batch with its last token cut off."""
    return dict(batch, tokens=batch["tokens"][:, :S - 1])


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grow(tree, t_old):
    """tests/test_models.py's pad: every cache time axis one slot longer."""
    def pad(a):
        if a.ndim >= 3 and a.dtype != jnp.int32:
            for ax in range(a.ndim):
                if a.shape[ax] == t_old:
                    pw = [(0, 0)] * a.ndim
                    pw[ax] = (0, 1)
                    return jnp.pad(a, pw)
        return a
    return jax.tree.map(pad, tree)


@functools.lru_cache(maxsize=None)
def reference_run(arch: str, dtype: str):
    """The reference's prefill of S tokens, its prefill of S - 1 and the
    decode of token S - 1 at position S - 1 (after the image tokens of a
    vision model; tests/test_models.py), on weights from PRNGKey(0), as
    numpy."""
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = j_build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    batch, n_img = inputs(cfg)
    toks = batch["tokens"]
    lg_full, c_full = jax.jit(model.prefill)(params, batch)
    lg_part, c_part = jax.jit(model.prefill)(params, part(batch))
    c_part = _grow(c_part, S - 1 + n_img)
    lg_dec, c_dec = jax.jit(model.decode)(
        params, c_part, {"tokens": toks[:, S - 1:],
                         "pos": jnp.int32(S - 1 + n_img)})
    return dict(params=jnp_np(params), toks=toks, batch=batch, n_img=n_img,
                full=(np.asarray(lg_full), c_full),
                part=(np.asarray(lg_part), c_part),
                dec=(np.asarray(lg_dec), c_dec))


def _port_model(arch, dtype, ref):
    cfg = t_smoke(arch).replace(dtype=dtype)
    return build_model(cfg, "cpu").load_params(
        params_from_jax(cfg, ref["params"]))


def _assert_cache(port, ref, tol):
    pl, pdef = tserve.tree_flatten(port)
    rl, rdef = jax.tree.flatten(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        assert tuple(p.shape) == r.shape
        if jnp.issubdtype(r.dtype, jnp.floating):
            assert rel(p, r) < tol
        else:
            assert int(p) == int(r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODELS)
def test_model_matches_reference(arch, dtype):
    """Prefill logits and every cache leaf (in ``jax.tree.flatten``'s
    order), then decode logits and cache, on the reference's weights."""
    ref = reference_run(arch, dtype)
    tol = 1e-3 if dtype == "float32" else BF16_REL[arch]
    model = _port_model(arch, dtype, ref)
    logits, cache = model.prefill(torch_batch(ref["batch"]))
    assert logits.dtype == torch.float32
    assert rel(logits, ref["full"][0]) < tol
    _assert_cache(cache, ref["full"][1], tol)
    dec_logits, dec_cache = model.decode(
        to_torch_tree(ref["part"][1]),
        {"tokens": torch.from_numpy(ref["toks"][:, S - 1:]),
         "pos": S - 1 + ref["n_img"]})
    assert rel(dec_logits, ref["dec"][0]) < tol
    _assert_cache(dec_cache, ref["dec"][1], tol)


def test_dense_model_with_biases_matches_reference():
    ref = reference_run("qwen2.5-32b", "float32")
    model = _port_model("qwen2.5-32b", "float32", ref)
    logits, cache = model.prefill({"tokens": torch.from_numpy(ref["toks"])})
    assert rel(logits, ref["full"][0]) < 1e-3
    _assert_cache(cache, ref["full"][1], 1e-3)


def test_params_keep_reference_names_and_layouts():
    ref = reference_run("zamba2-2.7b", "float32")
    model = _port_model("zamba2-2.7b", "float32", ref)
    names = dict(model.named_parameters())
    jp = ref["params"]
    assert names["layers.1.mamba.w_x"].shape == jp["layers"]["mamba"]["w_x"] \
        .shape[1:]
    np.testing.assert_array_equal(names["layers.1.mamba.w_x"].numpy(),
                                  jp["layers"]["mamba"]["w_x"][1])
    np.testing.assert_array_equal(names["shared.attn.wq"].numpy(),
                                  jp["shared"]["attn"]["wq"])


# -------------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", MODELS)
def test_state_pager_pages_bit_equal_to_reference(arch):
    """The reference pager's pages of a grown bf16 prefill cache equal the
    port pager's pages of the same cache bit for bit, and ``from_pages``
    rebuilds the cache exactly (MLA's rank-4 latents and the dense
    prefix's list among them)."""
    ref = reference_run(arch, "bfloat16")
    t = S + ref["n_img"]
    jcache = jserve._grow_kv(ref["full"][1], t, t + 6)
    tcache = tserve._grow_kv(to_torch_tree(ref["full"][1]), t, t + 6)
    jpager = jserve.StatePager(jcache, 4096)
    tpager = tserve.StatePager(tcache, 4096)
    assert (tpager.n_pages, tpager.total) == (jpager.n_pages, jpager.total)
    jpages, jaux = jpager.to_pages(jcache)
    tpages, taux = tpager.to_pages(tcache)
    np.testing.assert_array_equal(tpages.numpy(), np.asarray(jpages))
    assert [int(a) for a in taux] == [int(a) for a in jaux]
    back = tpager.from_pages(tpages, taux)
    for a, b in zip(tserve.tree_flatten(back)[0],
                    tserve.tree_flatten(tcache)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(tserve.page_keys(3, 5),
                                  jserve.page_keys(3, 5))


@pytest.mark.parametrize("arch,prompt_len", [("gemma-7b", 16),
                                             ("zamba2-2.7b", 32),
                                             ("rwkv6-3b", 32),
                                             ("qwen3-moe-30b-a3b", 32),
                                             ("deepseek-v2-236b", 32)])
def test_run_serving_prefetch_beats_sync(arch, prompt_len):
    """tests/test_system.py's serving config through the port's driver on
    the CPU: every request served, prefetch overlaps staging and lowers
    p99 TTFT.  zamba2 and rwkv6 take 32-token prompts: at 16 the
    reference's ``_grow_kv`` pads their 16-wide state axes as if they were
    time (ROADMAP.md §3); the MoE models take 32 too, and deepseek-v2's
    pages carry MLA's latent cache and its dense prefix's."""
    cfg = tserve.ServeConfig(arch=arch, n_sessions=12, n_requests=24,
                             prompt_len=prompt_len, decode_tokens=2,
                             store_latency=0.03, cache_sessions=6,
                             arrival_rate=500.0)
    base = tserve.run_serving(cfg, "sync", device="cpu")
    kp = tserve.run_serving(cfg, "prefetch", device="cpu")
    assert base["n_tokens"] == kp["n_tokens"] == 24 * 2
    assert kp["staging_overlap"] > base["staging_overlap"]
    assert kp["ttft_p99"] < base["ttft_p99"]


@pytest.mark.parametrize("arch,n_calls", [("zamba2-2.7b", 6),
                                          ("rwkv6-3b", 2),
                                          ("qwen3-moe-30b-a3b", 4),
                                          ("deepseek-v2-236b", 5),
                                          ("llava-next-mistral-7b", 2),
                                          ("seamless-m4t-large-v2", 6)])
def test_smoke_layer_witness_records_each_kernel_layer(arch, n_calls):
    """``chip_smoke.recorded_prefill``, the models phase's bf16 witness:
    it records every call of the layers that run K6-K8, and of the MoE
    layers, in one prefill (zamba2's smoke model: two shared-attention
    calls and four Mamba2 blocks; rwkv6's: two time mixes; qwen3-moe's:
    two attentions and two MoE layers; deepseek-v2's: the dense prefix's
    and two MoE layers' MLA, and those two MoE layers; seamless's: two
    encoder, two self- and two cross-attentions), leaves the model's logits as they were, puts the
    functions back, and ``layer_rels`` reruns each call on the CPU from
    its recorded inputs: equal here, where both runs are the same."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import WITNESS, layer_rels, lm_batch, recorded_prefill
    cfg = t_smoke(arch).replace(dtype="bfloat16")
    model = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 64)).astype(np.int32))
    batch = dict(lm_batch(cfg, 1, 64, seed=3, frames=40)[0], tokens=toks)
    before = [getattr(mod, name) for mod, name in WITNESS[arch]]
    logits, _, calls = recorded_prefill(model, batch, WITNESS[arch])
    assert [getattr(mod, name) for mod, name in WITNESS[arch]] == before
    assert len(calls) == n_calls
    assert torch.equal(logits, model.prefill(batch)[0])
    assert layer_rels(calls) == [0.0] * n_calls
