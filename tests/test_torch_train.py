"""The port's training path against the reference package on the CPU: the
data pipeline bit for bit, AdamW, the int8 gradient compressor, every
architecture's ``train_loss`` and its gradient, the train step with and
without microbatches, the supervisor's failure-and-restart run, training
checkpoints across the two packages, and K6's plain backward.  Each holds
the port against the JAX package on the reference's initialised
parameters and seeded numpy inputs."""
import dataclasses
import math
import os
import re
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread, to_np  # noqa: E402,F401

from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro.runtime.supervisor import SupervisorConfig as JSupCfg  # noqa: E402
from repro.runtime.supervisor import TrainSupervisor as JSup  # noqa: E402
from repro.runtime.supervisor import \
    inject_failure_at as j_inject  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as tfa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import build_training  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import compression as tcomp  # noqa: E402
from repro_torch.runtime.supervisor import (SupervisorConfig,  # noqa: E402
                                            TrainSupervisor,
                                            inject_failure_at)

MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-236b")


def to_torch(tree):
    """A reference pytree of arrays (dicts, lists, tuples, NamedTuples) as
    the same structure of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def leaves_np(tree):
    """Leaves in ``jax.tree.leaves``' order as fp32 numpy arrays."""
    return [to_np(x.detach()) if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32)
            for x in (tadamw.tree_leaves(tree) if _is_torch(tree)
                      else jax.tree.leaves(tree))]


def _is_torch(tree) -> bool:
    return isinstance(tadamw.tree_leaves(tree)[0], torch.Tensor)


def norm_rel(port, ref) -> float:
    """||port - ref|| / ||ref|| (0 when both are 0)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    num = np.linalg.norm(port - ref)
    return float(num / den) if den else float(num)


def assert_leaves_within(port, ref, tol):
    """Each leaf's largest error at most ``tol`` times its largest
    magnitude (tests/test_models.py's rel metric, leaf by leaf)."""
    p, r = leaves_np(port), leaves_np(ref)
    assert len(p) == len(r)
    for a, b in zip(p, r):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
            (np.abs(a - b).max(), np.abs(b).max())


def assert_trees_close(port, ref, tol):
    p, r = leaves_np(port), leaves_np(ref)
    assert len(p) == len(r)
    worst = max(norm_rel(a, b) for a, b in zip(p, r))
    assert worst <= tol, worst


def data_cfg(cfg, B, S, seed=0):
    fe = cfg.frontend
    return dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                seed=seed,
                frontend_tokens=fe.num_tokens if fe and fe.kind == "vision"
                else 0,
                frontend_dim=fe.embed_dim if fe else 0,
                encoder_decoder=cfg.encoder_decoder)


# ------------------------------------------------------------ data pipeline
@pytest.mark.parametrize("kind", ["text", "vision", "encoder_decoder"])
@pytest.mark.parametrize("seed", [0, 5])
def test_batch_at_bit_equal_to_reference(kind, seed):
    kw = dict(vocab_size=97, seq_len=12, global_batch=3, seed=seed)
    if kind == "vision":
        kw.update(frontend_tokens=5, frontend_dim=8)
    if kind == "encoder_decoder":
        kw.update(frontend_dim=6, encoder_decoder=True)
    jcfg, tcfg = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    stream = tpipe.stream(tcfg, 0, device="cpu")
    for step in range(3):
        ref = jpipe.batch_at(jcfg, step)
        got = next(stream)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].device.type == "cpu"
            assert got[k].dtype == {"int32": torch.int32,
                                    "float32": torch.float32}[
                                        str(ref[k].dtype)]
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


# -------------------------------------------------------------------- AdamW
def _adamw_tree(rng):
    return {"w": rng.randn(6, 5).astype(np.float32),
            "stack": rng.randn(2, 3, 4).astype(np.float32),
            "norm": rng.randn(5).astype(np.float32),
            "layers": [{"b": rng.randn(3).astype(np.float32),
                        "k": rng.randn(4, 3).astype(np.float32)}]}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Five steps over one tree of 1-, 2- and 3-d leaves, through the
    warm-up and into the cosine decay, with gradients large enough that
    some steps clip: grad_norm and lr within 1e-6 relative, and params and
    moments within 1e-6 of each leaf's largest magnitude (the two
    compilers round a moment's b * m + (1 - b) * g in other orders, a few
    fp32 ulps, which is a larger share of an element near zero)."""
    rng = np.random.RandomState(0)
    acfg = dict(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2, decay_steps=6,
                clip_norm=3.0, moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**acfg), tadamw.AdamWConfig(**acfg)
    tree = _adamw_tree(rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = to_torch(tree)
    js, ts = jadamw.init(jcfg, jp), tadamw.init(tcfg, tp)
    for step in range(5):
        g = jax.tree.map(lambda a: a * (0.5 + 2 * step), _adamw_tree(rng))
        jp, js, jm = jax.jit(jadamw.update, static_argnums=0)(
            jcfg, jp, js, jax.tree.map(jnp.asarray, g))
        tp, ts, tm = tadamw.update(tcfg, tp, ts, to_torch(g))
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(
                float(jm[k])), k
        for port, ref in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            assert_leaves_within(port, ref, 1e-6)
    assert tadamw.tree_leaves(ts.mu)[0].dtype == (
        torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)


# ------------------------------------------------------- int8 compression
def test_quantize_int8_matches_reference():
    x = np.random.RandomState(1).randn(7, 9).astype(np.float32) * 3
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == pytest.approx(float(js), rel=1e-7)
    np.testing.assert_allclose(tcomp.dequantize_int8(tq, ts).numpy(),
                               np.asarray(jcomp.dequantize_int8(jq, js)),
                               rtol=1e-7)


def test_quantize_int8_integer_path_is_lossless_and_raises():
    keys = np.array([-127, 0, 5, 127], np.int32)
    jq, js = jcomp.quantize_int8(jnp.asarray(keys))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(keys))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy(), keys)
    assert float(ts) == float(js) == 1.0
    wide = np.array([3, 128], np.int64)
    with pytest.raises(ValueError, match="exceeds int8") as ref_err:
        jcomp.quantize_int8(jnp.asarray(wide.astype(np.int32)))
    with pytest.raises(ValueError, match="exceeds int8") as port_err:
        tcomp.quantize_int8(torch.from_numpy(wide))
    assert str(port_err.value) == str(ref_err.value)


def test_compressor_matches_reference_over_steps():
    """Three steps of error feedback over a tree: the compressed gradients
    and the carried errors."""
    rng = np.random.RandomState(2)
    j_init, j_tr = jcomp.make_compressor()
    t_init, t_tr = tcomp.make_compressor()
    tree = _adamw_tree(rng)
    je, te = j_init(jax.tree.map(jnp.asarray, tree)), t_init(to_torch(tree))
    for _ in range(3):
        g = _adamw_tree(rng)
        jg, je = j_tr(jax.tree.map(jnp.asarray, g), je)
        tg, te = t_tr(to_torch(g), te)
        for port, ref in ((tg, jg), (te, je)):
            assert_leaves_within(port, ref, 1e-6)


# ------------------------------------------------- train_loss and gradients
def fp32_expert_product(a, w):
    """The port's ``layers._expert_product`` without its rounding to bf16
    (chip_smoke.py's)."""
    B, E, C, X = a.shape
    y = torch.bmm(a.transpose(0, 1).reshape(E, B * C, X).float(), w.float())
    return y.reshape(E, B, C, -1).transpose(0, 1).to(a.dtype)


class _FP32Products:
    """The reference's ``jnp`` for its layers module, with einsum's
    ``preferred_element_type=bfloat16`` (the MoE expert products) taken
    in fp32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.bfloat16:
            preferred_element_type = jnp.float32
        return jnp.einsum(*args, preferred_element_type=preferred_element_type,
                          **kw)


def _identity(x):
    return x


def _fp32_functions(monkeypatch, arch):
    """The functions the fp32 comparison holds: MoE archs with fp32 expert
    products on both sides; zamba2 without its bf16 gradient boundaries on
    both sides.  The reference's return a bf16 cotangent for an fp32 value,
    which its own fp32 backward refuses, and rounding a cotangent to bf16
    turns the two packages' rounding-order differences into whole bf16
    steps; the boundaries are held by their own test and the bf16 run."""
    if arch in MOE_ARCHS:
        monkeypatch.setattr(jl, "jnp", _FP32Products())
        monkeypatch.setattr(tl, "_expert_product", fp32_expert_product)
    if arch == "zamba2-2.7b":
        for mod in (jlm, jssm, tlm, tssm):
            monkeypatch.setattr(mod, "bf16_grad", _identity)


def _train_case(arch, dtype, ssm=None):
    jcfg = get_smoke_config(arch).replace(dtype=dtype)
    tcfg = t_smoke(arch).replace(dtype=dtype)
    if ssm:                         # SSM fields replaced on both sides
        jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, **ssm))
        tcfg = tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, **ssm))
    if arch in MOE_ARCHS:           # no capacity drops (test_torch_zoo.py)
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=16.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=16.0))
    jm = jlm.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    kw = data_cfg(jcfg, 2, 32, seed=3)
    jb = jpipe.batch_at(jpipe.DataConfig(**kw), 1)
    tb = tpipe.batch_at(tpipe.DataConfig(**kw), 1, device="cpu")
    return jm, jp, jb, build_model(tcfg, "cpu"), to_torch(jp), tb


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_reference(arch, monkeypatch):
    """fp32 smoke models: the loss within 1e-5 relative, each gradient leaf
    within 1e-4 of its norm (the tied embedding's sums its input and
    output uses in one leaf)."""
    _fp32_functions(monkeypatch, arch)
    jm, jp, jb, tm, tp, tb = _train_case(arch, "float32")
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    tloss, tg = tsteps.loss_and_grads(tm, tp, tb)
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert_trees_close(tg, jg, 1e-4)
    if arch in MOE_ARCHS:
        with torch.no_grad():
            _, tmet = tm.train_loss(tp, tb)
        assert float(tmet["moe_aux"]) == pytest.approx(
            float(jmet["moe_aux"]), rel=1e-5)


def test_zamba2_at_mamba2s_state_size_matches_reference(monkeypatch):
    """The smoke zamba2 at the published Mamba2 family's d_state 128 (the
    state size the card's backward takes since its chunk kernels walk the
    state in tiles of 64), ``state_dim`` replaced on both sides of
    ``params_from_jax``: fp32, the loss within 1e-5 relative and each
    gradient leaf within 1e-4 of its norm, as
    ``test_train_loss_and_grads_match_reference`` holds the smoke
    models."""
    _fp32_functions(monkeypatch, "zamba2-2.7b")
    jm, jp, jb, tm, tp, tb = _train_case("zamba2-2.7b", "float32",
                                         ssm=dict(state_dim=128))
    assert tm.cfg.ssm.state_dim == 128
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    tloss, tg = tsteps.loss_and_grads(tm, tp, tb)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert_trees_close(tg, jg, 1e-4)


def test_zamba2_bf16_grads_match_reference_loosely():
    """zamba2 in bf16 through the reference's bf16 gradient boundaries:
    the loss within 2e-2 relative, and the whole gradient (every leaf
    together) within 0.1 of the reference's and of the port's own fp32
    gradient on the same weights.  bf16 activations put the reference's
    own bf16 gradient ~0.07 from that fp32 one on this random 4-layer
    model; the fp32 test holds the function tightly."""
    jm, jp, jb, tm, tp, tb = _train_case("zamba2-2.7b", "bfloat16")
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(jp, jb)
    tloss, tg = tsteps.loss_and_grads(tm, tp, tb)
    assert abs(float(tloss) - float(jloss)) <= 2e-2 * abs(float(jloss))
    assert all(g.dtype == p.dtype for g, p in zip(
        tadamw.tree_leaves(tg), tadamw.tree_leaves(tp)))
    tm32 = build_model(tm.cfg.replace(dtype="float32"), "cpu")
    _, g32 = tsteps.loss_and_grads(tm32, tadamw.tree_map(
        lambda x: x.detach().float(), tp), tb)
    flat = lambda tree: np.concatenate([a.ravel() for a in leaves_np(tree)])
    assert norm_rel(flat(tg), flat(jg)) <= 0.1
    assert norm_rel(flat(tg), flat(g32)) <= 0.1


def test_remat_block_gives_the_same_gradients():
    """``remat="block"`` recomputes each layer in the backward: the same
    loss and gradients, to the last bit on the CPU."""
    jm, jp, jb, tm, tp, tb = _train_case("gemma-7b", "float32")
    loss, grads = tsteps.loss_and_grads(tm, tp, tb)
    tm_r = build_model(tm.cfg.replace(remat="block"), "cpu")
    loss_r, grads_r = tsteps.loss_and_grads(tm_r, tp, tb)
    assert float(loss_r) == float(loss)
    for a, b in zip(tadamw.tree_leaves(grads_r), tadamw.tree_leaves(grads)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- the step
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """gemma-7b smoke in fp32, three steps of ``make_train_step``: each
    step's loss and the parameters after it within 1e-5."""
    jcfg = get_smoke_config("gemma-7b").replace(dtype="float32")
    jm = jlm.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    acfg = dict(lr_peak=1e-3, lr_min=1e-4, warmup_steps=2, decay_steps=100)
    jacfg, tacfg = jadamw.AdamWConfig(**acfg), tadamw.AdamWConfig(**acfg)
    jstep = jax.jit(jsteps.make_train_step(jm, jacfg, n_micro=n_micro))
    tm = build_model(t_smoke("gemma-7b").replace(dtype="float32"), "cpu")
    tstep = tsteps.make_train_step(tm, tacfg, n_micro=n_micro)
    tp = to_torch(jp)
    js, ts = jadamw.init(jacfg, jp), tadamw.init(tacfg, tp)
    kw = data_cfg(jcfg, 4, 16, seed=2)
    for step in range(3):
        jp, js, jmet = jstep(jp, js, jpipe.batch_at(jpipe.DataConfig(**kw),
                                                    step))
        tp, ts, tmet = tstep(tp, ts, tpipe.batch_at(
            tpipe.DataConfig(**kw), step, device="cpu"))
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
        assert_trees_close(tp, jp, 1e-5)


def test_prefill_step_runs_the_models_prefill():
    cfg = t_smoke("gemma-7b").replace(dtype="float32")
    model = build_model(cfg, "cpu")
    tree = model.init_tree(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8))}
    logits, cache = tsteps.make_prefill_step(model)(tree, batch)
    again, _ = model.prefill(batch)
    assert torch.equal(logits, again)
    nxt = {"tokens": batch["tokens"][:, -1:], "pos": cache["pos"]}
    lg, _ = tsteps.make_decode_step(model)(model, cache, nxt)
    assert lg.shape == (2, cfg.vocab_size)


# ----------------------------------------------- supervisor and checkpoints
def _fp32_smoke(monkeypatch):
    """The reference's launcher on the fp32 smoke config."""
    monkeypatch.setattr(jtrain, "get_smoke_config",
                        lambda a: get_smoke_config(a).replace(
                            dtype="float32"))


def _port_training(jstate, **kw):
    """The port's ``build_training`` started from the reference's state."""
    _, step_fn, model, cfg = build_training(device="cpu", dtype="float32",
                                            **kw)
    return (to_torch(jstate[0]),
            tadamw.AdamWState(*to_torch(tuple(jstate[1])))), step_fn


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_ssm_train_step_matches_reference(arch, monkeypatch):
    """The two archs whose scans (K7, K8) train through backward kernels
    on the card: the port's ``build_training`` on the CPU, layers
    recomputed in the backward (``remat="block"``), against the
    reference's ``build_training`` (its ``make_train_step``) from the same
    state, fp32 smoke models: three steps, each step's loss and gradient
    norm and the parameters after it within 1e-5, the parameters over the
    whole tree (zamba2 without its bf16 gradient boundaries on both sides,
    as the fp32 loss test holds it).  Leaf by leaf, a zero-initialised
    leaf (rwkv6's ``mu_base``) takes AdamW's lr g / (|g| + eps) on its
    first steps, which turns the rounding of a gradient near zero into a
    relative error of 2.5e-4 of that leaf; the gradients themselves are
    held leaf by leaf in ``test_train_loss_and_grads_match_reference``."""
    _fp32_smoke(monkeypatch)
    _fp32_functions(monkeypatch, arch)
    kw = dict(arch=arch, smoke=True, batch=2, seq=32)
    jstate, jstep, _, _ = jtrain.build_training(**kw)
    tstate, tstep = _port_training(jstate, remat="block", **kw)
    for step in range(3):
        jstate, jmet = jstep(jstate, step)
        tstate, tmet = tstep(tstate, step)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
        flat = [np.concatenate([a.ravel() for a in leaves_np(tree)])
                for tree in (tstate[0], jstate[0])]
        assert norm_rel(*flat) <= 1e-5


def test_supervisor_restart_matches_reference(monkeypatch, tmp_path):
    """tests/test_substrate.py's run (failure at step 17, checkpoints every
    8 steps, 30 steps) in both packages from the same weights, in fp32:
    one restart each and the same losses, replayed steps included."""
    _fp32_smoke(monkeypatch)
    kw = dict(arch="gemma-7b", smoke=True, batch=4, seq=32, n_micro=1)
    jstate, jstep, _, _ = jtrain.build_training(**kw)
    tstate, tstep = _port_training(jstate, **kw)
    jrep = JSup(JSupCfg(checkpoint_every=8), JCkpt(str(tmp_path / "j"),
                                                   keep=2)).run(
        jstate, jstep, 30, failure_injector=j_inject({17}))
    trep = TrainSupervisor(SupervisorConfig(checkpoint_every=8),
                           CheckpointManager(str(tmp_path / "t"), keep=2)
                           ).run(tstate, tstep, 30,
                                 failure_injector=inject_failure_at({17}))
    assert trep.restarts == jrep.restarts == 1
    assert trep.steps_run == jrep.steps_run >= 30
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
    assert trep.losses[-1] < trep.losses[0]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_training_checkpoint_restores_across_packages(writer, monkeypatch,
                                                      tmp_path):
    """Two steps in the writing package, a checkpoint of (params,
    opt_state), a restore in the other package into its own template, and
    the next step there gives the writer's own next step."""
    _fp32_smoke(monkeypatch)
    kw = dict(arch="gemma-7b", smoke=True, batch=2, seq=16, n_micro=1)
    jstate, jstep, _, _ = jtrain.build_training(**kw)
    tstate, tstep = _port_training(jstate, **kw)
    for s in range(2):
        jstate, _ = jstep(jstate, s)
        tstate, _ = tstep(tstate, s)
    d = str(tmp_path)
    if writer == "reference":
        JCkpt(d).save(2, jstate, extra={"data_step": 2}, blocking=True)
        template = _port_training(jtrain.build_training(**kw)[0], **kw)[0]
        step, restored, extra = CheckpointManager(d).restore(template)
        assert isinstance(restored[1], tadamw.AdamWState)
        (p, o), met = tstep(restored, extra["data_step"])
        (jp, jo), jmet = jstep(jstate, 2)
    else:
        CheckpointManager(d).save(2, tstate, extra={"data_step": 2},
                                  blocking=True)
        template = jtrain.build_training(**kw)[0]
        step, restored, extra = JCkpt(d).restore(template)
        (jp, jo), jmet = jstep(restored, extra["data_step"])
        (p, o), met = tstep(tstate, 2)
    assert step == 2
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert int(o.step) == int(jo.step) == 3
    assert_trees_close(p, jp, 1e-5)
    assert_trees_close(o.nu, jo.nu, 1e-5)


def test_checkpoint_save_snapshots_the_state_before_the_next_step(
        monkeypatch, tmp_path):
    """A save that does not block takes its own copy of every leaf: the
    next step updates params and moments in place while the write is held
    back, and the checkpoint still restores the state at save time."""
    from repro_torch.launch.serve import tree_flatten
    state, tstep, _, _ = build_training("gemma-7b", smoke=True, batch=2,
                                        seq=16, device="cpu")
    state, _ = tstep(state, 0)
    saved = [t.clone() for t in tree_flatten(state)[0]]
    gate, savez = threading.Event(), np.savez

    def held_savez(*a, **kw):
        assert gate.wait(60)
        savez(*a, **kw)

    monkeypatch.setattr(np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, extra={"data_step": 1})
    state, _ = tstep(state, 1)
    after = tree_flatten(state)[0]
    assert not all(torch.equal(a, b) for a, b in zip(after, saved))
    gate.set()
    mgr.wait()
    step, restored, extra = mgr.restore(state)
    assert (step, extra) == (1, {"data_step": 1})
    got = tree_flatten(restored)[0]
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------ K6's plain backward
def _ref_attention(q, k, v, causal):
    """The Pallas kernel's oracle (``kernels/flash_attention/ref.py``) in
    the models' layout, the KV heads broadcast as the kernel's wrapper
    does."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.transpose(0, 2, 1, 3).reshape(B * H, S, d)
    kf = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(B * H, T, d)
    vf = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(
        B * H, T, v.shape[-1])
    o = attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(B, H, S, -1).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", [(24, 16), (64, 64)])
def test_flash_backward_plain_matches_reference(d, dv, causal):
    """``flash_attention_backward_plain`` against ``jax.grad`` of the
    Pallas kernel's own oracle, at two of the kernel's (d, dv) pairs with
    2 query heads a KV head and S != T (the Pallas kernel itself has no
    VJP: ``jax.grad`` of its ``pallas_call`` raises in interpret mode)."""
    assert (d, dv) in tfa.PAIRS
    rng = np.random.RandomState(d + causal)
    B, S, T, H, KV = 2, 24, 40 if not causal else 24, 4, 2
    q, k, v, do = (rng.randn(*s).astype(np.float32) for s in (
        (B, S, H, d), (B, T, KV, d), (B, T, KV, dv), (B, S, H, dv)))
    _, vjp = jax.vjp(lambda *a: _ref_attention(*a, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    got = tfa.flash_attention_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


def test_kernel_wrapper_differentiates_its_plain_version_on_the_cpu():
    """On CPU tensors ``flash_attention_kernel`` is the plain version, so
    autograd through it is the plain backward."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, requires_grad=True)
               for s in ((1, 10, 4, 16), (1, 10, 2, 16), (1, 10, 2, 16)))
    do = torch.randn((1, 10, 4, 16), generator=g)
    out = tfa.flash_attention_kernel(q, k, v, True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    plain = tfa.flash_attention_backward_plain(q, k, v, do, True)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    assert tfa.LAUNCHES == 0 and tfa.BWD_LAUNCHES == 0


def test_backward_sources_are_built():
    """``cuda_build`` builds K7's and K8's backward sources with the
    others, and each of them and the forwards (which now also write the
    states the backward reads) declares the entry points its wrapper
    binds, with as many arguments as the wrapper gives them."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    entries = {"mamba2_scan": (mamba2_scan, ("mamba2_scan",)),
               "mamba2_scan_bwd": (mamba2_scan, ("mamba2_scan_bwd_dstates",
                                                 "mamba2_scan_bwd_chunks")),
               "rwkv6_scan": (rwkv6_scan, ("rwkv6_scan",)),
               "rwkv6_scan_bwd": (rwkv6_scan, ("rwkv6_scan_bwd",))}
    for name, (module, fns) in entries.items():
        assert name in cuda_build.SOURCES
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        wrapper = open(module.__file__).read()
        for fn in fns:
            sig = re.search(rf"^int {fn}\((.*?)\) \{{", src, re.M | re.S)
            assert sig, fn
            params = [p.strip() for p in sig.group(1).split(",")]
            ptrs = sum(p.startswith(("const void*", "void*")) for p in params)
            ints = sum(p.startswith("int ") for p in params)
            assert ptrs + ints == len(params)
            bound = re.search(rf"\.{fn}\n.*?argtypes = \[ctypes\.c_void_p\] "
                              rf"\* (\d+) \+ \[ctypes\.c_int\] \* (\d+)",
                              wrapper, re.S)
            assert bound, fn
            # the stream is the last pointer
            assert (int(bound.group(1)) + 1, int(bound.group(2))) \
                == (ptrs, ints), fn


def test_bf16_grad_rounds_the_cotangent_in_its_own_type():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = tl.bf16_grad(x * 1.0)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * torch.tensor([1.2345678, 3.3])).sum(),
                               x)
    assert g.dtype == torch.float32
    expect = torch.tensor([1.2345678, 3.3]).to(torch.bfloat16).float()
    assert torch.equal(g, expect)
    assert not math.isclose(float(g[0]), 1.2345678, rel_tol=1e-6)


def test_bf16_grad_is_the_identity_when_no_graph_is_recorded():
    x = torch.tensor([1.2345678, 3.3], requires_grad=True)
    with torch.no_grad():
        assert tl.bf16_grad(x) is x


def test_backward_source_builds_every_forward_pair():
    """``csrc/flash_attention_bwd.cu`` instantiates the forward's
    ``FLASH_PAIRS`` (the wrapper's ``PAIRS``), and ``cuda_build`` builds
    it with the other sources."""
    pat = re.compile(r"#define FLASH_PAIRS\(X\)(.*?)\n\n", re.S)
    for name in ("flash_attention", "flash_attention_bwd"):
        src = (tfa.cuda_build.CSRC / f"{name}.cu").read_text()
        pairs = {(int(a), int(b)) for a, b in re.findall(
            r"X\((\d+), (\d+)\)", pat.search(src).group(1))}
        assert pairs == set(tfa.PAIRS), name
        assert name in tfa.cuda_build.SOURCES
