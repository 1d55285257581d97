"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's arithmetic on the CPU: two cells traced on meta DTensors in a
fake process group of their own (a subprocess), whose config-derived
fields equal the reference's config arithmetic and whose argument bytes a
device equal the local shard bytes of the reference's own specs on a
shape-only mesh (no JAX compile); the traced flops of gemma-7b's training
step against its model flops; and the ``long_500k`` skip rule."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from repro.configs import (ARCH_IDS, active_params, count_params,
                           get_config, shape_applicable, shape_by_name)
from repro.launch.sharding import default_rules
from repro.launch.specs import (batch_pspec, cache_pspec_tree,
                                opt_pspec_tree, param_pspec_tree,
                                policy_for, serving_rules)
from repro.models.lm import build_model
from repro_torch.configs import shape_applicable as port_applicable

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("gemma-7b", "train_4k", "single"),
         ("deepseek-v2-236b", "decode_32k", "multi")]
SKIPPED = [a for a in ARCH_IDS if not shape_applicable(a, "long_500k")]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}

RUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import run_cell
out = {}
for arch, shape, mesh in json.loads(sys.argv[1]):
    out[f"{arch}|{shape}|{mesh}"] = run_cell(arch, shape, mesh, "unused")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    cells = CELLS + [(a, "long_500k", "single") for a in SKIPPED]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", RUN, json.dumps(cells)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _local_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of ``tree`` placed by ``specs``."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                shape[d] //= math.prod(mesh.shape[a] for a in axes)
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize
    return total


def _reference(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """What the reference's dry run derives from its configs and specs
    alone: the roofline's config fields, the microbatch count and the
    argument bytes a device."""
    multi = mesh_kind == "multi"
    shape, mesh = shape_by_name(shape_name), MESHES[mesh_kind]
    cfg = get_config(arch)
    chips = math.prod(mesh.shape.values())
    rules = default_rules(multi)
    if shape.kind == "decode":
        rules = serving_rules(cfg, rules, mesh)
    policy = policy_for(cfg, shape.kind)
    model = build_model(cfg)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    args = _local_bytes(params, param_pspec_tree(params, mesh, rules,
                                                 policy), mesh)
    batch = model.input_specs(shape)
    args += _local_bytes(batch, batch_pspec(batch, mesh, rules), mesh)
    out = {}
    if shape.kind == "train":
        ospec = opt_pspec_tree(params, mesh, rules, policy)
        moments = jax.tree.map(
            lambda p: jax.ShapeDtypeStruct(p.shape, jnp.bfloat16), params)
        args += 2 * _local_bytes(moments, ospec, mesh) + 4     # + step
        out["n_micro"] = max(1, shape.global_batch
                             // (chips // mesh.shape["model"]))
    elif shape.kind == "decode":
        cache = model.cache_spec(shape.global_batch, shape.seq_len)
        args += _local_bytes(cache, cache_pspec_tree(cfg, cache, mesh,
                                                     rules), mesh)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_act = active_params(cfg)
    out.update(args=args, params=count_params(cfg), active_params=n_act,
               tokens_per_step=tokens, chips=chips,
               model_flops=(6 if shape.kind == "train" else 2) * n_act
               * tokens)
    return out


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "|".join(c))
def test_dryrun_cell_matches_reference_arithmetic(records, cell):
    rec = records["|".join(cell)]
    assert rec["ok"] and not rec.get("skipped"), rec.get("error")
    ref = _reference(*cell)
    r = rec["roofline"]
    for k in ("params", "active_params", "tokens_per_step", "model_flops",
              "chips"):
        assert r[k] == ref[k], k
    if "n_micro" in ref:
        assert rec["n_micro"] == ref["n_micro"]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == ref["args"]
    assert mem["live_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["fits_80g_args"] and mem["fits_80g_strict"]
    h = rec["hlo"]
    assert h["flops_per_device"] > 0 and h["bytes_per_device"] > 0
    assert h["n_collectives"] > 0 and h["trip_warnings"] == []
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert 0 < r["roofline_fraction"] <= 1


def test_gemma_train_flops_against_model_flops(records):
    """Training runs the forward, the remat forward again and the backward,
    2 + 2 + 4 of the model's 6 flops a parameter and token, plus
    attention: between 1 and 2 times the model flops over all chips."""
    r = records["gemma-7b|train_4k|single"]["roofline"]
    assert 1.0 <= r["hlo_flops_global"] / r["model_flops"] <= 2.0
    kernels = records["gemma-7b|train_4k|single"]["hlo"]["flops_by_op"]
    assert kernels["kernel:flash_attention"] > 0
    assert kernels["kernel:flash_attention_bwd"] > 0


def test_long_500k_skip_rule_matches_reference(records):
    assert [a for a in ARCH_IDS if not port_applicable(a, "long_500k")] \
        == SKIPPED
    assert [a for a in ARCH_IDS if port_applicable(a, "prefill_32k")] \
        == [a for a in ARCH_IDS if shape_applicable(a, "prefill_32k")]
    for arch in SKIPPED:
        rec = records[f"{arch}|long_500k|single"]
        assert rec["ok"] and rec["skipped"]
        assert "sub-quadratic" in rec["reason"]
