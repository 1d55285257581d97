"""The port's launch modules against the reference package on the CPU: the
sharding resolver and the parameter rules (tests/test_launch.py's cases),
the parameter, optimizer, cache and batch specs of all ten architectures
on both production meshes (shape-only meshes, as tests/test_launch.py
uses), the models' ``cache_spec``/``input_specs``, the program analysis,
the models under a one-rank mesh bit for bit, ``int8_allreduce`` on two
ranks against the reference's under ``jax.vmap``, elastic resharding,
``examples/serve_stream_torch.py`` against ``examples/serve_stream.py`` and
``examples/quickstart_torch.py`` against ``examples/quickstart.py``.
Whatever starts a process group runs in a process of its own."""
import contextlib
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import LM_SHAPES, get_config as jget_config
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.lm import build_model as jbuild
from repro.runtime import compression as jcomp
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import hw
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models.lm import build_model, meta_params

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH_POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": (MESH, False), "multi": (MESH_POD, True)}


def run_py(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def as_tuple(spec) -> tuple:
    """A spec as a plain tuple; an entry of one axis as its name (JAX's
    PartitionSpec keeps ``("data",)`` as ``"data"``)."""
    def one(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(one(e) for e in spec)


# ------------------------------------------- tests/test_launch.py:22-70
def _cases(sh, sp, P):
    rules, pod = sh.default_rules(False), sh.default_rules(True)
    return {
        "resolve_basic": lambda: sh.resolve_spec(
            ("batch", "seq", "heads", None), (256, 4096, 64, 128), MESH,
            rules),
        "resolve_divisibility": lambda: sh.resolve_spec(
            ("batch", "seq", "heads", None), (256, 4096, 40, 128), MESH,
            rules),
        "resolve_axis_conflict": lambda: sh.resolve_spec(
            ("batch", "experts_data", None), (256, 160, 64), MESH, rules),
        "resolve_multi_pod_prefix": lambda: sh.resolve_spec(
            ("batch", None), (16, 64), MESH_POD, pod),
        "param_logical_ep_model": lambda: sp.param_logical(
            ("layers", "moe", "w_gate"), (59, 160, 5120, 1536),
            sp.ShardingPolicy(fsdp_params=True)),
        "param_logical_ep_data_tp_ffn": lambda: sp.param_logical(
            ("layers", "moe", "w_gate"), (59, 160, 5120, 1536),
            sp.ShardingPolicy(fsdp_params=True,
                              expert_scheme="ep_data_tp_ffn")),
        "param_logical_bc_replicated": lambda: sp.param_logical(
            ("layers", "mamba", "w_Bm"), (54, 2560, 64),
            sp.ShardingPolicy(fsdp_params=False)),
    }


EXPECTED = {
    "resolve_basic": ("data", None, "model", None),
    "resolve_divisibility": ("data", None, None, None),
    "resolve_axis_conflict": ("data", None, None),
    "resolve_multi_pod_prefix": ("pod", None),
    "param_logical_ep_model": (None, "tp", "fsdp", None),
    "param_logical_ep_data_tp_ffn": (None, "expert_fsdp", None, "tp"),
    "param_logical_bc_replicated": (None, None, None),
}


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_resolver_and_param_rules_cases(case):
    port = _cases(tsh, tspecs, tsh.P)[case]()
    ref = _cases(jsh, jspecs, JP)[case]()
    assert as_tuple(port) == as_tuple(ref) == EXPECTED[case]


def test_partition_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")
    spec = tsh.P(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model")
    assert tsh.placements(spec, Named) == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, None), Named) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tsh.placements(tsh.P(("data", "pod")), Named)
    assert tsh.constraint(torch.ones(2), "batch") is not None
    x = torch.ones(2, 3)
    assert tsh.constraint(x, "batch", "embed") is x


# ------------------------------------------------------ parameter trees
@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    model = jbuild(jget_config(arch))
    return jax.eval_shape(model.init_params, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return meta_params(get_config(arch))


def _flat_ref(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jspecs._path_names(p): v for p, v in flat}


def _flat_port(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _flat_port(t, path + (str(n),)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, tsh.P):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat_port(t, path + (str(i),)).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch):
    ref_p, port_p = _ref_params(arch), _port_params(arch)
    shapes_r = {k: (tuple(v.shape), str(v.dtype))
                for k, v in _flat_ref(ref_p).items()}
    shapes_p = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _flat_port(port_p).items()}
    assert shapes_p == shapes_r
    cfg_r, cfg_p = jget_config(arch), get_config(arch)
    n = 0
    for mesh, pod in MESHES.values():
        for kind in ("train", "decode"):
            rules_r, rules_p = jsh.default_rules(pod), tsh.default_rules(pod)
            pol_r, pol_p = (jspecs.policy_for(cfg_r, kind),
                            tspecs.policy_for(cfg_p, kind))
            assert pol_r.__dict__ == pol_p.__dict__
            for fr, fp in ((jspecs.param_pspec_tree,
                            tspecs.param_pspec_tree),
                           (jspecs.opt_pspec_tree, tspecs.opt_pspec_tree)):
                r = {k: as_tuple(v) for k, v in _flat_ref(
                    fr(ref_p, mesh, rules_r, pol_r)).items()}
                p = {k: as_tuple(v) for k, v in _flat_port(
                    fp(port_p, mesh, rules_p, pol_p)).items()}
                assert p == r, (kind, fr.__name__)
                n += len(p)
    assert n > 0


# ------------------------------------------------- caches and batches
def _flat_shapes(tree, port: bool) -> dict:
    flat = _flat_port(tree) if port else {
        jspecs._path_names(p): v
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_input_specs_match_reference(arch):
    jm, tm = jbuild(jget_config(arch)), build_model(get_config(arch),
                                                    device="meta")
    for shape in LM_SHAPES:
        B, T = shape.global_batch, shape.seq_len
        cr, cp = jm.cache_spec(B, T), tm.cache_spec(B, T)
        assert _flat_shapes(cp, True) == _flat_shapes(cr, False), shape
        assert all(t.device.type == "meta"
                   for t in _flat_port(cp).values())
        ir, ip = jm.input_specs(shape), tm.input_specs(shape)
        assert list(ip) == list(ir), shape
        assert _flat_shapes(ip, True) == _flat_shapes(ir, False), shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_batch_specs_and_serving_rules_match_reference(arch):
    cfg_r, cfg_p = jget_config(arch), get_config(arch)
    jm, tm = jbuild(cfg_r), build_model(cfg_p, device="meta")
    for mesh, pod in MESHES.values():
        base_r, base_p = jsh.default_rules(pod), tsh.default_rules(pod)
        rules_r = jspecs.serving_rules(cfg_r, base_r, mesh)
        rules_p = tspecs.serving_rules(cfg_p, base_p, mesh)
        assert rules_p == rules_r
        for shape in LM_SHAPES:
            B, T = shape.global_batch, shape.seq_len
            r = _flat_ref(jspecs.cache_pspec_tree(
                cfg_r, jm.cache_spec(B, T), mesh, rules_r))
            p = _flat_port(tspecs.cache_pspec_tree(
                cfg_p, tm.cache_spec(B, T), mesh, rules_p))
            assert {k: as_tuple(v) for k, v in p.items()} == \
                {k: as_tuple(v) for k, v in r.items()}
            br = jspecs.batch_pspec(jm.input_specs(shape), mesh, base_r)
            bp = tspecs.batch_pspec(tm.input_specs(shape), mesh, base_p)
            assert {k: as_tuple(v) for k, v in bp.items()} == \
                {k: as_tuple(v) for k, v in br.items()}


# ------------------------------------------------------ program analysis
ANALYSIS = r"""
import json, torch
from repro_torch.launch.program_analysis import analyze
M, N, K = 64, 48, 32
a, b = torch.randn(M, K), torch.randn(K, N)
with analyze() as t0:
    a @ b
from repro_torch.launch.mesh import fake_world, make_mesh
fake_world(4)
mesh = make_mesh((4,), ("model",), device="cpu")
from torch.distributed.tensor import DTensor, Replicate, Shard
x = DTensor.from_local(torch.empty(M, K, device="meta"), mesh, [Replicate()],
                       run_check=False)
w = DTensor.from_local(torch.empty(K, N // 4, device="meta"), mesh,
                       [Shard(1)], run_check=False)
with analyze() as t1:
    y = (x @ w).redistribute(mesh, [Replicate()])
print(json.dumps({"flops": t0.flops, "bytes": t0.bytes,
                  "mesh_flops": t1.flops, "coll": t1.by_collective,
                  "n": t1.n_collectives, "warn": t1.trip_warnings,
                  "shape": list(y.shape)}))
"""


def test_program_analysis_counts_flops_and_collectives():
    out = json.loads(run_py(ANALYSIS).strip().splitlines()[-1])
    M, N, K = 64, 48, 32
    assert out["flops"] == 2 * M * N * K
    assert out["bytes"] == 4 * (M * K + K * N + M * N)
    assert out["mesh_flops"] == 2 * M * N * K / 4
    assert out["coll"] == {"all-gather": 4 * M * N / 4}
    assert out["n"] == 1 and out["warn"] == [] and out["shape"] == [M, N]


NODES = r"""
import json, torch
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.program_analysis import analyze
fake_world(16)
mesh = make_mesh((2, 8), ("data", "model"), device="cpu")
from torch.distributed.tensor import DTensor, Replicate, Shard
out = {}
for axis, placed in (("model", [Replicate(), Shard(0)]),
                     ("data", [Shard(0), Replicate()])):
    x = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh, placed,
                           run_check=False)
    with analyze() as t:
        x.redistribute(mesh, [Replicate(), Replicate()])
    out[axis] = [t.collective_bytes, t.inter_node_bytes]
print(json.dumps(out))
"""


def test_collectives_across_nodes_go_at_the_network_rate():
    """On a 2 x 8 mesh, eight ranks a node: a gather over the model axis
    stays in one node, one over the data axis (ranks i and i + 8) spans
    two, and the roofline costs its bytes at the network's rate."""
    out = json.loads(run_py(NODES).strip().splitlines()[-1])
    assert out["model"][0] == 4 * 64 * 32 and out["model"][1] == 0
    assert out["data"][0] == 4 * 64 * 32 and out["data"][1] == 4 * 64 * 32
    t = hw.roofline_terms(0.0, 0.0, 900e9, 16, inter_node_bytes=50e9)
    assert t["collective_s"] == pytest.approx(850e9 / hw.NVLINK_BW + 1.0)
    assert hw.node_of(7) == 0 and hw.node_of(8) == 1


# ------------------------------------------------- models under a mesh
ONE_RANK = r"""
import json, torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method="file://__STORE__", rank=0,
                        world_size=1)
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import axis_rules, default_rules, placements
from repro_torch.launch.specs import (batch_pspec, param_pspec_tree,
                                      policy_for, serving_rules, tree_map2)
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.lm import build_model, stack_layers, unstack_layers
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.elastic import reshard_params
torch.set_num_threads(1)
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
out = {}
for arch, dtype in __CASES__:
    cfg = get_smoke_config(arch)
    cfg = cfg.replace(dtype=dtype or cfg.dtype)
    m = build_model(cfg, device="cpu")
    tree = stack_layers(cfg, m.init_tree(torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    B, S = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.encoder_decoder:
        batch["frames"] = torch.randn(B, S, cfg.frontend.embed_dim,
                                      generator=g)
    elif cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            B, cfg.frontend.num_tokens, cfg.frontend.embed_dim, generator=g)
    loss, grads = loss_and_grads(m, tree, batch)
    rules = default_rules(False)
    specs = param_pspec_tree(tree, mesh, rules, policy_for(cfg, "train"))
    dtree = tree_map2(lambda s, x: distribute_tensor(
        x.detach().clone(), mesh, placements(s, mesh)), specs, tree)
    bs = batch_pspec(batch, mesh, rules)
    dbatch = {k: distribute_tensor(v, mesh, placements(bs[k], mesh))
              for k, v in batch.items()}
    with axis_rules(mesh, rules):
        dloss, dgrads = loss_and_grads(m, dtree, dbatch)
    on1 = reshard_params(dtree, make_mesh((1,), ("data",), device="cpu"))
    # serving: prefill and one decode step, by the serving rules
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    with torch.no_grad():
        m.load_params(unstack_layers(cfg, tree_map(torch.Tensor.detach,
                                                   tree)))
        lp, cache = m.prefill(prompt)
        nxt = {"tokens": torch.argmax(lp, -1)[:, None].int(),
               "pos": int(cache["pos"]) + 1}
        ld, _ = m.decode(cache, nxt)
        srules = serving_rules(cfg, rules, mesh)
        sspec = param_pspec_tree(tree, mesh, srules, policy_for(cfg, "decode"))
        m.load_params(unstack_layers(cfg, tree_map2(
            lambda s, x: distribute_tensor(x.detach().clone(), mesh,
                                           placements(s, mesh)),
            sspec, tree)))
        ps = batch_pspec(prompt, mesh, srules)
        with axis_rules(mesh, srules):
            dlp, dcache = m.prefill({k: distribute_tensor(
                v, mesh, placements(ps[k], mesh)) for k, v in prompt.items()})
            dld, _ = m.decode(dcache, nxt)
    out[f"{arch}|{cfg.dtype}"] = dict(
        serve=torch.equal(lp, dlp.full_tensor())
        and torch.equal(ld, dld.full_tensor()),
        loss=torch.equal(loss, dloss.full_tensor()),
        grads=all(torch.equal(a, b.full_tensor()) for a, b in
                  zip(tree_leaves(grads), tree_leaves(dgrads))),
        grads_rel=max(float((a - b.full_tensor()).abs().max())
                      / (float(a.abs().max()) + 1e-30) for a, b in
                      zip(tree_leaves(grads), tree_leaves(dgrads))),
        dtensor=type(dloss).__name__,
        reshard=all(torch.equal(a, b.full_tensor()) for a, b in
                    zip(tree_leaves(tree), tree_leaves(on1))))
dist.destroy_process_group()
print(json.dumps(out))
"""

FAMILIES = ["gemma-7b", "deepseek-v2-236b", "zamba2-2.7b", "rwkv6-3b",
            "seamless-m4t-large-v2", "llava-next-mistral-7b"]
MOE_FAMILIES = {"deepseek-v2-236b"}


def test_models_under_a_one_rank_mesh_are_bit_equal(tmp_path):
    """Each family's smoke model: loss and every gradient under a 1 x 1
    gloo mesh, its parameters DTensors placed by ``policy_for(cfg,
    "train")``, and the prefill's and one decode step's logits under the
    serving rules, equal the plain run bit for bit; ``reshard_params``
    from (1, 1) to (1,) keeps every leaf.  The MoE's gradients alone may
    differ by rounding: under a mesh x enters the dispatch through
    ``local_map``'s one node, so its gradient sums in another order; in
    fp32 they are held within 1e-5 of each leaf's largest gradient, in
    the smoke models' bf16 within 2e-2 (a few bf16 roundings, 2 ** -8
    each)."""
    cases = [(a, None) for a in FAMILIES] \
        + [(a, "float32") for a in sorted(MOE_FAMILIES)]
    code = ONE_RANK.replace("__STORE__", str(tmp_path / "pg")).replace(
        "__CASES__", repr(cases))
    out = json.loads(run_py(code, timeout=600).strip().splitlines()[-1])
    assert len(out) == len(cases)
    for key, r in out.items():
        arch, dtype = key.split("|")
        equal, rel = r.pop("grads"), r.pop("grads_rel")
        tol = 1e-5 if dtype == "float32" else 2e-2
        assert equal or (arch in MOE_FAMILIES and rel <= tol), (key, rel)
        assert r == dict(serve=True, loss=True, dtensor="DTensor",
                         reshard=True), key


# -------------------------------------------------------- int8 all-reduce
INT8 = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, xs, store, q):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=len(xs))
    from repro_torch.runtime.compression import int8_allreduce
    y = int8_allreduce(torch.from_numpy(np.asarray(xs[rank], np.float32)))
    q.put((rank, y.tolist()))
    dist.destroy_process_group()


if __name__ == "__main__":
    cases, stores = json.loads(sys.argv[1]), sys.argv[2]
    ctx = mp.get_context("spawn")
    res = []
    for i, xs in enumerate(cases):
        q = ctx.Queue()
        mp.spawn(worker, args=(xs, f"{stores}{i}", q), nprocs=len(xs),
                 join=True)
        got = dict(q.get() for _ in xs)
        res.append([got[r] for r in range(len(xs))])
    print(json.dumps(res))
"""


def test_int8_allreduce_matches_reference_and_its_fault(tmp_path):
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal((2, 37)).astype(np.float32),
             np.asarray([[1.0], [100.0]], np.float32)]
    script = tmp_path / "int8.py"
    script.write_text(INT8)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(script),
         json.dumps([c.tolist() for c in cases]), str(tmp_path / "pg")],
        env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    port = json.loads(out.stdout.strip().splitlines()[-1])
    for xs, got in zip(cases, port):
        ref = np.asarray(jax.vmap(lambda x: jcomp.int8_allreduce(x, "i"),
                                  axis_name="i")(jnp.asarray(xs)))
        np.testing.assert_array_equal(np.asarray(got, np.float32), ref)
    # the reference's fault, on both sides: [1] and [100] sum to 200
    assert port[1] == [[200.0], [200.0]]


# ------------------------------------------------- decode on two ranks
DECODE = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, store, q):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import decode_attention
    mesh = make_mesh((2,), ("model",), device="cpu")
    g = torch.Generator().manual_seed(0)
    B, T, KV, H, d = 3, 16, 2, 4, 8
    qq, k, v = (torch.randn(s, generator=g) for s in
                ((B, 1, H, d), (B, T, KV, d), (B, T, KV, d)))
    kn, vn = (torch.randn(B, 1, KV, d, generator=g) for _ in range(2))
    errs = {}
    for pos, new in ((5, True), (12, True), (9, False), (15, False)):
        args = (kn, vn) if new else (None, None)
        ref = decode_attention(qq, k, v, pos, *args)
        for dim, name in ((1, "positions"), (2, "heads")):
            out = decode_attention(
                qq, distribute_tensor(k, mesh, [Shard(dim)]),
                distribute_tensor(v, mesh, [Shard(dim)]), pos, *args)
            err = float((out.full_tensor() - ref).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
    q.put((rank, errs))
    dist.destroy_process_group()


if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    mp.spawn(worker, args=(sys.argv[1], q), nprocs=2, join=True)
    print(json.dumps(dict(q.get() for _ in range(2))))
"""


def test_decode_attention_split_over_two_ranks(tmp_path):
    """The models' decode attention with its caches split over two gloo
    ranks: by KV heads each shard attends alone (bit for bit); by
    positions each shard's log-sum-exp and output merge across the ranks
    and with the new token, within fp32 rounding of the one-device
    result."""
    script = tmp_path / "decode.py"
    script.write_text(DECODE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "pg")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    errs = json.loads(out.stdout.strip().splitlines()[-1])
    for rank in ("0", "1"):
        assert errs[rank]["heads"] == 0.0
        assert errs[rank]["positions"] < 2e-6


# ------------------------------------------------------- serving example
@pytest.mark.parametrize("mode", ["sync", "async", "prefetch"])
def test_serve_stream_torch_prints_the_reference_tour(mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    outs = [subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--mode", mode]
        + extra, env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300) for name, extra in
        (("serve_stream.py", []),
         ("serve_stream_torch.py", ["--device", "cpu"]))]
    assert all(o.returncode == 0 for o in outs), [o.stderr for o in outs]
    assert outs[1].stdout == outs[0].stdout
    assert f"[{mode}] ttft" in outs[1].stdout


# ------------------------------------------------------ the quickstart
@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{Path(name).stem}", ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QUICKSTART_RUNS = [("lru", "sync", False), ("lru", "async", False),
                   ("tac", "prefetch", False), ("tac", "prefetch", True)]


@pytest.mark.parametrize("policy,mode,fused", QUICKSTART_RUNS)
def test_quickstart_torch_runs_equal_the_reference(policy, mode, fused):
    """``examples/quickstart_torch.py``'s ``build`` on the CPU (the fused
    run's plane on ``device="cpu"``) against ``examples/quickstart.py``'s:
    the same latencies, hit rate and batch fill over a shortened stream."""
    ref, port = load_example("quickstart.py"), \
        load_example("quickstart_torch.py")
    run = dict(duration=1.0, warmup=0.5)
    mr = ref.build(policy, mode, fused=fused).run(**run)
    with one_thread():
        mp = port.build(policy, mode, fused=fused, device="cpu").run(**run)
    for key in ("p50", "p999", "stateful_hit_rate"):
        assert mp.get(key) == mr.get(key), key
    fill = mp.get("stateful_fused", {}).get("fill_ratio")
    assert fill == mr.get("stateful_fused", {}).get("fill_ratio")
    assert (fill is not None) == fused
    assert mp["p50"] > 0


def test_quickstart_torch_failure_tour_equals_the_reference():
    """The ``--fail-at`` build (replayable source, barrier checkpoints, a
    whole-job failure and a warmed recovery) on both packages over a
    shortened run: equal checkpoint and recovery figures."""
    from repro.streaming import recovery as jrec
    from repro_torch.streaming import recovery as trec
    out = []
    for example, rec in (("quickstart.py", jrec),
                         ("quickstart_torch.py", trec)):
        eng = load_example(example).build("tac", "prefetch", replayable=True)
        coord = rec.CheckpointCoordinator(eng, interval=0.5)
        coord.start()
        rec.inject_failure_at(eng, at=1.2, mode="warmed")
        with one_thread():
            m = eng.run(duration=1.5, warmup=0.5)
        out.append(m)
    mr, mp = out
    assert mp["checkpoint"] == mr["checkpoint"]
    assert mp["recovery"] == mr["recovery"]
    for key in ("p50", "p999", "stateful_hit_rate"):
        assert mp.get(key) == mr.get(key), key
    assert mp["checkpoint"]["epochs_completed"] > 0
    assert mp["recovery"]["failures"] == 1
    assert mp["recovery"]["warmup_hints"] > 0
