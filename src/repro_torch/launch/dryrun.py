"""Dry run of every (arch x shape x mesh) cell: the port of
``repro/launch/dryrun.py``.  It places a model on the production mesh and
records its memory, cost and collectives a device for the roofline
report, with the H100's figures (``launch/hw.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k --mesh single --out results/dryrun_torch

Where the reference lowers and compiles on 512 forced host devices, the
port starts a fake process group of 512 ranks in this process
(``launch/mesh.py``: ``fake_world``), builds the model on the meta
device, places parameters, optimizer moments, batch and cache as meta
DTensors by ``launch/specs.py``, and traces the step under
``launch/program_analysis.py``: one train microbatch forward and backward
(its counts times the microbatch count, the reference's scan trip count)
and one AdamW update; prefill and decode once.  Nothing runs on a device:
meta tensors hold shapes only, a fake group's collectives move nothing,
and a kernel wrapper given meta tensors books its cost instead of
running.  Run it in its own process: the fake group must never share a
process with a real one.

Memory a device: the arguments' bytes are exact, from the local shard
shapes; the peak adds the most local bytes alive at once during the trace
(``peak_live_bytes``), an estimate that frees nothing early.  Both are
held against the card's 80 GB.  A record has the reference's keys, but
``trace_s`` stands for its ``lower_s``, ``compile_s``, ``analyze_s`` and
``xla_cost``: nothing is lowered or compiled.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import (ARCH_IDS, LM_SHAPES, active_params,
                                 count_params, get_config, shape_applicable,
                                 shape_by_name)
from repro_torch.launch import hw, program_analysis
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.sharding import (NamedSharding, P, axis_rules,
                                         default_rules, mesh_sizes,
                                         placements, redistribute)
from repro_torch.launch.specs import (batch_pspec, cache_pspec_tree,
                                      opt_pspec_tree, param_pspec_tree,
                                      policy_for, serving_rules, tree_map2)
from repro_torch.launch.steps import (accumulate, loss_and_grads,
                                      make_decode_step, make_prefill_step)
from repro_torch.models.lm import (_pos, build_model, meta_params,
                                   unstack_layers)
from repro_torch.optim import adamw


def local_shape(shape, spec, mesh) -> tuple:
    """One device's shard of a tensor of ``shape`` placed by ``spec``."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else entry
            out[d] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def placed(tree: Any, specs: Any, mesh) -> Any:
    """Meta DTensors of ``tree``'s shapes and dtypes on ``mesh`` by
    ``specs``."""
    from torch.distributed.tensor import DTensor

    def one(spec, t):
        shape = tuple(t.shape)
        loc = torch.empty(local_shape(shape, spec, mesh), dtype=t.dtype,
                          device="meta")
        return DTensor.from_local(loc, mesh, placements(spec, mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta")
                                  .stride())
    return tree_map2(one, specs, tree)


def local_bytes(tree: Any) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in adamw.tree_leaves(tree))


def _microbatch(batch: Dict[str, Any], n: int) -> Dict[str, Any]:
    return {k: torch.empty((v.shape[0] // n,) + tuple(v.shape[1:]),
                           dtype=v.dtype, device="meta")
            if v.ndim else v for k, v in batch.items()}


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             attn_impl: str = None, note: str = "") -> dict:
    multi = mesh_kind == "multi"
    shape = shape_by_name(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "note": note}
    if not shape_applicable(arch, shape_name):
        rec.update(ok=True, skipped=True,
                   reason="long_500k restricted to sub-quadratic archs "
                          "(see DESIGN.md §4)")
        return rec

    cfg = get_config(arch)
    if shape.kind == "train":
        cfg = cfg.replace(remat="block")
    if attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    if not torch.distributed.is_initialized():
        fake_world(512)           # both production meshes fit in it
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    chips = mesh.size()
    rules = default_rules(multi)
    if shape.kind == "decode":
        rules = serving_rules(cfg, rules, mesh)
    policy = policy_for(cfg, shape.kind)
    if policy.expert_scheme != "ep_model":
        cfg = cfg.replace(expert_scheme=policy.expert_scheme)
        rec["expert_scheme"] = policy.expert_scheme
    model = build_model(cfg, device="meta")

    params_shape = meta_params(cfg)
    pspec = param_pspec_tree(params_shape, mesh, rules, policy)
    params_in = placed(params_shape, pspec, mesh)
    batch_shape = model.input_specs(shape)
    bspec = batch_pspec(batch_shape, mesh, rules)
    args = local_bytes(params_in) + sum(
        math.prod(local_shape(v.shape, bspec[k], mesh)) * v.element_size()
        for k, v in batch_shape.items())

    t0 = time.time()
    with axis_rules(mesh, rules):
        if shape.kind == "train":
            acfg = adamw.AdamWConfig(moment_dtype="bfloat16")
            ospec = opt_pspec_tree(params_shape, mesh, rules, policy)
            moments = tree_map2(
                lambda s, t: torch.empty(t.shape, dtype=torch.bfloat16,
                                         device="meta"), ospec, params_shape)
            opt_in = adamw.AdamWState(
                step=torch.zeros((), dtype=torch.int32),
                mu=placed(moments, ospec, mesh),
                nu=placed(moments, ospec, mesh))
            args += local_bytes(opt_in.mu) + local_bytes(opt_in.nu) \
                + opt_in.step.element_size()
            data_size = chips // int(mesh_sizes(mesh).get("model", 1))
            n_micro = max(1, shape.global_batch // data_size)
            rec["n_micro"] = n_micro
            grad_sh = tree_map2(lambda s, _t: NamedSharding(mesh, s), pspec,
                                params_shape)
            mb_shape = _microbatch(batch_shape, n_micro)
            mb_in = placed(mb_shape, batch_pspec(mb_shape, mesh, rules),
                           mesh)
            with program_analysis.analyze() as micro:
                gacc = tree_map2(
                    redistribute, adamw.tree_map(lambda p: torch.zeros_like(
                        p, dtype=torch.float32), params_in), grad_sh)
                _loss, grads = loss_and_grads(model, params_in, mb_in)
                grads = tree_map2(redistribute, grads, grad_sh)
                accumulate(adamw.tree_leaves(gacc), grads)
                del grads
            with program_analysis.analyze() as upd:
                adamw.update(acfg, params_in, opt_in, adamw.tree_map(
                    lambda g: g / n_micro, gacc))
            del gacc
            totals = micro.scaled(n_micro).add(upd)
        else:
            model.load_params(unstack_layers(cfg, params_in))
            batch_in = placed(batch_shape, bspec, mesh)
            if shape.kind == "prefill":
                with program_analysis.analyze() as totals:
                    make_prefill_step(model)(model, batch_in)
            else:
                cache_shape = model.cache_spec(shape.global_batch,
                                               shape.seq_len)
                cspec = cache_pspec_tree(cfg, cache_shape, mesh, rules)
                cspec["pos"] = P()
                cache_in = placed(cache_shape, cspec, mesh)
                args += local_bytes(cache_in)
                pos = _pos(shape.seq_len - 1)
                cache_in["pos"] = pos
                batch_in["pos"] = pos
                with program_analysis.analyze() as totals:
                    make_decode_step(model)(model, cache_in, batch_in)
    rec["trace_s"] = round(time.time() - t0, 2)

    # ---- memory ----
    live = args + int(totals.peak_live_bytes)
    rec["memory"] = {
        "argument_size_in_bytes": args,
        "peak_live_bytes": int(totals.peak_live_bytes),
        "live_bytes": live,
        "fits_80g_strict": bool(live <= hw.HBM_BYTES),
        "fits_80g_args": bool(args <= hw.HBM_BYTES),
    }

    # ---- the traced program's counts (per device) ----
    rec["hlo"] = {
        "flops_per_device": totals.flops,
        "bytes_per_device": totals.bytes,
        "collective_bytes_per_device": totals.collective_bytes,
        "inter_node_collective_bytes_per_device": totals.inter_node_bytes,
        "by_collective": totals.by_collective,
        "n_collectives": totals.n_collectives,
        "trip_warnings": totals.trip_warnings[:8],
        "bytes_by_op": dict(sorted(totals.bytes_by_op.items(),
                                   key=lambda kv: -kv[1])[:12]),
        "flops_by_op": dict(sorted(totals.flops_by_op.items(),
                                   key=lambda kv: -kv[1])[:12]),
        "top_collectives": totals.top_collectives[:8],
    }

    # ---- roofline ----
    n_act = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_act * tokens
    terms = hw.roofline_terms(totals.flops, totals.bytes,
                              totals.collective_bytes, chips,
                              totals.inter_node_bytes)
    dominant = max(terms, key=terms.get)
    hlo_global = totals.flops * chips
    rec["roofline"] = {
        **terms,
        "dominant": dominant,
        "chips": chips,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": model_flops / hlo_global if hlo_global else 0.0,
        "params": count_params(cfg),
        "active_params": n_act,
        "tokens_per_step": tokens,
        # fraction of roofline: useful work time at peak / achievable time
        "roofline_fraction": (model_flops / chips / hw.PEAK_FLOPS_BF16)
        / max(max(terms.values()), 1e-12),
    }
    rec["ok"] = True
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--note", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for mesh_kind in ("single", "multi"):
            for arch in ARCH_IDS:
                for sh in LM_SHAPES:
                    cells.append((arch, sh.name, mesh_kind))
    else:
        cells.append((args.arch, args.shape, args.mesh))
    for arch, shape_name, mesh_kind in cells:
        tag = f"{arch}__{shape_name}__{mesh_kind}"
        if args.note:
            tag += f"__{args.note}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[dryrun] {tag}: exists, skipping")
            continue
        t0 = time.time()
        try:
            rec = run_cell(arch, shape_name, mesh_kind, args.out,
                           attn_impl=args.attn_impl, note=args.note)
        except Exception as e:  # noqa: BLE001
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        rec["wall_s"] = round(time.time() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = ("SKIP" if rec.get("skipped")
                  else "OK" if rec.get("ok") else "FAIL")
        extra = ""
        if rec.get("ok") and not rec.get("skipped"):
            r = rec["roofline"]
            extra = (f" dominant={r['dominant']} "
                     f"frac={r['roofline_fraction']:.3f}"
                     f" live={rec['memory']['live_bytes']/2**30:.2f}GiB")
        print(f"[dryrun] {tag}: {status} ({rec['wall_s']}s){extra}",
              flush=True)


if __name__ == "__main__":
    main()
