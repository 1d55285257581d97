#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``), holds each kernel against its plain PyTorch
version on the card, drives the fused keyed-state plane through NEXMark
q5/q7 and YSB on the card and on the CPU (the plain versions) and
requires equal results, then times the plane over a deployment-size
working set.  Each phase prints one JSON line; any failure raises and
ends the run with a non-zero exit.  The last three lines are the kernels
summary, the card's name and power limit as ``nvidia-smi`` reports them,
and ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1
and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import tac_torch  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.page_gather import page_gather as pg  # noqa: E402
from repro_torch.kernels.tac_probe import tac_probe as tp  # noqa: E402
from repro_torch.kernels.tac_probe.ops import bucket_of  # noqa: E402
from repro_torch.streaming.fused import FusedPlane, FusedSpec, Lane  # noqa: E402
from repro_torch.streaming.nexmark import NexmarkConfig, build_query  # noqa: E402
from repro_torch.streaming.ysb import YSBConfig, build_ysb  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12       # fp32 outside the tensor cores; the probe's
#                                int32 compares are counted at this rate
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# the full-run configuration of BENCH_engine.json / benchmarks/engine.py
E2E = dict(rate=5000.0, duration=6.0, warmup=2.0, cache_entries=2048,
           batch=256, parallelism=2)
DEPLOY_SLOTS = 262_144


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def device_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls queued behind a spin kernel (so host-side launch
    cost is hidden wherever the call does not synchronise)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------ kernel checks
def probe_case(nb, ways, D, B, dtype, seed=0):
    """The reference sweep's construction: even lanes hit keys planted in
    their hashed bucket, odd lanes miss."""
    rng = np.random.default_rng(seed)
    bkeys = rng.choice(max(10_000, 2 * nb * ways), size=(nb, ways),
                       replace=False).astype(np.int32)
    qk = np.where(np.arange(B) % 2 == 0, rng.integers(1, 100_000, B),
                  -(7 + np.arange(B))).astype(np.int32)
    bks = bucket_of(torch.from_numpy(qk), nb).numpy()
    fill = {}
    for i in range(0, B, 2):
        w = fill.get(bks[i], 0)
        if w < ways:
            bkeys[bks[i], w] = qk[i]
            fill[bks[i]] = w + 1
    dev = "cuda"
    q = torch.from_numpy(qk).to(dev)
    return (q, bucket_of(q, nb), torch.from_numpy(bkeys).to(dev),
            torch.randn((nb, ways, D), generator=torch.Generator().manual_seed(
                seed)).to(dtype).to(dev))


def check_probe(nb, ways, D, B, dtype, timed=False):
    args = probe_case(nb, ways, D, B, dtype)
    kv, kh, kw = tp.tac_probe_kernel(*args)
    pv, ph, pw = tp.tac_probe_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kh, ph) and torch.equal(kw, pw)):
        raise AssertionError(f"tac_probe hit/way differ at {nb, ways, D, B}")
    err = max_err(kv, pv)
    if err > TOL[dtype] * (1 + float(pv.float().abs().max())):
        raise AssertionError(f"tac_probe values differ by {err}")
    row = dict(kernel="tac_probe", nb=nb, ways=ways, D=D, B=B,
               dtype=str(dtype).split(".")[-1], hits=int(kh.sum()),
               max_abs_err=err)
    if timed:
        q, buckets, bkeys, bvals = args
        hits = int(kh.sum())
        nbytes = (2 * B * 4 + len(torch.unique(buckets)) * ways * 4
                  + hits * D * bvals.element_size()
                  + B * D * bvals.element_size() + 2 * B * 4)
        b_ms, b_by = bound(nbytes, ops=B * ways)
        row.update(ms=device_ms(lambda: tp.tac_probe_kernel(*args)),
                   plain_ms=device_ms(lambda: tp.tac_probe_plain(*args)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit("kernel_check", **row)
    return row


def page_case(n_slots, page, d, N, dtype, dups=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    pages = torch.randn((n_slots, page, d), generator=g).to(dtype).cuda()
    blocks = torch.randn((N, page, d), generator=g).to(dtype).cuda()
    if dups:
        slots = torch.randint(0, n_slots, (N,), generator=g)
        slots[N // 2] = slots[N - 1] = slots[0]
    else:
        slots = torch.randperm(n_slots, generator=g)[:N]
    return slots.int().cuda(), pages, blocks


def check_gather(n_slots, page, d, N, dtype, timed=False):
    slots, pages, _ = page_case(n_slots, page, d, N, dtype)
    k = pg.page_gather_kernel(slots, pages)
    p = pg.page_gather_plain(slots, pages)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"page_gather differs at {n_slots, page, d, N}")
    row = dict(kernel="page_gather", n_slots=n_slots, page=page, d=d, N=N,
               dtype=str(dtype).split(".")[-1], max_abs_err=max_err(k, p))
    if timed:
        row_bytes = page * d * pages.element_size()
        b_ms, b_by = bound(N * 4 + 2 * N * row_bytes)
        lslots = slots.long()
        row.update(ms=device_ms(lambda: pg.gather_in_range(slots, pages)),
                   plain_ms=device_ms(
                       lambda: pg.page_gather_plain(slots, pages)),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=device_ms(
                       lambda: torch.index_select(pages, 0, lslots)))
    emit("kernel_check", **row)
    return row


def check_scatter(n_slots, page, d, N, dtype, timed=False):
    slots, pages, blocks = page_case(n_slots, page, d, N, dtype)
    k = pg.page_scatter_kernel(slots, blocks, pages.clone())
    p = pg.page_scatter_plain(slots, blocks, pages.clone())
    torch.cuda.synchronize()
    if not torch.equal(k, p) or not torch.equal(k[slots[0].long()],
                                                blocks[N - 1]):
        raise AssertionError(f"page_scatter differs at {n_slots, page, d, N}")
    row = dict(kernel="page_scatter", n_slots=n_slots, page=page, d=d, N=N,
               dtype=str(dtype).split(".")[-1], max_abs_err=max_err(k, p))
    if timed:
        # timed on duplicate-free slots, where index_copy_ is the same
        # function (with duplicates it picks no defined winner)
        slots, pages, blocks = page_case(n_slots, page, d, N, dtype,
                                         dups=False, seed=1)
        k = pg.page_scatter_kernel(slots, blocks, pages.clone())
        lib = pages.clone().index_copy_(0, slots.long(), blocks)
        torch.cuda.synchronize()
        if not torch.equal(k, lib):
            raise AssertionError("page_scatter differs from index_copy_")
        row_bytes = page * d * pages.element_size()
        n_unique = len(torch.unique(slots))
        b_ms, b_by = bound(N * 4 + 2 * n_unique * row_bytes)
        lslots = slots.long()
        row.update(ms=device_ms(
                       lambda: pg.scatter_in_range(slots, blocks, pages)),
                   plain_ms=device_ms(
                       lambda: pg.page_scatter_plain(slots, blocks, pages)),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=device_ms(
                       lambda: pages.index_copy_(0, lslots, blocks)))
    emit("kernel_check", **row)
    return row


def kernel_phase():
    main = {}
    errs = {"tac_probe": 0.0, "page_gather": 0.0, "page_scatter": 0.0}
    W = E2E["cache_entries"]
    for dtype in (torch.float32, torch.bfloat16):
        for nb, ways, D, B in ((16, 8, 64, 32), (8, 4, 128, 16),
                               (32, 16, 32, 64)):
            r = check_probe(nb, ways, D, B, dtype)
            errs["tac_probe"] = max(errs["tac_probe"], r["max_abs_err"])
        for n_slots, page, d, N in ((9, 1, 2, 8), (16, 4, 32, 12),
                                    (64, 16, 8, 40)):
            for check in (check_gather, check_scatter):
                r = check(n_slots, page, d, N, dtype)
                errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
    # the fused path's shapes: one bucket of W ways; pool [W + 1, 1, V + 1]
    main["tac_probe"] = check_probe(1, W, 1, 256, torch.float32, timed=True)
    check_probe(1, DEPLOY_SLOTS, 1, 256, torch.float32, timed=True)
    main["page_gather"] = check_gather(W + 1, 1, 2, 256, torch.float32,
                                       timed=True)
    main["page_scatter"] = check_scatter(W + 1, 1, 2, 256, torch.float32,
                                         timed=True)
    # one bandwidth-sized gather/scatter (serving-like 8 KB pages)
    check_gather(4096, 16, 128, 256, torch.float32, timed=True)
    check_scatter(4096, 16, 128, 256, torch.float32, timed=True)
    for k in main:
        errs[k] = max(errs[k], main[k]["max_abs_err"])
    return main, errs


# ------------------------------------------------------------- end to end
def reset_launches():
    tp.LAUNCHES = pg.GATHER_LAUNCHES = pg.SCATTER_LAUNCHES = 0


def launches():
    return {"tac_probe": tp.LAUNCHES, "page_gather": pg.GATHER_LAUNCHES,
            "page_scatter": pg.SCATTER_LAUNCHES}


def run_query(query: str, device: str):
    c = E2E
    if query == "ysb":
        eng = build_ysb("tac", "async", YSBConfig(rate=c["rate"], seed=11),
                        cache_entries=c["cache_entries"],
                        parallelism=c["parallelism"], source_parallelism=1,
                        io_workers=8, fused=True, fused_batch=c["batch"],
                        device=device)
    else:
        cfg = NexmarkConfig(rate=c["rate"], active_window=1.0, oo_bound=0.3,
                            seed=7)
        eng = build_query(query, "tac", "async", cfg,
                          cache_entries=c["cache_entries"],
                          parallelism=c["parallelism"],
                          source_parallelism=1, io_workers=4,
                          buffer_timeout=0.002, fused=True,
                          fused_batch=c["batch"], device=device)
    t0 = time.perf_counter()
    m = eng.run(duration=c["duration"], warmup=c["warmup"])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {k: m.get(k) for k in ("n_outputs", "p50", "p99",
                                 "stateful_hit_rate", "stateful_fused")}
    return res, wall


def e2e_phase():
    total = {k: 0 for k in launches()}
    for query in ("q5", "q7", "ysb"):
        reset_launches()
        gpu, gpu_wall = run_query(query, "cuda")
        counts = launches()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)       # small CPU ops lose time to threads
        cpu, cpu_wall = run_query(query, "cpu")
        torch.set_num_threads(threads)
        if gpu != cpu:
            raise AssertionError(f"{query}: cuda run {gpu} != cpu run {cpu}")
        if not gpu["n_outputs"] or min(counts.values()) == 0:
            raise AssertionError(f"{query}: no outputs or a kernel never "
                                 f"launched: {counts}")
        for k in total:
            total[k] += counts[k]
        emit("e2e", query=query, equal=True, cuda_wall_s=gpu_wall,
             cpu_wall_s=cpu_wall, launches=counts, **gpu)
    return total


# ------------------------------------------------------- deployment size
def resident_plane(slots: int):
    """A q5-like counting plane with ``slots`` keys resident, and the
    time it took to fill."""
    spec = FusedSpec(kind="sum", width=1, weight_of=lambda tup: 1.0,
                     encode=lambda s: None if s is None else [float(s)],
                     decode=lambda v: int(round(float(v[0]))))
    t0 = time.perf_counter()
    plane = FusedPlane(slots * 96, 96, spec, batch=E2E["batch"],
                       device="cuda")
    for k in range(slots):
        plane.insert(k, 1, 0.0)
    plane._sync()
    torch.cuda.synchronize()
    return plane, spec, time.perf_counter() - t0


def lanes_for(spec, picks):
    return [[Lane(int(k), 1.0, spec.weight(None), False, False, None)
             for k in row] for row in picks]


def plane_phase(slots: int, n_batches: int = 200):
    B = E2E["batch"]
    torch.cuda.reset_peak_memory_stats()
    plane, spec, fill_s = resident_plane(slots)
    picks = np.random.default_rng(3).integers(0, slots,
                                              size=(n_batches + 1, B))
    batches = lanes_for(spec, picks)
    plane.batch_step(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lanes in batches[1:]:
        res = plane.batch_step(lanes)
    wall = time.perf_counter() - t0
    if not res.hit.all():
        raise AssertionError("resident keys missed")
    # every key was counted once at fill, once per pick afterwards
    got = tac_torch.gather_rows(plane.pages, torch.arange(
        slots, dtype=torch.int32, device="cuda"))[:, 0, 1].cpu().numpy()
    want = 1 + np.bincount(picks.ravel(), minlength=slots)
    slot_of = np.array([plane._slot_by_key[k] for k in range(slots)])
    if not np.array_equal(got[slot_of], want.astype(np.float32)):
        raise AssertionError("plane counts differ from the host tally")
    emit("plane", slots=slots, batch=B, batches=n_batches,
         tuples_per_s=n_batches * B / wall, batch_ms=wall / n_batches * 1e3,
         fill_s=fill_s, mem_allocated_bytes=torch.cuda.memory_allocated(),
         mem_peak_bytes=torch.cuda.max_memory_allocated())


def profile_phase(slots: int, n_batches: int = 50, top: int = 12):
    """Where a ``batch_step`` spends its time: the device's busy share
    and the heaviest ops from ``torch.profiler``, and the heaviest Python
    functions from ``cProfile`` (each tool slows the host it watches)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    B = E2E["batch"]
    plane, spec, _ = resident_plane(slots)
    picks = np.random.default_rng(4).integers(0, slots,
                                              size=(2 * n_batches + 1, B))
    batches = lanes_for(spec, picks)
    plane.batch_step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for lanes in batches[1:n_batches + 1]:
            plane.batch_step(lanes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    device_ms = sum(a.self_device_time_total for a in avgs) / 1e3
    per = lambda us: us / 1e3 / n_batches
    host = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)
    dev = sorted(avgs, key=lambda a: a.self_device_time_total, reverse=True)
    emit("profile_torch", slots=slots, batches=n_batches,
         batch_ms=wall_ms / n_batches, device_ms_per_batch=device_ms
         / n_batches, device_busy_share=device_ms / wall_ms,
         host_ops=[[a.key[:60], a.count / n_batches,
                    per(a.self_cpu_time_total)] for a in host[:top]],
         device_ops=[[a.key[:60], a.count / n_batches,
                      per(a.self_device_time_total)] for a in dev[:top]
                     if a.self_device_time_total > 0])
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for lanes in batches[n_batches + 1:]:
        plane.batch_step(lanes)
    pr.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(pr).stats
    rows = sorted(((f"{Path(f).name}:{ln}:{fn}", tt / n_batches * 1e3,
                    ct / n_batches * 1e3)
                   for (f, ln, fn), (_, _, tt, ct, _) in stats.items()),
                  key=lambda r: -r[1])
    emit("profile_python", slots=slots, batches=n_batches,
         batch_ms=wall_ms / n_batches,
         self_ms_per_batch=[list(r) for r in rows[:top]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    build_s = cuda_build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in cuda_build.BUILD_LOG.items()}
    emit("build", seconds=build_s, ptxas=ptxas)
    main_rows, errs = kernel_phase()
    totals = e2e_phase()
    for slots in (E2E["cache_entries"], DEPLOY_SLOTS):
        plane_phase(slots)
    profile_phase(E2E["cache_entries"])
    names = {"tac_probe": ("tac_probe.cu",
                           "src/repro/kernels/tac_probe/tac_probe.py:36"),
             "page_gather": ("page_gather.cu",
                             "src/repro/kernels/page_gather/page_gather.py:26"),
             "page_scatter": ("page_gather.cu",
                              "src/repro/kernels/page_gather/page_gather.py:50")}
    kernels = [dict(name=k, route="cuda",
                    source=f"src/repro_torch/csrc/{names[k][0]}",
                    replaces=names[k][1], launches=totals[k],
                    max_abs_err=errs[k], ms=main_rows[k]["ms"],
                    plain_ms=main_rows[k]["plain_ms"],
                    bound_ms=main_rows[k]["bound_ms"],
                    bound_by=main_rows[k]["bound_by"],
                    library_ms=main_rows[k]["library_ms"])
               for k in ("tac_probe", "page_gather", "page_scatter")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
