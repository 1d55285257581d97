#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch``), holds each kernel against its plain PyTorch
version on the card, drives the fused keyed-state plane (one kernel
launch a batch, one an admission chunk) through NEXMark q5/q7 and YSB on
the card and on the CPU (the plain versions) and requires equal results,
then runs the paper's own mode, Keyed Prefetching, on the fused plane:
q5 and q7 in ``prefetch`` mode on the card and the CPU (equal results)
and in ``sync`` mode on the card; then the fault-tolerance plane at
BENCH_recovery.json's q5 configuration (checkpoints, a cold and a warmed
crash and restore of the device plane, equal to the CPU's warmed run, no
tensor in any snapshot record, card memory after two crashes within one
plane of an unfailed run's) and the exactly-once count per key on the
card against the golden run.  The step kernel takes any batch: its
rows reach B 16,384 and V 300, and q5 and YSB run fused at batches of
1024 lanes on the card, equal to the CPU.  Then it times the plane over
a deployment-size working set at batches of 256, 1024 and 4096.  K2 (page
gather) is held bit for bit at the shapes it launches at, in fp32 and
bf16, with duplicate and out-of-range slots, and timed back to back over
disjoint slot sets of its pool beside ``index_select``; K4 (count-min
sketch) at the hint
filter's sketch, at B 16,384 and saturating; each timed row's gate must
reject a planted fault; K5 (paged decode attention) at every width up to
(576, 512), MLA's latent timed on its wgmma route in bf16 and on the
TF32 walk in fp32.  Then it serves paged session state (arena,
tiered store, continuous-batching scheduler, paged decode attention at
qwen2.5-32b's attention width) in ``sync`` and ``prefetch`` mode on the
card and on the CPU and requires identical serving stats, classifies
the q5 bid stream's keys through ``HintFilter(device="cuda")``, whose
count-min sketch stays on the card, against a CPU filter, and drives the
rest of the device TAC (lookup, the sequential and the shard-owned admit,
shard ownership, watermark expiry, the barrier's dirty flush and a
migration between shards) over four shards of 65,536 slots on the card
and on the CPU, bit-equal after every call.  Then the LM
serving path: zamba2-2.7b, rwkv6-3b, qwen3-moe-30b-a3b,
llava-next-mistral-7b and seamless-m4t-large-v2 at their published width
and depth, and deepseek-v2-236b at its width cut to seven layers (bf16,
seeded weights), prefill 4 requests of 2048 tokens and decode 16 tokens
through the flash-attention (every prefill, encoder and cross-attention),
SSD-scan and RWKV6-scan kernels, with the prefill/decode consistency check
and the card held against the CPU at cut depth; and ``launch/serve.py``'s
``run_serving`` serves gemma-7b, zamba2-2.7b, rwkv6-3b and
deepseek-v2-236b (smoke models) in ``sync`` and ``prefetch`` mode,
prefetch beating sync.  Last, training: K6's backward kernel is held
against autograd through its plain version at every head-dim pair and
timed at gemma-7b's, llava-next-mistral-7b's and deepseek-v2's MLA
training shapes beside SDPA's backward, two runs bit-equal; so are the
backward kernels of the SSD scan (fp32, bf16, one tensor-core design)
and the RWKV6 scan (fp32) at every chunk and state size the zoo reaches
and the SSD scan's at d_state 128, timed at zamba2-2.7b's, mamba2-2.7b's
and rwkv6-3b's training shapes, each gate rejecting a planted fault;
then every width past the kernels' instances (``wide_phase``: K7 at
head dims 128 and 96 and states of 256 and 160 rows, K8 at states of 128
and 96, K6 at (d, dv) past 256, K5 at keys past 576 or values past 512),
forward and backward against the plain versions, and each lifted axis
timed at a zoo family's total width (K6's bf16 wgmma route also at
DeepSeek-V2's absorbed MLA width, each plan held to its source's);
gemma-7b at its published width, cut to 8 of its 28 layers, and
zamba2-2.7b and rwkv6-3b at their published width and depth take AdamW
steps of 4 x 2048 tokens through the port's data pipeline, train step
and optimizer (losses falling, each arch's kernels launched forward and
backward), and so does zamba2-2.7b's config at d_state 128 (8 layers);
each step at 2 layers in fp32 on the card equals the CPU's;
and
``examples/train_lm_torch.py`` recovers from an injected failure under
the supervisor and converges.  Then the examples: the serving examples,
``examples/quickstart_torch.py --fused`` (the paper's fraud-detection
pipeline) and the engine's ``tools/obs_report_torch.py --fused`` printing
on the card what they print on the CPU; gemma-7b's
steps on a one-rank NCCL mesh; and two dry-run cells.
Each phase prints one JSON line; any failure raises and ends the run with a
non-zero exit.  The last three lines are the kernels summary, the card's
name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import gc
import importlib.util
import io
import itertools
import json
import math
import os
import pickle
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (count_params, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.core import tac_torch  # noqa: E402
from repro_torch.core.hint_filter import HintFilter  # noqa: E402
from repro_torch.kernels import costs, cuda_build  # noqa: E402
from repro_torch.kernels.costs import rwkv_bwd_flops  # noqa: E402,F401
from repro_torch.kernels.cms_sketch import cms_sketch as cms  # noqa: E402
from repro_torch.kernels.cms_sketch import ops as cms_ops  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as da  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    paged_decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_scan as ms  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels.page_gather import page_gather as pg  # noqa: E402
from repro_torch.kernels.tac_fused import tac_fused as tfk  # noqa: E402
from repro_torch.kernels.tac_probe import tac_probe as tp  # noqa: E402
from repro_torch.kernels.tac_probe.ops import bucket_of  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import hw  # noqa: E402
from repro_torch.launch.serve import (GraphedStep,  # noqa: E402
                                      ServeConfig, StatePager, _grow_kv,
                                      decode_step, run_serving, tree_flatten,
                                      tree_unflatten)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.train import build_training  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 PagedStateArena, Request, ServingMetrics,
                                 SimClock, TieredStore)
from repro_torch.streaming.backend import (LOCAL_NVME,  # noqa: E402
                                          BackendModel)
from repro_torch.streaming.engine import (Engine, SourceOp,  # noqa: E402
                                         StatefulOp)
from repro_torch.streaming.fused import FusedPlane, FusedSpec, Lane  # noqa: E402
from repro_torch.streaming.nexmark import (BID, NexmarkConfig,  # noqa: E402
                                          NexmarkGen, build_query)
from repro_torch.streaming.shards import hash_partition  # noqa: E402
from repro_torch.streaming.recovery import (  # noqa: E402
    CheckpointCoordinator, SnapshotStore, inject_failure_at)
from repro_torch.streaming.ysb import YSBConfig, build_ysb  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit), from
# the port's one source of them (src/repro_torch/launch/hw.py)
HBM_BYTES_PER_S = hw.HBM_BW
SCALAR_OPS_PER_S = hw.PEAK_FLOPS_FP32   # fp32 outside the tensor cores;
#                                the probe's int32 compares count at it
BF16_OPS_PER_S = hw.PEAK_FLOPS_BF16     # bf16 on the tensor cores (dense)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# the full-run configuration of BENCH_engine.json / benchmarks/engine.py
E2E = dict(rate=5000.0, duration=6.0, warmup=2.0, cache_entries=2048,
           batch=256, parallelism=2)
# the prefetch phase's run after its 2 s warm-up: BENCH_engine.json's 6 s
# cut to 3 s, to keep the script's time (PERF.md section 4)
PREFETCH_DURATION = 3.0
# the card-against-CPU comparison of q5 and q7 (``e2e``, ``prefetch``): both
# run the same events of a shorter stream, 0.5 s of warm-up and 2 s after
# it, which closes q7's first window (the CPU side of the full runs took
# ~125-220 s of the script's time); the card's metrics come from its
# full-length run
COMPARE = dict(duration=2.0, warmup=0.5)
# BENCH_recovery.json's q5 configuration (benchmarks/recovery.py FULL and
# run_one: replayable source, replay x2.0), on the fused plane in the
# paper's mode, Keyed Prefetching; its 9 s run cut to 6 s, to keep the
# script's time (PERF.md section 4)
RECOVERY = dict(rate=5000.0, active_window=1.0, oo_bound=0.3,
                window_size=1.0, window_slide=0.5, cache_entries=256,
                io_workers=4, buffer_timeout=0.002, ckpt_interval=0.8,
                fail_at=3.1, duration=6.0, warmup=1.0, replay_speedup=2.0,
                batch=256, parallelism=2, spike_window=0.6)
# the second failure of the memory check's run, after the end of warm-up
SECOND_FAIL_AT = 4.7
DEPLOY_SLOTS = 262_144
# timing of a kernel of a few microseconds behind a Python wrapper that
# takes ~0.05-0.1 ms of host time a call: 100 calls behind a ~28 ms spin
LAUNCH_BOUND = dict(reps=100, rounds=5, spin=50_000_000)
# the serving path: launch/serve.py's ServeConfig (sessions, arena size,
# load, batch, pages of 8192 fp32 elements, store model) at qwen2.5-32b's
# attention width (configs/qwen2_5_32b.py: 40 query heads, 8 KV heads,
# head dim 128), one layer, a 4096-token context per session.  The arena
# has 8 ways a bucket, not run_serving's 4: a session's 520 page keys put up
# to 4 keys in one of 1040 buckets, so with 4 ways the pages of a batch of
# four sessions evict each other during sync staging
SERVE = dict(sessions=24, cache_sessions=8, requests=48, rate=400.0, ways=8,
             max_batch=4, decode_tokens=4, page=64, head_dim=128, kv_heads=8,
             q_heads=40, context=4096, store_latency=0.012,
             store_bandwidth=1.2e9, decode_s=0.8e-3, seed=0)
SERVE_POOL = SERVE["ways"] * math.ceil(          # the arena's slots: 4160
    SERVE["cache_sessions"] * SERVE["kv_heads"]
    * (SERVE["context"] // SERVE["page"] + 1) / SERVE["ways"])
PAGE_KEY_STRIDE = 4096         # page key = sid * stride + page_idx + 1
# decode_32k (configs/base.py) at qwen2.5-32b's attention width
DECODE_32K = dict(seqs=128, kv_heads=8, q_heads=40, head_dim=128,
                  seq_len=32768, page=64, plain_seqs=16)
# the earlier designs' times at the timed shapes (K6 on the CUDA cores in
# fp32, K5 one block per row, K7 one block per (b, h) walking the chunks,
# K8 one thread per state column), NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md's kernel table), printed beside the new ones
EARLIER_MS = {("flash_attention", "zamba2-2.7b prefill"): 5.517548751831055,
              # K6 past 256 on the CUDA cores in fp32 for both types
              # (the wide kernel's first design; its wide_phase row)
              ("flash_attention", "(512, 512) x 8 heads"): 25.38165740966797,
              ("flash_attention_bwd", "(512, 512) x 8 heads"):
                  91.21710205078125,
              ("flash_attention", "gemma-7b prefill"): 17.322079467773438,
              ("decode_attention", "serve"): 0.8877887725830078,
              ("decode_attention", "decode_32k"): 11.61456044514974,
              # K5 past (576, 512) on route 3's first design (the CUDA
              # cores), as tools/decode_kernel_ab.py timed it
              ("decode_attention", "(1024, 1024) decode fp32"): 0.94257,
              ("decode_attention", "(1001, 1000) decode bf16"): 0.98173,
              # K5 at MLA's latent before route 5 (bf16: route 1's
              # decode_wide_kernel<576, 512>, 16 heads a block; fp32: the
              # lanes, 4 heads a block), as this script timed them
              ("decode_attention", "deepseek-v2 MLA latent decode"): 0.21699,
              ("decode_attention", "deepseek-v2 MLA latent decode fp32"):
                  0.83697,
              ("mamba2_scan", "zamba2-2.7b prefill"): 4.04290542602539,
              ("rwkv6_scan", "rwkv6-3b prefill"): 1.0247103691101074,
              # K6's backward on mma.sync, 16 keys a dK/dV block at d 256
              # (gemma-7b as chip_smoke.py timed it; the llava and MLA
              # shapes by tools/flash_bwd_variants.py)
              ("flash_attention_bwd", "gemma-7b train"): 4.040746688842773,
              ("flash_attention_bwd", "llava-next-mistral-7b train"):
                  2.887674649556478,
              ("flash_attention_bwd", "deepseek-v2-236b MLA train"):
                  4.7529120445251465,
              # K7's backward fp32 on the CUDA cores for both types, K8's a
              # block a column tile with the tiles' partials summed apart
              ("mamba2_scan_bwd", "zamba2-2.7b train"): 8.317504247029623,
              ("rwkv6_scan_bwd", "rwkv6-3b train"): 4.4280961354573565,
              # K4 four blocks ranking lanes by B^2 compares (warm, as
              # device_ms times it)
              ("cms_sketch", "hint_filter"): 0.009600000083446502,
              # K2 one 128-thread block a row, timed like its rows below
              # (rotating_ms over slot_sets) by tools/gather_variants.py
              # on an H100 80GB HBM3 at 700 W
              ("page_gather", "serve append"): 0.004440769237967638,
              ("page_gather", "batch 256"): 0.007637120187282562,
              ("page_gather", "fused N 1"): 0.0021135227027698706,
              ("page_gather", "fused N 256"): 0.002297279983758926,
              ("page_gather", "serve_lm zamba2-2.7b"): 0.0030500799417495727,
              ("page_gather", "8 KB rows"): 0.0029710400104522704,
              # K1's fused step with the 256-lane cap (PR 16's design: the
              # tail a thread a lane, 256-bit lane masks)
              ("tac_fused_step", "sum W 2048 B 256"): 0.008481280207633972,
              ("tac_fused_step", "sum W 262144 B 256"):
                  0.011991679668426514}
ROTATE_LEAST = 100             # rotating_ms's fewest calls a round
ROTATE_BATCH = 128             # its calls a spin, within the launch queue


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_clocks() -> str:
    """The card's SM clock and its maximum, power draw and limit and
    temperature now, as ``nvidia-smi`` reads them: two runs' times compare
    only at like clocks."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def device_ms(fn, reps: int = 20, rounds: int = 7,
              spin: int = 2_000_000) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls queued behind a spin kernel of ``spin`` cycles (so
    host-side launch cost is hidden wherever the call does not synchronise
    and the host queues the calls within the spin)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def slot_sets(n_slots: int, N: int, seed: int = 1):
    """Disjoint duplicate-free sets of ``N`` slots that together cover all
    but ``n_slots % N`` slots of the pool, in a random order."""
    perm = torch.randperm(n_slots, generator=torch.Generator()
                          .manual_seed(seed)).int().cuda()
    return list(perm[:n_slots // N * N].reshape(-1, N))


def rotating_ms(call, sets, rounds: int = 5) -> float:
    """Median device time of one ``call(x)``, back to back over the
    ``sets`` in turn (at least ``ROTATE_LEAST`` calls a round).  Over
    ``slot_sets`` of a pool larger than the L2 each call finds its rows
    cold, as the serving arena's launches do; a pool within the L2 is
    warm, as the fused plane's is.  The calls go in batches of
    ``ROTATE_BATCH``, each between one pair of CUDA events and queued
    behind its own spin: a longer batch would fill the card's launch
    queue and wait on the host."""
    it = itertools.cycle(sets)
    n = max(len(sets), ROTATE_LEAST)
    call(next(it))
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        total = 0.0
        for lo in range(0, n, ROTATE_BATCH):
            torch.cuda._sleep(LAUNCH_BOUND["spin"])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(min(ROTATE_BATCH, n - lo)):
                call(next(it))
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        out.append(total / n)
    return statistics.median(out)


def peak_for(dtype) -> float:
    """The card's peak rate for operands of ``dtype``: the bf16 tensor-core
    peak for bf16, the fp32 peak otherwise (fp32 products are held to
    2e-5, so TF32 is no option), whatever units a kernel itself uses."""
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else SCALAR_OPS_PER_S


def bound(nbytes: float, ops: float = 0.0, peak: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def build_facts(source: str, *needles: str):
    """ptxas's registers, static shared memory, stack and spill bytes for
    each kernel of ``csrc/<source>.cu`` whose mangled name holds one of
    ``needles`` (a template instance), from this run's build."""
    return {fn: facts for fn, facts in cuda_build.ptxas_report(source).items()
            if any(n in fn for n in needles)}


def timed_extras(kernel: str, label: str, ms: float, b_ms: float) -> dict:
    """The share of the bound a timed row reached and its earlier time."""
    return dict(bound_share=b_ms / ms if ms else None,
                earlier_ms=EARLIER_MS.get((kernel, label)))


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


def check_probe(nb, ways, D, B, dtype, timed=False, exact=False):
    """K1 against its plain version; ``exact`` rows (one planted key a
    bucket way, so a matched row is summed alone) must be bit-equal and
    count one launch, and print the kernel's tiles of value columns."""
    args = probe_case(nb, ways, D, B, dtype)
    before = tp.LAUNCHES
    kv, kh, kw = tp.tac_probe_kernel(*args)
    launched = tp.LAUNCHES - before
    pv, ph, pw = tp.tac_probe_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kh, ph) and torch.equal(kw, pw)):
        raise AssertionError(f"tac_probe hit/way differ at {nb, ways, D, B}")
    err = max_err(kv, pv)
    if err > TOL[dtype] * (1 + float(pv.float().abs().max())):
        raise AssertionError(f"tac_probe values differ by {err}")
    if exact and not (torch.equal(kv, pv) and launched == 1):
        raise AssertionError(f"tac_probe at D {D} {dtype}: not bit-equal to "
                             f"its plain version ({err}) or {launched} "
                             f"launches")
    row = dict(kernel="tac_probe", nb=nb, ways=ways, D=D, B=B,
               dtype=str(dtype).split(".")[-1], hits=int(kh.sum()),
               max_abs_err=err, launches=launched,
               d_tiles=len(tp.d_tiles(D)))
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


def gather_shapes():
    """K2's shapes, label -> (n_slots, page, d, N): (a) the serve phase's
    append, one request's 8 KV-head rows of its last page ([64, 128] fp32,
    32 KB) from the arena's 4160-slot pool (136 MB, past the L2); (b) a
    batch of 256 such rows (the arena's dirty-victim gather, router
    migration); (c) the fused plane's single-key reads (``gather_rows``:
    rows [1, 2] fp32 of a 2049-slot pool), N 1 and 256; (d) ``serve_lm``'s
    zamba2-2.7b state pages ([8192, 1] fp32), one session's 3 pages from
    run_serving's arena of 4-way buckets for 6 sessions; and the 8 KB rows
    the earlier design was timed at."""
    zamba2_pages = ZAMBA2_STATE_PAGES
    return {"serve append": (SERVE_POOL, SERVE["page"], SERVE["head_dim"],
                             SERVE["kv_heads"]),
            "batch 256": (SERVE_POOL, SERVE["page"], SERVE["head_dim"], 256),
            "fused N 1": (E2E["cache_entries"] + 1, 1, 2, 1),
            "fused N 256": (E2E["cache_entries"] + 1, 1, 2, 256),
            "serve_lm zamba2-2.7b": (
                4 * math.ceil(SERVE_LM["cache_sessions"] * zamba2_pages / 4),
                8192, 1, zamba2_pages),
            "8 KB rows": (4096, 16, 128, 256)}


def gather_expected(slots, pages):
    """The plain version under the kernel's rule for a slot outside
    [0, n_slots): a row of zeros."""
    ok = (slots >= 0) & (slots < pages.shape[0])
    rows = pg.page_gather_plain(torch.where(ok, slots, 0), pages)
    return torch.where(ok[:, None, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


def gather_chunk_dropped(slots, pages, sms=None):
    """A planted fault: the gather with the last chunk of row 0 of the
    kernel's plan left at zero, as a launch that lost a block."""
    out = gather_expected(slots, pages)
    n = out.shape[0]
    row_bytes = out[0].numel() * out.element_size()
    unit = pg.copy_unit(row_bytes, pages, out)
    plan = pg.plan_gather(n, row_bytes, unit,
                          sms or cuda_build.sm_count(pages.device))
    row0 = out.reshape(n, -1)[0].view(torch.uint8)
    row0[(plan.blocks // n - 1) * plan.chunk_units * unit:] = 0
    return out


def check_gather(n_slots, page, d, N, dtype, label=None, timed=False):
    """K2 against its plain version, bit for bit: on slots with duplicates
    through ``page_gather_kernel``, and with every fourth slot out of range
    (-1 or n_slots) through ``gather_in_range``, where the kernel writes
    zeros.  Timed rows take the disjoint ``slot_sets`` of the pool,
    require the gate to reject a planted fault (``gather_chunk_dropped``)
    on the first, and time the kernel, the plain version,
    ``index_select`` and an empty launch each by ``rotating_ms`` over all
    of them; they add the bound and its share, the earlier design's time
    and the plan."""
    slots, pages, _ = page_case(n_slots, page, d, N, dtype)
    odd = slots.clone()
    idx = torch.arange(0, N, 4, device=odd.device)
    odd[::4] = torch.where(idx % 8 == 0, -1, n_slots).int()
    k = pg.page_gather_kernel(slots, pages)
    p = pg.page_gather_plain(slots, pages)
    ko = pg.gather_in_range(odd, pages)
    po = gather_expected(odd, pages)
    torch.cuda.synchronize()
    if not (torch.equal(k, p) and torch.equal(ko, po)):
        raise AssertionError(f"page_gather differs at {n_slots, page, d, N}")
    row = dict(kernel="page_gather", shape=label, n_slots=n_slots, page=page,
               d=d, N=N, dtype=dtype_name(dtype),
               out_of_range=len(idx),
               max_abs_err=max(max_err(k, p), max_err(ko, po)))
    if timed:
        sets = slot_sets(n_slots, N)
        lsets = [x.long() for x in sets]
        free = sets[0]
        good = pg.gather_in_range(free, pages)
        fault = gather_chunk_dropped(free, pages)
        if not torch.equal(good, pg.page_gather_plain(free, pages)):
            raise AssertionError(f"page_gather differs at {label}")
        if torch.equal(fault, good):
            raise AssertionError(f"page_gather at {label}: the check would "
                                 f"pass a gather that lost a chunk")
        row_bytes = page * d * pages.element_size()
        unit = pg.copy_unit(row_bytes, pages, good)
        b_ms, b_by = bound(N * 4 + 2 * N * row_bytes)
        t_ms = rotating_ms(lambda x: pg.gather_in_range(x, pages), sets)
        row.update(ms=t_ms,
                   plain_ms=rotating_ms(
                       lambda x: pg.page_gather_plain(x, pages), sets),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=rotating_ms(
                       lambda x: torch.index_select(pages, 0, x), lsets),
                   library="torch.index_select(pages, 0, slots)",
                   empty_launch_ms=rotating_ms(
                       lambda x: torch.cuda._sleep(0), sets),
                   **timed_extras("page_gather", label, t_ms, b_ms),
                   planted_fault_max_abs_err=max_err(fault, good),
                   slot_sets=len(sets), unit=unit,
                   plan=pg.plan_gather(N, row_bytes, unit,
                                       cuda_build.sm_count(pages.device))
                   ._asdict())
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


# ------------------------------------------------------- fused plane kernels
def fused_case(W, B, V, batch, int_weights=True, seed=0):
    """A fused plane's directory (one bucket of W ways, about 3/4 resident,
    with timestamps, dirty bits, payloads and presence flags) and pool on
    the card, and a batch of B lanes, as tests/test_torch_tac.py builds
    them.  ``mixed``: resident keys with a key four times, a key at lanes
    255 and 256 and one at 1023 and 1024 (where B reaches them), misses,
    fire lanes, an invalid lane and three PAD_KEY padding lanes; ``hot``: every
    lane one resident key, fire lanes among them; ``empty``: mixed, with
    query keys of -1 against a directory with empty ways.  Returns (state,
    pages, lanes on the card, lanes as numpy arrays)."""
    rng = np.random.default_rng(seed)
    keys = np.full(W, -1, np.int32)
    live = rng.random(W) < 0.75
    keys[live] = rng.permutation(4 * W)[:int(live.sum())]
    ts = np.where(live, rng.random(W) * 10, -np.inf).astype(np.float32)
    dirty = live & (rng.random(W) < 0.3)
    pages = np.zeros((W + 1, 1, V + 1), np.float32)
    pages[:W, 0, 0] = live & (rng.random(W) < 0.8)
    pages[:W, 0, 1:] = rng.integers(0, 50, (W, V)) * pages[:W, 0, :1]
    resident = keys[live]
    if batch == "hot":
        q = np.full(B, resident[0], np.int32)
        valid = np.ones(B, bool)
    else:
        n = B - 3
        q = np.where(rng.random(n) < 0.7, rng.choice(resident, n),
                     rng.integers(4 * W, 5 * W, n))
        q[1] = q[n // 2] = q[n - 1] = q[0]
        if batch == "empty":
            q[2::7] = -1
        for a, b in ((255, 256), (1023, 1024)):   # a key across the old
            if b < n:                             # cap and a tail tile's end
                q[b] = q[a]
        q = np.concatenate([q, [FusedPlane.PAD_KEY] * 3]).astype(np.int32)
        valid = np.arange(B) < n
        valid[5] = False
    lts = (rng.random(B) * 20).astype(np.float32)
    w = (rng.integers(1, 9, (B, V)) if int_weights
         else rng.standard_normal((B, V))).astype(np.float32)
    fire = rng.random(B) < 0.2
    lanes_np = (q, lts, w, fire, valid)
    state, pg_ = tac_torch.from_numpy(keys[None], ts[None],
                                      np.zeros((1, W, 1), np.float32),
                                      dirty[None], pages, "cuda")
    return state, pg_, tuple(torch.from_numpy(a).cuda() for a in lanes_np), \
        lanes_np


def clone_plane(state, pages):
    return tac_torch.TACState(*(t.clone() for t in state)), pages.clone()


def fused_step_no_compose(state, pages, keys, ts, weights, fire, valid,
                          kind):
    """A planted fault: the batch step without the duplicate-key
    composition (each lane folds in its own update only) and with a key's
    FIRST update lane writing back instead of its last; from plain PyTorch,
    IN PLACE.  Returns what ``fused_step_plain`` returns."""
    W = state.keys.shape[1]
    _, hit, way = tp.tac_probe_plain(keys, bucket_of(keys, 1), state.keys,
                                     state.vals)
    hit = hit.bool()
    rows = pages[torch.where(hit, way, W).long(), 0]
    hit = hit & valid
    slots = torch.where(hit, way, W).int()
    upd = torch.zeros_like(hit) if kind == "read" else hit & ~fire
    f, g = rows[:, 0] > 0.5, rows[:, 1:]
    if kind == "max":
        new_v = torch.maximum(torch.where(f[:, None], g, -float("inf")),
                              torch.where(upd[:, None], weights,
                                          -float("inf")))
    else:
        new_v = torch.where(f[:, None], g, 0.0) + upd[:, None] * weights
    present = f | upd
    new_v = torch.where(present[:, None], new_v, 0.0)
    at = torch.where(hit, slots, 0).long()
    state.ts.view(-1).scatter_reduce_(
        0, at, torch.where(hit, ts, -float("inf")), "amax")
    if kind != "read":
        first = upd.nonzero().flatten().flip(0)   # last write wins: reversed
        blocks = torch.cat([present[:, None].float(), new_v], 1)[:, None]
        pg.page_scatter_plain(slots[first], blocks[first], pages)
        state.dirty.view(-1).view(torch.uint8).scatter_reduce_(
            0, at, upd.to(torch.uint8), "amax")
    tallies = torch.stack([hit.sum(), (valid & ~hit).sum()]).int()
    return hit, slots, new_v, present, tallies


def fsum_tolerance(lanes, ref, pages, kind):
    """A bound on |kernel - plain| for each lane's new values from float
    weights, for batches past 256 lanes: the kernel sums a key's update
    lanes in lane order, the plain version in a matrix product's order,
    and each differs from the exact sum by at most gamma_n S (recursive
    summation: n terms, the row's value one of them, gamma_n = n u / (1 -
    n u), u = 2^-24; S the terms' magnitudes, the row's bounded by the
    pool's largest).  n is the key's update lanes up to the lane, so the
    bound grows with the longest key run.  Returns 2e-5 (1 + |plain|) +
    2 gamma_n S, [B, V], float64."""
    keys, _, w, fire, _ = lanes
    hit = ref[0]
    upd = torch.zeros_like(hit) if kind == "read" else hit & ~fire
    B = keys.shape[0]
    M = (keys[:, None] == keys[None, :]) & upd[None, :] & torch.ones(
        (B, B), dtype=torch.bool, device=keys.device).tril()
    n = M.sum(1, keepdim=True).double() + 1
    S = M.double() @ w.double().abs() + float(pages.abs().max())
    u = 2.0 ** -24
    return TOL[torch.float32] * (1 + ref[2].double().abs()) \
        + 2 * n * u / (1 - n * u) * S


def fused_step_agrees(out, plane, ref, ref_plane, exact: bool, tol=None):
    """Every output and the directory and pool of a batch step equal the
    plain version's: bit for bit, or (``exact`` False: float weights, whose
    sums the plain version takes in another order) new values and pool
    within tests/test_torch_tac.py's 2e-5, or within ``tol`` (per new
    value, ``fsum_tolerance``; the pool within its largest).  Returns
    (agrees, max_abs_err)."""
    ok = all(torch.equal(a, b) for a, b in zip(out[:2] + out[3:],
                                               ref[:2] + ref[3:]))
    ok &= all(torch.equal(a, b) for a, b in zip(plane[0], ref_plane[0]))
    err = max(max_err(out[2], ref[2]), max_err(plane[1], ref_plane[1]))
    if exact:
        ok &= torch.equal(out[2], ref[2]) and torch.equal(plane[1],
                                                          ref_plane[1])
    elif tol is None:
        ok &= allclose(out[2], ref[2], TOL[torch.float32]) and allclose(
            plane[1], ref_plane[1], TOL[torch.float32])
    else:
        ok &= bool(((out[2] - ref[2]).double().abs() <= tol).all()) and bool(
            ((plane[1] - ref_plane[1]).double().abs()
             <= (tol.max() if tol.numel() else 0.0)).all())
    return ok, err


def check_fused_step(W, B, V, kind, batch, int_weights=True, timed=False,
                     fault=False):
    """``tac_fused_step`` against ``fused_step_plain`` on the same directory,
    pool and lanes (each on its own copy); with ``fault`` the gate must
    also reject ``fused_step_no_compose``.  Timed rows time the packed
    entry point the plane calls (one launch), the plain version, and the
    bound: bytes (the W directory keys, the lanes, the rows, timestamps
    and dirty bits the batch reads and writes, the outputs) or operations
    (W table lookups, B inserts, and V compose steps for each pair of
    lanes of one key, j <= i), at the fp32 scalar peak; ``bound_all_rows_ms``
    counts every lane reading and writing a row.  Float weights past 256
    lanes are held within ``fsum_tolerance``."""
    state, pages, lanes, lanes_np = fused_case(W, B, V, batch, int_weights)
    kplane = clone_plane(state, pages)
    out = tfk.fused_step(*kplane, *lanes, kind)
    rplane = clone_plane(state, pages)
    ref = tfk.fused_step_plain(*rplane, *lanes, kind)
    tol = None if int_weights or B <= 256 else fsum_tolerance(lanes, ref,
                                                              pages, kind)
    torch.cuda.synchronize()
    ok, err = fused_step_agrees(out, kplane, ref, rplane, int_weights, tol)
    if not ok:
        raise AssertionError(f"tac_fused_step differs at W {W}, B {B}, V "
                             f"{V}, {kind}, {batch}: {err}")
    row = dict(kernel="tac_fused_step", W=W, B=B, V=V, kind=kind,
               batch=batch, weights="int" if int_weights else "float",
               hits=int(ref[4][0]), misses=int(ref[4][1]),
               max_abs_err=err,
               tolerance=0.0 if int_weights else (
                   TOL[torch.float32] if tol is None
                   else float(tol.max()) if tol.numel() else 0.0))
    if fault:
        fplane = clone_plane(state, pages)
        bad = fused_step_no_compose(*fplane, *lanes, kind)
        passes, row["planted_fault_max_abs_err"] = fused_step_agrees(
            bad, fplane, ref, rplane, int_weights, tol)
        if passes:
            raise AssertionError(f"tac_fused_step at W {W}, {kind}, {batch}:"
                                 f" the check would pass the step without "
                                 f"the duplicate-key composition")
    if timed:
        q, _, _, fire, _ = lanes_np
        hit = ref[0].cpu().numpy()
        slots = ref[1].cpu().numpy()
        upd = hit & ~fire if kind != "read" else np.zeros_like(hit)
        n_rows = len(np.unique(slots))
        n_hit, n_upd = len(np.unique(slots[hit])), len(np.unique(slots[upd]))
        R = 4 * (V + 1)
        nbytes = (4 * W + B * (10 + 4 * V) + n_rows * R + 8 * n_hit
                  + n_upd * (R + 1) + (R if kind != "read" else 0)
                  + 4 * tfk.step_out_words(B, V))
        _, counts = np.unique(q, return_counts=True)
        ops = W + B + V * int((counts * (counts + 1) // 2).sum())
        b_ms, b_by = bound(nbytes, ops=ops)
        all_rows = (4 * W + B * (10 + 4 * V) + 4 * tfk.step_out_words(B, V)
                    + 8 * B * (V + 1))
        fields = tfk.step_in_fields(B, V)
        packed = torch.from_numpy(tfk.fill(
            np.zeros(tfk.nbytes(fields), np.uint8), fields,
            *lanes_np)).cuda()
        row.update(ms=device_ms(lambda: tfk.fused_step_packed(
                       *kplane, packed, B, kind), **LAUNCH_BOUND),
                   plain_ms=device_ms(lambda: tfk.fused_step_plain(
                       *rplane, *lanes, kind),
                       **(PLAIN_WIDE if B > 1024 else {})),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   bound_all_rows_ms=bound(all_rows)[0],
                   library="none: no single PyTorch call probes, composes "
                           "and writes back a batch",
                   blocks=tfk._lib().tac_fused_step_blocks(B, W),
                   build=build_facts("tac_fused", "fused_step"))
        row.update(timed_extras("tac_fused_step", f"{kind} W {W} B {B}",
                                row["ms"], b_ms))
    emit("kernel_check", **row)
    return row


def check_fused_admit(W, N, V, n_distinct, timed=False, seed=1):
    """``tac_fused_admit`` against ``fused_admit_plain``: ``n_distinct``
    records at distinct slots, padded to N by repeating the first record
    (as ``FusedPlane._flush_admits`` pads a chunk); victim rows, pool and
    directory bit for bit.  Timed rows time the packed entry point, the
    plain version, and the bytes bound (the records, the victim rows read
    and written out, the rows and directory entries written, the scratch
    row)."""
    state, pages, _, _ = fused_case(W, 8, V, "mixed", seed=seed)
    rng = np.random.default_rng(seed)
    recs = [rng.choice(W, n_distinct, replace=False).astype(np.int32),
            rng.integers(0, 8 * W, n_distinct).astype(np.int32),
            (rng.random(n_distinct) * 9).astype(np.float32),
            rng.standard_normal((n_distinct, V)).astype(np.float32),
            rng.random(n_distinct) < 0.7, rng.random(n_distinct) < 0.5]
    recs = [np.concatenate([a, np.repeat(a[:1], N - n_distinct, 0)])
            for a in recs]
    args = tuple(torch.from_numpy(a).cuda() for a in recs)
    kplane = clone_plane(state, pages)
    kv = tfk.fused_admit(*kplane, *args)
    rplane = clone_plane(state, pages)
    rv = tfk.fused_admit_plain(*rplane, *args)
    torch.cuda.synchronize()
    if not (torch.equal(kv, rv) and torch.equal(kplane[1], rplane[1])
            and all(torch.equal(a, b) for a, b in zip(kplane[0],
                                                      rplane[0]))):
        raise AssertionError(f"tac_fused_admit differs at W {W}, N {N}, "
                             f"V {V}")
    row = dict(kernel="tac_fused_admit", W=W, N=N, V=V, distinct=n_distinct,
               max_abs_err=max(max_err(kv, rv),
                               max_err(kplane[1], rplane[1])))
    if timed:
        R = 4 * (V + 1)
        b_ms, b_by = bound(N * (14 + 4 * V) + 2 * N * R
                           + n_distinct * (R + 9) + R, ops=N * N / 2)
        fields = tfk.admit_in_fields(N, V)
        packed = torch.from_numpy(tfk.fill(
            np.zeros(tfk.nbytes(fields), np.uint8), fields, *recs)).cuda()
        row.update(ms=device_ms(lambda: tfk.fused_admit_packed(
                       *kplane, packed, N), **LAUNCH_BOUND),
                   plain_ms=device_ms(lambda: tfk.fused_admit_plain(
                       *rplane, *args)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library="none: no single PyTorch call gathers the "
                           "victims, scatters rows and writes a directory",
                   build=build_facts("tac_fused", "fused_admit"))
    emit("kernel_check", **row)
    return row


# fused batches past the step kernel's old 256-lane cap: across a warp's
# edge, one tail tile, four tiles
FUSED_WIDE = (257, 1024, 4096)
# the plain step's timing past one tile: its B x B masks take 1.5-33 ms a
# call there, so 3 rounds of 5 calls
PLAIN_WIDE = dict(reps=5, rounds=3)


def fused_kernel_phase():
    """K1 and K3 redesigned for the fused plane: ``tac_fused_step`` at the
    plane's widths (B 256, V 1) against directories of 2048 and 262,144
    ways, every kind and edge batch, float weights; smaller batches at
    V 3; the planted fault at 2048 ways.  Past the old caps: B 257, 1024
    and 4096 at both directories, every kind and batch (timed: mixed at
    1024 and 4096), float weights, the planted fault at B 1024; B 16,384;
    V 300 at B 256 and V 16 at B 4096 (beyond the old shared-memory
    limit).  ``tac_fused_admit`` at the chunk widths of
    ``_flush_admits``."""
    main, err = {}, {"tac_fused_step": 0.0, "tac_fused_admit": 0.0}

    def note(r):
        err[r["kernel"]] = max(err[r["kernel"]], r["max_abs_err"])
        return r

    W = E2E["cache_entries"]
    for ways in (W, DEPLOY_SLOTS):
        for kind in tfk.KINDS:
            for batch in ("mixed", "hot", "empty"):
                r = note(check_fused_step(
                    ways, E2E["batch"], 1, kind, batch,
                    timed=batch == "mixed",
                    fault=ways == W and kind != "read" and batch != "empty"))
                if (ways, kind, batch) == (W, "sum", "mixed"):
                    main["tac_fused_step"] = r
            note(check_fused_step(ways, E2E["batch"], 1, kind, "mixed",
                                  int_weights=False))
    for kind in tfk.KINDS:
        note(check_fused_step(300, 64, 3, kind, "mixed"))
        note(check_fused_step(5000, 100, 3, kind, "hot", int_weights=False))
        note(check_fused_step(5000, 256, 3, kind, "empty"))
    for ways in (W, DEPLOY_SLOTS):
        for B in FUSED_WIDE:
            for kind in tfk.KINDS:
                for batch in ("mixed", "hot", "empty"):
                    note(check_fused_step(
                        ways, B, 1, kind, batch,
                        timed=batch == "mixed" and B != 257,
                        fault=(ways, B, batch) == (W, 1024, "mixed")
                        and kind != "read"))
                note(check_fused_step(ways, B, 1, kind, "mixed",
                                      int_weights=False))
    note(check_fused_step(W, 4096, 1, "sum", "hot", int_weights=False))
    note(check_fused_step(DEPLOY_SLOTS, 16384, 1, "sum", "mixed",
                          timed=True))
    for kind in tfk.KINDS:
        note(check_fused_step(W, 256, 300, kind, "mixed"))
        note(check_fused_step(W, 4096, 16, kind, "mixed"))
    for N, n, V in ((1, 1, 1), (8, 5, 1), (16, 13, 3), (64, 64, 3),
                    (64, 40, 1)):
        note(check_fused_admit(W, N, V, n))
    main["tac_fused_admit"] = note(check_fused_admit(W, 64, 1, 64,
                                                     timed=True))
    note(check_fused_admit(DEPLOY_SLOTS, 64, 1, 64, timed=True))
    return main, err


def allclose(a, b, tol: float) -> bool:
    return bool(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol))


def decode_agrees(out, plain, tol: float) -> bool:
    """Attention output ``out`` agrees with the plain version's: finite,
    within ``tol`` elementwise, and its largest error at most ``tol`` times
    the plain output's largest magnitude.  The scaled test is the one that
    bites at long contexts: over 32,768 random tokens the softmax spreads
    so wide that outputs sit near 0.01, where an absolute 2e-2 would pass
    an all-zero output or one that skipped half the pages."""
    scale = float(plain.float().abs().max()) if plain.numel() else 0.0
    return (bool(torch.isfinite(out).all()) and allclose(out, plain, tol)
            and max_err(out, plain) <= tol * scale)


def decode_bound(q, seq_lens, P: int, page: int, dv=None):
    """Least time for paged decode attention: K (d wide) and V (``dv``
    wide, d unless given) at every position below seq_len, q, out, the
    table and the lengths each moved once, and 2 * H * (d + dv) flops a
    position (QK and PV) at the peak for q's type."""
    B, H, d = q.shape
    dv = dv or d
    it = q.element_size()
    tokens = int(seq_lens.clamp(max=P * page).sum())
    nbytes = tokens * (d + dv) * it + B * H * (d + dv) * it + B * P * 4 \
        + B * 4
    return bound(nbytes, ops=2.0 * tokens * H * (d + dv),
                 peak=peak_for(q.dtype))


def decode_case(B, H, d, page, P, dtype, seed=0, n_slots=None, length=None,
                lens=None, dv=None):
    """tests/test_kernels.py's construction: each sequence's pages are
    distinct random slots of a pool of B * P + 3 (or ``n_slots``) pages,
    lengths random in [1, P * page] (or all ``length``); values ``dv``
    wide (d unless given).  Given ``lens`` (one a row), the table entries
    of pages at or past each length are -1, as a probe miss leaves them."""
    rng = np.random.default_rng(seed)
    n_slots = n_slots or B * P + 3
    rnd = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32)).to(dtype).cuda()
    q, kp, vp = rnd(B, H, d), rnd(n_slots, page, d), \
        rnd(n_slots, page, dv or d)
    pt = rng.permutation(n_slots)[:B * P].reshape(B, P).astype(np.int32)
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        pt[np.arange(P)[None, :] * page >= lens[:, None]] = -1
    elif length:
        lens = np.full(B, length, np.int32)
    else:
        lens = rng.integers(1, P * page + 1, B).astype(np.int32)
    return q, kp, vp, torch.from_numpy(pt).cuda(), torch.from_numpy(lens).cuda()


def decode_split_dropped(q, k_pages, v_pages, page_table, seq_lens):
    """A planted fault: the plain output with the positions of one split,
    the last quarter of each row, masked (a merge that lost a split)."""
    return da.paged_decode_plain(q, k_pages, v_pages, page_table,
                                 seq_lens - seq_lens // 4)


def decode_rescale_dropped(q, k_pages, v_pages, page_table, seq_lens,
                           tile: int = da.WALK_TC_TILE):
    """A planted fault: the plain attention with the running-max rescale
    (alpha) dropped between tiles of ``tile`` tokens: each tile's
    probabilities are taken against the running max up to that tile, and
    the sums of earlier tiles are never rescaled when it rises."""
    B, H, d = q.shape
    page, P = k_pages.shape[1], page_table.shape[1]
    T = P * page
    tbl = torch.where(da._needed(page_table, seq_lens, page), page_table,
                      0).long()
    k = k_pages[tbl].reshape(B, T, -1).float()
    v = v_pages[tbl].reshape(B, T, -1).float()
    valid = (torch.arange(T, device=q.device)[None, :]
             < seq_lens[:, None].long())[:, None, :]
    s = torch.einsum("bhd,btd->bht", q.float(), k) / math.sqrt(d)
    s = torch.where(valid, s, da.NEG_INF)
    n = -(-T // tile)
    tiles = torch.nn.functional.pad(s, (0, n * tile - T), value=da.NEG_INF)
    run = tiles.reshape(B, H, n, tile).amax(-1).cummax(-1).values
    p = torch.where(valid, torch.exp(
        s - run.repeat_interleave(tile, -1)[..., :T]), 0.0)
    out = torch.einsum("bht,btd->bhd", p, v) \
        / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def flash_rescale_dropped(q, k, v, causal: bool = True, tile: int = 64):
    """A planted fault: the plain attention with the running-max rescale
    (alpha) dropped between key tiles of ``tile``: each tile's
    probabilities are taken against the running max up to that tile, and
    the sums of earlier tiles are never rescaled when it rises."""
    B, S, H, d = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum("bskgd,btkd->bkgst", q.float().reshape(B, S, KV, G, d),
                     k.float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] \
            >= torch.arange(T, device=q.device)[None, :]
        s = torch.where(mask, s, fa.NEG_INF)
    n = -(-T // tile)
    tiles = torch.nn.functional.pad(s, (0, n * tile - T), value=fa.NEG_INF)
    run = tiles.reshape(*s.shape[:-1], n, tile).amax(-1).cummax(-1).values
    p = torch.exp(s - run.repeat_interleave(tile, -1)[..., :T])
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float()) \
        / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def decode_32k_case(c):
    """decode_32k at full width: every sequence's KV heads folded into rows
    (rows = seqs x KV heads, H = query heads per KV head), every row
    seq_len tokens long in pages of ``page``, the pages at random distinct
    slots of a bf16 pool that holds exactly them."""
    rows = c["seqs"] * c["kv_heads"]
    P = c["seq_len"] // c["page"]
    g = torch.Generator(device="cuda").manual_seed(32)
    bf = dict(dtype=torch.bfloat16, device="cuda")
    kp = torch.empty((rows * P, c["page"], c["head_dim"]), **bf).normal_(
        generator=g)
    vp = torch.empty_like(kp).normal_(generator=g)
    q = torch.empty((rows, c["q_heads"] // c["kv_heads"], c["head_dim"]),
                    **bf).normal_(generator=g)
    pt = torch.randperm(rows * P, device="cuda", generator=g).reshape(
        rows, P).int()
    lens = torch.full((rows,), c["seq_len"], dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, lens


def sdpa_yardstick(args, kv_heads: int, out):
    """A yardstick for a DIFFERENT function, which the port never calls:
    ``scaled_dot_product_attention`` over the same K/V laid out
    contiguously ([seqs, KV heads, seq_len, d]; every row of the batch has
    the same length), the query heads of a KV head taken as its query
    positions.  Returns (ms, max abs difference from ``out``)."""
    q, kp, vp, pt, lens = args
    rows, G, d = q.shape
    dv = vp.shape[2]
    T = int(lens[0])
    shape = (rows // kv_heads, kv_heads, -1)
    k = kp[pt.long()].reshape(*shape, d)[:, :, :T]
    v = vp[pt.long()].reshape(*shape, dv)[:, :, :T]
    qs = q.reshape(rows // kv_heads, kv_heads, G, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    err = max_err(sdpa(qs, k, v).reshape(rows, G, dv), out)
    ms = device_ms(lambda: sdpa(qs, k, v), reps=3, rounds=5)
    del k, v
    torch.cuda.empty_cache()
    return ms, err


def decode_pass1(q, dv: int) -> str:
    """The mangled-name stem of the pass-1 kernel that runs q [B, H, d]
    with values ``dv`` wide (``da.instance``)."""
    B, H, d = q.shape
    route, DK, DV = da.instance(d, dv, q.dtype, H)
    if route == "workers":
        return f"decode_kernelIfLi{d}ELi{da.launch_plan(d, dv, H, q.dtype)[0]}E"
    if route == "tensor_cores":
        return (f"decode_bf16_kernelILi{DK}E" if DK <= 128
                else f"decode_wide_kernelILi{DK}ELi{DV}E")
    t = "f" if q.dtype == torch.float32 else "13__nv_bfloat16"
    if route in ("walk_tc", "wgmma"):
        return f"decode_{route}_kernel"
    if route == "walk":
        return f"decode_walk_kernelI{t}E"
    return f"decode_lanes_kernelI{t}Li{DK // 32}ELi{DV // 32}E"


# the walks' and the wgmma route's timed rows (the tensor-core walk and
# the wgmma route beside the TF32 walk on the same inputs; the TF32 walk's
# own rows), for the kernels line (label -> the timed row's figures), and
# the launches of each route's kernel_check rows
WALK_TC_ROWS = {}
WALK_ROWS = {}
WG_ROWS = {}
ROUTE_CHECK_LAUNCHES = collections.Counter()


def walk_reads(args, plan, label) -> dict:
    """The K and V bytes the TF32 walk asks for on these inputs (each once
    per (row, head chunk), K once a group: ``plan.reads``) and the bytes
    its 16-byte windows read, from this launch's table (``da.walk_windows``
    over every (token, chunk) it copies, held equal to the source's
    ``decode_walk_windows``)."""
    q, kp, vp, pt, lens = args
    B, H, d = q.shape
    n_slots, page, dv = vp.shape
    P = pt.shape[1]
    item = q.element_size()
    t = torch.arange(P * page, device=q.device)
    valid = t[None, :] < lens[:, None].long()
    slots = pt.long().clamp(min=0)[:, t // page]
    rows = (slots * page + t % page)[valid]
    tokens = int(valid.sum())
    k_bytes, v_bytes = plan.reads(d, dv, H, tokens)
    chunks = -(-H // da.WALK_TC_HEADS)
    def win(width, c0, n):
        w = (rows * width, c0, n, item, n_slots * page * width)
        mine = [t.cpu() for t in da.walk_windows(*w)]
        src = da.walk_source_windows(*w)
        if not all(torch.equal(a, b) for a, b in zip(mine, src)):
            raise AssertionError(f"decode_attention at {label}: "
                                 f"walk_windows differs from the source's "
                                 f"at columns {c0} of {width}")
        return int(mine[2].sum())

    k_win = sum(win(d, c0, min(64, d - c0)) for c0 in range(0, d, 64))
    v_win = sum(win(dv, c0, min(64, dv - c0)) for c0 in range(0, dv, 64))
    return dict(plan=plan._asdict(), k_bytes_read=k_bytes,
                v_bytes_read=v_bytes, kv_bytes_once=item * tokens * (d + dv),
                k_window_bytes=k_win * chunks * plan.groups,
                v_window_bytes=v_win * chunks,
                window_share=(k_win * plan.groups + v_win)
                / (item * tokens * (d * plan.groups + dv)))


def check_decode(args, label, timed=False, plain_rows=None, kv_heads=None,
                 fault=decode_split_dropped):
    """K5 against its plain version, the kernel's launch counted; timed
    rows also require the gate to reject a planted fault (``fault``: by
    default ``decode_split_dropped``) and two runs to be bit-equal, and
    add the times, the bound, the split count and the build facts.  Rows
    on the walks and the wgmma route hold their plans to the source's and
    print the bytes they read (the TF32 walk also its windows' bytes);
    timed, the tensor-core walk's and the wgmma route's also time the TF32
    walk on the same inputs (``walk_ms``, through ``launch_instance``),
    a row with an earlier design's time (``EARLIER_MS``) must beat it, and
    the TF32 walk's past (576, 512) must beat the plain version."""
    q, kp, vp, pt, lens = args
    before = da.LAUNCHES
    k = da.paged_decode_attention_kernel(*args)
    launched = da.LAUNCHES - before
    n = q.shape[0] if plain_rows is None else plain_rows
    pargs = (q[:n], kp, vp, pt[:n], lens[:n])
    p = da.paged_decode_plain(*pargs)
    torch.cuda.synchronize()
    tol = TOL[q.dtype]
    if decode_agrees(torch.zeros_like(p), p, tol):
        raise AssertionError(f"decode_attention at {label}: the check "
                             f"would pass an all-zero output")
    if not (bool(torch.isfinite(k).all()) and decode_agrees(k[:n], p, tol)):
        raise AssertionError(f"decode_attention differs at {label}: "
                             f"{max_err(k[:n], p)}")
    if launched != 1:
        raise AssertionError(f"decode_attention at {label}: {launched} "
                             f"kernel launches, not 1")
    B, H, d = q.shape
    dv = vp.shape[2]
    P = pt.shape[1]
    inst = da.instance(d, dv, q.dtype, H)
    ROUTE_CHECK_LAUNCHES[inst[0]] += launched
    row = dict(kernel="decode_attention", shape=label, B=B, H=H, d=d, dv=dv,
               page=kp.shape[1], P=P, n_slots=kp.shape[0],
               dtype=str(q.dtype).split(".")[-1],
               instance=inst, pass1=decode_pass1(q, dv),
               splits=da.splits_for(q, P, dv), launches=launched,
               checked_rows=n, max_abs_err=max_err(k[:n], p),
               plain_max_abs=float(p.float().abs().max()))
    if inst[0] == "walk_tc":
        plan = da.walk_tc_plan(d, dv)
        if da.walk_tc_source_plan(d, dv) != plan:
            raise AssertionError(f"decode_attention at {label}: walk_tc_plan "
                                 f"{plan} is not the source's "
                                 f"{da.walk_tc_source_plan(d, dv)}")
        tokens = int(lens.clamp(max=P * kp.shape[1]).sum())
        k_bytes, v_bytes = plan.reads(d, dv, H, tokens)
        row.update(plan=plan._asdict(), k_bytes_read=k_bytes,
                   v_bytes_read=v_bytes,
                   kv_bytes_once=2 * tokens * (d + dv))
    if inst[0] == "wgmma":
        plan = da.wg_plan(d, dv)
        if da.wg_source_plan(d, dv) != plan:
            raise AssertionError(f"decode_attention at {label}: wg_plan "
                                 f"{plan} is not the source's "
                                 f"{da.wg_source_plan(d, dv)}")
        tokens = int(lens.clamp(max=P * kp.shape[1]).sum())
        k_bytes, v_bytes = plan.reads(d, dv, H, tokens)
        row.update(plan=plan._asdict(), k_bytes_read=k_bytes,
                   v_bytes_read=v_bytes,
                   kv_bytes_once=2 * tokens * (d + dv),
                   partial_bytes=2 * 4 * B * H * (dv + 2) * row["splits"]
                   if row["splits"] > 1 else 0)
    if inst[0] == "walk":
        plan = da.walk_plan(d, dv, q.dtype)
        if da.walk_source_plan(d, dv, q.dtype) != plan:
            raise AssertionError(f"decode_attention at {label}: walk_plan "
                                 f"{plan} is not the source's "
                                 f"{da.walk_source_plan(d, dv, q.dtype)}")
        row.update(walk_reads(args, plan, label))
    if timed:
        bad = fault(*pargs)
        row["planted_fault"] = fault.__name__
        row["planted_fault_max_abs_err"] = max_err(bad, p)
        if decode_agrees(bad, p, tol):
            raise AssertionError(f"decode_attention at {label}: the check "
                                 f"would pass the planted {fault.__name__}")
        del bad
        again = da.attention_in_range(*args)
        row["bit_equal_rerun"] = bool(torch.equal(again, k))
        if not row["bit_equal_rerun"]:
            raise AssertionError(f"decode_attention at {label}: two runs "
                                 f"differ by {max_err(again, k)}")
        del again
        b_ms, b_by = decode_bound(q, lens, P, kp.shape[1], dv)
        big = kp.numel() * kp.element_size() > (1 << 30)
        reps, rounds = (3, 5) if big else (20, 7)
        ms = device_ms(lambda: da.attention_in_range(*args), reps, rounds)
        heads, per_sm = da.launch_plan(d, dv, H, q.dtype)
        tc = "f" if q.dtype == torch.float32 else "13__nv_bfloat16"
        row.update(ms=ms,
                   plain_ms=device_ms(lambda: da.paged_decode_plain(*pargs),
                                      reps, rounds),
                   plain_ms_rows=n, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None,
                   **timed_extras("decode_attention", label, ms, b_ms),
                   heads_per_block=heads, blocks_per_sm=per_sm,
                   build=build_facts("decode_attention", row["pass1"],
                                     f"merge_kernelI{tc}E"))
        if inst[0] in ("walk_tc", "wgmma"):   # the TF32 walk, same inputs
            walk = ("walk", d, dv)
            w = da.launch_instance(*args, walk)
            row.update(walk_max_abs_err=max_err(w[:n], p),
                       walk_ms=device_ms(
                           lambda: da.launch_instance(*args, walk), reps,
                           rounds),
                       walk_splits=da.splits_for(q, P, dv, walk),
                       walk_build=build_facts(
                           "decode_attention",
                           "decode_walk_kernelI13__nv_bfloat16E"))
            del w
        if inst[0] == "walk_tc":
            for name in ("walk_ms", "plain_ms"):
                if row["ms"] >= row[name]:
                    raise AssertionError(
                        f"decode_attention at {label}: the tensor-core walk "
                        f"({row['ms']} ms) is not faster than {name} "
                        f"({row[name]} ms)")
            WALK_TC_ROWS[label] = {key: row[key] for key in (
                "pass1", "plan", "ms", "walk_ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "bit_equal_rerun", "max_abs_err",
                "planted_fault_max_abs_err", "k_bytes_read", "v_bytes_read",
                "kv_bytes_once")}
        if row["earlier_ms"] is not None and row["ms"] >= row["earlier_ms"]:
            raise AssertionError(
                f"decode_attention at {label}: {row['ms']} ms is not faster "
                f"than the earlier design's {row['earlier_ms']} ms")
        if inst[0] == "walk":
            # past the lanes' widths, where it replaced the CUDA-core walk
            if (d > da.LANES_D or dv > da.LANES_DV) \
                    and row["ms"] >= row["plain_ms"]:
                raise AssertionError(
                    f"decode_attention at {label}: the TF32 walk "
                    f"({row['ms']} ms) is not faster than its plain version "
                    f"({row['plain_ms']} ms)")
            WALK_ROWS[label] = {key: row[key] for key in (
                "pass1", "plan", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_share", "bit_equal_rerun", "max_abs_err",
                "planted_fault_max_abs_err", "k_bytes_read", "v_bytes_read",
                "kv_bytes_once", "launches")}
        if kv_heads:
            try:
                row["sdpa_contiguous_ms"], row["sdpa_max_abs_diff"] = \
                    sdpa_yardstick(args, kv_heads, k)
            except RuntimeError as e:
                row["sdpa_refused"] = str(e)[:200]
        if inst[0] == "wgmma":
            WG_ROWS[label] = {key: row.get(key) for key in (
                "pass1", "plan", "splits", "ms", "walk_ms", "plain_ms",
                "bound_ms", "bound_by", "bound_share",
                "sdpa_contiguous_ms", "bit_equal_rerun", "max_abs_err",
                "planted_fault", "planted_fault_max_abs_err", "k_bytes_read",
                "v_bytes_read", "kv_bytes_once", "launches")}
    emit("kernel_check", **row)
    return row


def cms_case(d, w, B, seed=1, heavy=20, key_range=1000, counters=None,
             ab=None):
    """tests/test_kernels.py's construction: ``heavy`` copies of one key
    among random keys, hashed to columns on the card."""
    rng = np.random.RandomState(seed)
    a, b = ab or (rng.randint(1, 2 ** 31, d).astype(np.uint32),
                  rng.randint(0, 2 ** 31, d).astype(np.uint32))
    keys = np.concatenate([np.full(heavy, 42),
                           rng.randint(0, key_range, B - heavy)])
    rng.shuffle(keys)
    cols = cms_ops.columns_for(torch.from_numpy(keys.astype(np.int32)).cuda(),
                               a, b, w)
    if counters is None:
        counters = np.zeros((d, w), np.int32)
    return cols, torch.from_numpy(counters).cuda()


def cms_ranked_backwards(cols, counters, max_count: int = 255):
    """A planted fault: the update with each lane ranked among the LATER
    lanes of its column (the batch walked backwards): the same final
    counters, a column's estimates in reverse order."""
    new, est = cms.cms_update_plain(cols.flip(1), counters, max_count)
    return new, est.flip(1)


def check_cms(cols, counters, label, timed=False):
    """K4 against its plain version, bit for bit.  Timed rows (warm, as
    the hint filter finds its counters every batch) also require the gate
    to reject a planted fault (``cms_ranked_backwards``), and add the
    bound, its share, the earlier time and the tiles."""
    kc, ke = cms.cms_update_kernel(cols, counters)
    pc, pe = cms.cms_update_plain(cols, counters)
    torch.cuda.synchronize()
    if not (torch.equal(kc, pc) and torch.equal(ke, pe)):
        raise AssertionError(f"cms_sketch differs at {label}")
    d, B = cols.shape
    w = counters.shape[1]
    row = dict(kernel="cms_sketch", shape=label, d=d, w=w, B=B,
               max_abs_err=max(max_err(kc, pc), max_err(ke, pe)),
               saturated=int((ke == 255).sum()))
    if timed:
        fc, fe = cms_ranked_backwards(cols, counters)
        if torch.equal(fc, pc) and torch.equal(fe, pe):
            raise AssertionError(f"cms_sketch at {label}: the check would "
                                 f"pass lanes ranked out of batch order")
        tile, n_tiles = cms.plan_tiles(d, w,
                                       cuda_build.sm_count(cols.device))
        b_ms, b_by = bound(2 * d * w * 4 + 2 * d * B * 4, ops=d * B)
        t_ms = device_ms(lambda: cms.update_in_range(cols, counters),
                         **LAUNCH_BOUND)
        row.update(ms=t_ms,
                   plain_ms=device_ms(
                       lambda: cms.cms_update_plain(cols, counters)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   **timed_extras("cms_sketch", label, t_ms, b_ms),
                   planted_fault_est_differ=int((fe != pe).sum()),
                   tile=tile, n_tiles=n_tiles)
    emit("kernel_check", **row)
    return row


def check_cms_out_of_row(d, w, B, seed=0, max_count=255):
    """K4 through ``update_in_range`` with columns outside [0, w) (they
    read and write nothing, and their est is 0), a width that is no
    multiple of 4 or a batch of several chunks, bit for bit against the
    sequential walk of the reference's oracle (kernels/cms_sketch/ref.py)
    with those lanes skipped."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(-3, w + 3, (d, B)).astype(np.int32)
    cols[:, ::5] = 0                                  # a hot column
    counters = rng.integers(0, 300, (d, w)).astype(np.int32)
    kc, ke = cms.update_in_range(torch.from_numpy(cols).cuda(),
                                 torch.from_numpy(counters).cuda())
    want, est = counters.copy(), np.zeros((d, B), np.int32)
    for r in range(d):
        ctr, rc = want[r], cols[r]
        for i in range(B):
            c = rc[i]
            if 0 <= c < w:
                ctr[c] = min(ctr[c] + 1, max_count)
                est[r, i] = ctr[c]
    if not (np.array_equal(kc.cpu().numpy(), want)
            and np.array_equal(ke.cpu().numpy(), est)):
        raise AssertionError(f"cms_sketch differs at {d, w, B} with "
                             f"out-of-row columns")
    row = dict(kernel="cms_sketch", shape=f"out of row {d, w, B}", d=d, w=w,
               B=B, out_of_row=int(((cols < 0) | (cols >= w)).sum()),
               max_abs_err=0.0)
    emit("kernel_check", **row)
    return row


def randn(shape, dtype, g, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def scan_errors(out, plain):
    """(||out - plain||_F / ||plain||_F, the largest |out - plain| over
    |plain| + rms(plain))."""
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    rms = float(p.square().mean().sqrt()) if p.numel() else 0.0
    fro = float(d.norm()) / max(float(p.norm()), 1e-30)
    elem = float((d / (p.abs() + rms + 1e-30)).max()) if p.numel() else 0.0
    return fro, elem


def scan_agrees(out, plain, tol: float) -> bool:
    """A scan's output agrees with the plain version's: finite, within
    ``tol`` in relative Frobenius norm, and every element within ``tol``
    times |plain| + rms(plain).  Both sum the same fp32 terms in other
    orders, so an element near zero inside a sum of large terms may differ
    by more than ``tol`` times itself; the RMS term allows for that and no
    more: an error of a typical element's size fails both tests."""
    fro, elem = scan_errors(out, plain)
    return bool(torch.isfinite(out).all()) and fro <= tol and elem <= tol


def mamba_state_dropped(x, dt, A, Bm, Cm, Q: int):
    """A planted fault: the SSD scan with the state dropped at every chunk
    boundary (each chunk scanned from zeros; the inter-chunk term lost),
    from the plain version on the chunks as batch rows.  S a multiple of
    Q; returns y [B, S, H, P]."""
    B, S, H, P = x.shape
    nc = S // Q
    rows = lambda t: t.reshape(B * nc, Q, *t.shape[2:])  # noqa: E731
    A_rows = A.reshape(B, 1, H).expand(B, nc, H).reshape(-1)
    y, _ = ms.mamba2_scan_plain(rows(x), rows(dt), A_rows, rows(Bm),
                                rows(Cm), Q)
    return y.reshape(B, S, H, P)


def rwkv_slice_dropped(r, k, v, w, u, init=None):
    """A planted fault: the RWKV6 scan that lost one row slice's part of y
    (the last quarter of the state rows never reaches y_t = r_t S), from
    the plain version with those rows of r zeroed.  Returns y."""
    r = r.clone()
    r[..., 3 * r.shape[-1] // 4:] = 0
    return rs.rwkv6_scan_plain(r, k, v, w, u, init)[0]


def agrees_or_raise(name, label, out, plain, tol, agrees=decode_agrees):
    if agrees(torch.zeros_like(plain), plain, tol):
        raise AssertionError(f"{name} at {label}: the check would pass an "
                             f"all-zero output")
    if not agrees(out, plain, tol):
        raise AssertionError(f"{name} differs at {label}: "
                             f"{max_err(out, plain)}")


def check_flash(B, S, H, KV, d, dtype, causal, label, timed=False, seed=0,
                fault=False, dv=None, T=None):
    """K6 on q [B, S, H, d], k [B, T, KV, d] and v [B, T, KV, dv] (dv = d
    and T = S unless given) drawn from a seeded normal, against its plain
    version; with ``fault`` the gate must also reject a planted fault
    (``flash_rescale_dropped``).  Timed rows add the plain version's time,
    the bound (flops 2 * S * T * (d + dv) * B * H, halved when causal, at
    the peak for the operands' type), ``scaled_dot_product_attention`` on
    the same tensors (null, with the reason, if it refuses them) and the
    build facts."""
    dv = dv or d
    T = T or S
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn((B, S, H, d), dtype, g)
    k = randn((B, T, KV, d), dtype, g)
    v = randn((B, T, KV, dv), dtype, g)
    before = fa.LAUNCHES
    out = fa.flash_attention_kernel(q, k, v, causal)
    launched = fa.LAUNCHES - before
    plain = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    agrees_or_raise("flash_attention", label, out, plain, TOL[dtype])
    if launched != 1 or out.shape != plain.shape:
        raise AssertionError(f"flash_attention at {label}: {launched} "
                             f"kernel launches, out {tuple(out.shape)}")
    pair = fa.cover_pair(d, dv)
    row = dict(kernel="flash_attention", shape=label, B=B, S=S, T=T, H=H,
               KV=KV, d=d, dv=dv, causal=causal, dtype=dtype_name(dtype),
               instance=pair or "wide", launches=launched,
               max_abs_err=max_err(out, plain),
               plain_max_abs=float(plain.float().abs().max()))
    if pair is None:
        row.update(wide_route(q, k, v, dtype))
    if fault:
        bad = flash_rescale_dropped(q, k, v, causal)
        row["planted_fault_max_abs_err"] = max_err(bad, plain)
        if decode_agrees(bad, plain, TOL[dtype]):
            raise AssertionError(f"flash_attention at {label}: the check "
                                 f"would pass attention without the "
                                 f"running-max rescale")
        del bad
    del plain
    if timed:
        flops, nbytes = costs.flash_fwd(B, S, T, H, KV, d, dv, causal,
                                        q.element_size())
        b_ms, b_by = bound(nbytes, ops=flops, peak=peak_for(dtype))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = device_ms(lambda: fa.flash_attention_kernel(q, k, v, causal),
                       reps=5, rounds=5)
        if pair is None:               # the wide kernel: its own source
            source = "flash_attention_wide"
            needle = ("wide_fwd_wgmma" if dtype == torch.bfloat16
                      else "wide_fwd_kernel")
            smem = fa.wide_smem_bytes(*fa.wide_pair(d, dv, dtype), "fwd",
                                      dtype)
            again = fa.flash_attention_kernel(q, k, v, causal)
            row.update(bit_equal_rerun=bool(torch.equal(out, again)),
                       sdpa_backends=sdpa_backends(
                           q, k, v, causal, KV != H))
            if not row["bit_equal_rerun"]:
                raise AssertionError(f"flash_attention at {label}: two runs "
                                     f"differ")
            del again
        else:
            source = "flash_attention"
            needle = (f"flash_bf16_kernelILi{pair[0]}ELi{pair[1]}E"
                      if dtype == torch.bfloat16
                      else f"flash_kernelIfLi{pair[0]}ELi{pair[1]}E")
            smem = fa.smem_bytes(*pair, dtype)
        if pair not in (None, (d, dv)):   # the covering pair alone, padded
            padded = fa.pad_to_pair(q, k, v, pair)
            row.update(covering_pair_ms=device_ms(lambda: fa._forward(
                *padded, causal, False, 1 / math.sqrt(d)), reps=5, rounds=5),
                zero_work_share=1 - (d + dv) / sum(pair))
            del padded
        row.update(ms=ms,
                   plain_ms=device_ms(lambda: fa.flash_attention_plain(
                       q, k, v, causal), reps=3, rounds=3),
                   bound_ms=b_ms, bound_by=b_by,
                   library=f"scaled_dot_product_attention(is_causal="
                           f"{causal})",
                   **timed_extras("flash_attention", label, ms, b_ms),
                   dynamic_smem_bytes=smem,
                   build=build_facts(source, needle))
        try:
            lib = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=KV != H)
        except RuntimeError as e:
            row.update(library_ms=None, library_refused=str(e)[:200])
        else:
            row.update(library_ms=device_ms(lambda: sdpa(
                qt, kt, vt, is_causal=causal, enable_gqa=KV != H),
                reps=5, rounds=5),
                library_max_abs_diff=max_err(lib.transpose(1, 2), out))
            del lib
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


def check_mamba(B, S, H, G, N, P, Q, dtype, label, timed=False, seed=0,
                ref64=False):
    """K7 on the model layout from a seeded normal (dt softplus, A = -exp,
    as tests/test_kernels.py draws them); y and the final state against
    the plain version.  Timed rows with S a multiple of Q also require the
    gate to reject a planted fault (``mamba_state_dropped``); the bound
    counts C B^T once per (b, chunk, group), 2 Q^2 N flops, and 2 Q^2 P +
    4 Q N P a (b h, chunk), at the peak for the operands' type.  bf16
    timed rows also give the launch plan, whose shared memory must equal
    the CUDA source's.  With ``ref64`` the plain version runs in float64
    (its fp32 sums at a long S and a chunk of 256 stray from the exact
    result by more than the fp32 tolerance themselves); the fp32 plain
    version's distance from it and from the kernel are reported."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = randn((B, S, H, P), dtype, g)
    dt = torch.nn.functional.softplus(randn((B, S, H), torch.float32, g))
    A = -torch.exp(randn((B * H,), torch.float32, g, 0.5))
    Bm = randn((B, S, G, N), dtype, g)
    Cm = randn((B, S, G, N), dtype, g)
    args = (x, dt, A, Bm, Cm, Q)
    before = ms.LAUNCHES
    y, st = ms.mamba2_scan_kernel(*args)
    launched = ms.LAUNCHES - before
    extra = {}
    if ref64:
        p32 = ms.mamba2_scan_plain(*args)[0]
        py, pst = ms.mamba2_scan_plain(
            *(t.double() for t in args[:5]), Q)
        extra = dict(reference="plain version in float64",
                     plain_fp32_vs_fp64_errors=scan_errors(p32, py),
                     kernel_vs_plain_fp32_errors=scan_errors(y, p32))
        del p32
    else:
        py, pst = ms.mamba2_scan_plain(*args)
    torch.cuda.synchronize()
    agrees_or_raise("mamba2_scan", label, y, py, TOL[dtype], scan_agrees)
    agrees_or_raise("mamba2_scan state", label, st, pst, TOL[dtype],
                    scan_agrees)
    rows, cols = ms.split_plan(N, P)
    if launched != len(rows) * len(cols):
        raise AssertionError(f"mamba2_scan at {label}: {launched} kernel "
                             f"launches, not one a group of {rows, cols}")
    Qk = ms.kernel_chunk(Q, N, dtype)
    Ng, Pg = ms.group_n(N), cols[0][1]   # the widest group a launch takes
    row = dict(kernel="mamba2_scan", shape=label, B=B, S=S, H=H, G=G, N=N,
               P=P, Q=Q, kernel_chunk=Qk, launches=launched,
               groups=[rows, cols],
               dtype=dtype_name(dtype),
               max_abs_err=max(max_err(y, py), max_err(st, pst)),
               plain_max_abs=float(py.float().abs().max()),
               y_errors=scan_errors(y, py), state_errors=scan_errors(st, pst),
               **extra)
    if timed and S % Q == 0:
        fault = mamba_state_dropped(*args)
        row["planted_fault_errors"] = scan_errors(fault, py)
        if scan_agrees(fault, py, TOL[dtype]):
            raise AssertionError(f"mamba2_scan at {label}: the check would "
                                 f"pass the scan with the state dropped at "
                                 f"chunk boundaries")
        del fault
    del py, pst
    if timed:                          # the work at the kernel's chunk
        flops, nbytes = costs.mamba_fwd(B, S, H, G, N, P, Qk,
                                        x.element_size())
        b_ms, b_by = bound(nbytes, ops=flops, peak=peak_for(dtype))
        t_ms = device_ms(lambda: ms.mamba2_scan_kernel(*args), reps=5,
                         rounds=5)
        row.update(ms=t_ms,
                   plain_ms=device_ms(lambda: ms.mamba2_scan_plain(*args),
                                      reps=3, rounds=3),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library="none: no single PyTorch call computes a chunked "
                           "SSD scan",
                   **timed_extras("mamba2_scan", label, t_ms, b_ms),
                   build=build_facts("mamba2_scan", "ssd_"))
        if dtype == torch.bfloat16:
            pl = ms.plan(B, S, H, G, Ng, Pg, Qk,
                         *ms.card_slots(Qk, Ng, Pg, x.device))
            src_smem = ms.kernel_smem_bytes(Qk, Ng, Pg, pl["heads"])
            if tuple(src_smem) != tuple(pl["smem"]):
                raise AssertionError(f"mamba2_scan at {label}: the plan's "
                                     f"shared memory {pl['smem']} is not "
                                     f"the source's {src_smem}")
            row["plan"] = pl
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


def check_rwkv(B, S, H, N, dtype, label, timed=False, plain_rows=None,
               seed=0, fault=False):
    """K8 on the model layout from a seeded draw (k * 0.3, w = sigmoid,
    u * 0.1, as tests/test_kernels.py draws them), from a nonzero state; y
    and the final state against the plain version, which steps through S
    one token at a time and so runs on the first ``plain_rows`` batch rows
    only at the long shapes.  Timed rows (and any with ``fault``) also
    require the gate to reject a planted fault (``rwkv_slice_dropped``);
    timed rows give the column tile of the instance that runs N
    (``padded_n``), whose shared memory must equal the CUDA source's.  The bound counts 4 N^2
    flops a (b h, t) at the peak for the operands' type and each input and
    output once."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = randn((B, S, H, N), dtype, g)
    k = randn((B, S, H, N), dtype, g, 0.3)
    v = randn((B, S, H, N), dtype, g)
    w = torch.sigmoid(randn((B, S, H, N), torch.float32, g)).to(dtype)
    u = randn((B * H, N), torch.float32, g, 0.1)
    s0 = randn((B, H, N, N), torch.float32, g, 0.1)
    before = rs.LAUNCHES
    y, st = rs.rwkv6_scan_kernel(r, k, v, w, u, s0)
    launched = rs.LAUNCHES - before
    if launched != 1:
        raise AssertionError(f"rwkv6_scan at {label}: {launched} kernel "
                             f"launches, not 1")
    n = B if plain_rows is None else plain_rows
    pargs = (r[:n], k[:n], v[:n], w[:n], u[:n * H], s0[:n])
    py, pst = rs.rwkv6_scan_plain(*pargs)
    torch.cuda.synchronize()
    agrees_or_raise("rwkv6_scan", label, y[:n], py, TOL[dtype], scan_agrees)
    agrees_or_raise("rwkv6_scan state", label, st[:n], pst, TOL[dtype],
                    scan_agrees)
    Nk = rs.padded_n(N)
    nb = Nk // rs.BLOCK_N if N > rs.BLOCK_N else 1   # blocks a way
    row = dict(kernel="rwkv6_scan", shape=label, B=B, S=S, H=H, N=N,
               instance_N=min(Nk, rs.BLOCK_N), blocks_a_way=nb,
               launches=launched,
               dtype=dtype_name(dtype), checked_rows=n,
               max_abs_err=max(max_err(y[:n], py), max_err(st[:n], pst)),
               plain_max_abs=float(py.float().abs().max()),
               y_errors=scan_errors(y[:n], py),
               state_errors=scan_errors(st[:n], pst))
    if timed or fault:
        bad = rwkv_slice_dropped(*pargs)
        row["planted_fault_errors"] = scan_errors(bad, py)
        if scan_agrees(bad, py, TOL[dtype]):
            raise AssertionError(f"rwkv6_scan at {label}: the check would "
                                 f"pass the scan that lost a row slice's "
                                 f"part of y")
        del bad
    if timed:
        flops, nbytes = costs.rwkv_fwd(B, S, H, N, r.element_size())
        b_ms, b_by = bound(nbytes, ops=flops, peak=peak_for(dtype))
        t_ms = device_ms(lambda: rs.rwkv6_scan_kernel(r, k, v, w, u, s0),
                         reps=5, rounds=5)
        if nb > 1:                     # the instance alone, on the blocks
            padded = rs.stack_blocks(*rs.pad_state_dim(
                *(t.float() for t in (r, k, v, w, u, s0)), Nk), nb)
            row.update(instance_ms=device_ms(lambda: rs._forward(
                *padded, False), reps=5, rounds=5),
                zero_work_share=1 - (N / Nk) ** 2)
            del padded
        elif Nk != N:                  # the instance alone, on padded inputs
            padded = rs.pad_state_dim(r, k, v, w, u, s0, Nk)
            row.update(instance_ms=device_ms(lambda: rs._forward(
                *padded, False), reps=5, rounds=5),
                zero_work_share=1 - (N / Nk) ** 2)
            del padded
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        inst = min(Nk, rs.BLOCK_N)
        if nb > 1:                     # the blocks run the fp32 instance
            dtype = torch.float32
        cols = rs.plan_columns(B * H * nb * nb, inst, sms)
        smem = rs.smem_bytes(inst, cols, dtype)
        if rs.kernel_smem_bytes(inst, cols, dtype) != smem:
            raise AssertionError(f"rwkv6_scan at {label}: the plan's shared "
                                 f"memory {smem} is not the source's")
        row.update(ms=t_ms,
                   plain_ms=device_ms(lambda: rs.rwkv6_scan_plain(*pargs),
                                      reps=1, rounds=3),
                   plain_ms_rows=n, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None,
                   library="none: no single PyTorch call computes the "
                           "RWKV6 recurrence",
                   **timed_extras("rwkv6_scan", label, t_ms, b_ms),
                   cols=cols, blocks=B * H * nb * nb * (inst // cols),
                   threads=rs.threads(inst, cols),
                   dynamic_smem_bytes=smem,
                   build=build_facts("rwkv6_scan",
                                     "wkv_kernelIfLi64E"
                                     if dtype == torch.float32
                                     else "wkv_kernelI13__nv_bfloat16Li64E"))
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


def lm_kernel_phase():
    """K6-K8: tests/test_kernels.py's sweeps (and every (d, dv) pair K6 is
    built for, and non-causal S != T as cross-attention runs it, chunk and
    state sizes the port's models reach), then each kernel at the models
    phase's full-width prefill shape: K6 at zamba2-2.7b (4 x 32 heads,
    S = T = 2048, d 80, bf16), at gemma-7b's d 256 and at deepseek-v2's
    MLA prefill (4 x 128 heads, d 192, dv 128), K7 at zamba2-2.7b
    (4 x 80 heads, S 2048, Q 128, N = P = 64, bf16), K8 at rwkv6-3b (4 x 40
    heads, S 2048, N 64, fp32 as the model feeds it).  K7 and K8 are also
    timed at S = 2000 (a last chunk of 80 at full width) and K8 at the
    decode shape (one token from a nonzero state).  Shapes past the
    kernels' instances: K6 at pairs it pads to the covering one (and timed
    at Phi-3-mini's d 96), refusing one past 256; K7 at N 128 and chunks
    past 128 (timed at mamba2-2.7b's prefill; its gradient at N 128 is
    ``scan_bwd_rows``'); K8 at N it pads to the next instance."""
    main, errs = {}, {"flash_attention": 0.0, "mamba2_scan": 0.0,
                      "rwkv6_scan": 0.0}

    def note(r):
        errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
        return r

    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for S, H, KV, d in ((128, 4, 2, 32), (256, 2, 2, 64),
                                (128, 4, 1, 16), (128, 4, 2, 80),
                                (128, 4, 4, 128), (128, 2, 2, 256),
                                (45, 4, 2, 16)):
                note(check_flash(2, S, H, KV, d, dtype, causal,
                                 f"sweep {S, H, KV, d}"))
            for d, dv in fa.PAIRS:              # every instantiated pair
                note(check_flash(2, 96, 4, 2, d, dtype, causal,
                                 f"pair {d, dv}", dv=dv))
            # pairs no config instantiates: the covering pair, padded
            for d, dv in ((48, 40), (100, 60), (40, 40)):
                note(check_flash(2, 96, 4, 2, d, dtype, causal,
                                 f"padded {d, dv}", dv=dv))
        for d, dv in ((16, 16), (24, 16), (64, 64)):   # cross-attention
            note(check_flash(2, 96, 4, 4, d, dtype, False,
                             f"cross {d, dv} S 96 T 160", dv=dv, T=160))
        note(check_flash(2, 96, 4, 4, 100, dtype, False,
                         "padded cross (100, 60) S 96 T 160", dv=60, T=160))
        for S, P, N, Q in ((128, 16, 8, 32), (64, 32, 16, 64),
                           (256, 8, 4, 16), (62, 16, 8, 31),
                           (60, 16, 16, 24),
                           # N 128 and chunks past 128: a last chunk of 88
                           (600, 64, 128, 256), (300, 24, 100, 200),
                           (192, 64, 128, 128)):
            note(check_mamba(1, S, 3, 1, N, P, Q, dtype, f"sweep {S, P, N, Q}"))
        note(check_mamba(2, 64, 4, 2, 16, 16, 32, dtype, "groups"))
        for S, N in ((128, 8), (64, 16), (96, 32), (64, 64),
                     (100, 12), (64, 24), (96, 48)):   # padded to HEAD_DIMS
            note(check_rwkv(1, S, 3, N, dtype, f"sweep {S, N}",
                            fault=N == 48))
    # N 128, chunk 256 in fp32 at mamba2-2.7b's widths, 8 of its heads
    note(check_mamba(1, 2048, 8, 1, 128, 64, 256, torch.float32,
                     "mamba2-2.7b widths fp32, 8 heads", ref64=True))
    # past every pair: the wide kernel (``wide_phase`` has its rows)
    note(check_flash(1, 40, 2, 2, 264, torch.float32, True, "wide (264, 64)",
                     dv=64))
    main["flash_attention"] = note(check_flash(
        4, 2048, 32, 32, 80, torch.bfloat16, True, "zamba2-2.7b prefill",
        timed=True, fault=True))
    note(check_flash(4, 2048, 16, 16, 256, torch.bfloat16, True,
                     "gemma-7b prefill", timed=True))
    note(check_flash(4, 2048, 128, 128, 192, torch.bfloat16, True,
                     "deepseek-v2-236b MLA prefill", timed=True, dv=128))
    # Phi-3-mini's head dim 96 (hidden 3072 over 32 heads), on (128, 128)
    note(check_flash(4, 2048, 32, 32, 96, torch.bfloat16, True,
                     "phi-3-mini prefill (d 96)", timed=True, fault=True))
    main["mamba2_scan"] = note(check_mamba(
        4, 2048, 80, 1, 64, 64, 128, torch.bfloat16, "zamba2-2.7b prefill",
        timed=True))
    main["rwkv6_scan"] = note(check_rwkv(
        4, 2048, 40, 64, torch.float32, "rwkv6-3b prefill", timed=True,
        plain_rows=1))
    note(check_mamba(4, 2000, 80, 1, 64, 64, 128, torch.bfloat16,
                     "zamba2-2.7b S 2000", timed=True))
    note(check_rwkv(4, 2000, 40, 64, torch.float32, "rwkv6-3b S 2000",
                    timed=True, plain_rows=1))
    note(check_rwkv(4, 1, 40, 64, torch.float32, "rwkv6-3b decode",
                    timed=True))
    # N 48 at rwkv6-3b's heads and tokens: the cost of the padding to 64
    note(check_rwkv(4, 2048, 40, 48, torch.float32, "N 48 at rwkv6-3b's "
                    "heads", timed=True, plain_rows=1))
    # mamba2-2.7b's prefill: d_state 128, headdim 64, chunk 256 (run as
    # chunks of 128), 80 heads of one group
    note(check_mamba(4, 2048, 80, 1, 128, 64, 256, torch.bfloat16,
                     "mamba2-2.7b prefill", timed=True))
    return main, errs


# K6's backward against the plain backward: the largest error of each of
# dq, dk, dv over the plain gradient's largest magnitude
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the backward's timed shapes, causal, bf16: gemma-7b's training attention
# (configs/gemma_7b.py; the train phase's batch: 4 x 2048 tokens, 16 heads
# of 256), llava-next-mistral-7b's LM (32 query heads on 8 KV heads of 128)
# and deepseek-v2's MLA (128 heads, d 192, dv 128) at the same tokens
BWD_TIMED = {
    "gemma-7b train": dict(B=4, S=2048, H=16, KV=16, d=256, dv=256),
    "llava-next-mistral-7b train": dict(B=4, S=2048, H=32, KV=8, d=128,
                                        dv=128),
    "deepseek-v2-236b MLA train": dict(B=1, S=2048, H=128, KV=128, d=192,
                                       dv=128)}


def grads_rel(grads, plain) -> float:
    """max over dq, dk, dv of max |kernel - plain| / max |plain|; inf if a
    gradient is not finite."""
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        return math.inf
    return max(max_err(a, b) / (float(b.float().abs().max()) + 1e-30)
               for a, b in zip(grads, plain))


def check_flash_bwd(B, S, H, KV, d, dtype, causal, label, dv=None, T=None,
                    timed=False, fault=False, seed=0):
    """K6's backward (``flash_attention_backward``: D, dK/dV, dQ) on seeded
    q, k, v and an output gradient, from the forward kernel's own output and
    lse, against ``flash_attention_backward_plain`` within ``BWD_TOL``.
    The forward's output with lse asked for must equal its output without;
    at untimed shapes lse must equal the plain scores' logsumexp.  With
    ``fault`` the gate must reject the backward with D left at zero
    (``backward_from_delta``).  Timed rows add the plain backward's time,
    the bound (2.5 x the forward's flops, 2 * S * T * (d + dv) * B * H,
    halved when causal, at the operands' peak; bytes: q, k, v, out, dout,
    dq, dk, dv once, lse) and SDPA's backward
    (``scaled_dot_product_attention`` forward once, then its backward
    alone, timed)."""
    dv = dv or d
    T = T or S
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn((B, S, H, d), dtype, g)
    k = randn((B, T, KV, d), dtype, g)
    v = randn((B, T, KV, dv), dtype, g)
    dout = randn((B, S, H, dv), dtype, g)
    out, lse = fa._forward(q, k, v, causal, True)
    if not torch.equal(out, fa._forward(q, k, v, causal, False)[0]):
        raise AssertionError(f"flash_attention at {label}: asking for lse "
                             f"changed the output")
    before = fa.BWD_LAUNCHES
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, causal)
    launched = fa.BWD_LAUNCHES - before
    plain = fa.flash_attention_backward_plain(q, k, v, dout, causal)
    torch.cuda.synchronize()
    rel = grads_rel(grads, plain)
    tol = BWD_TOL[dtype]
    wide = fa.is_wide(d, dv)
    row = dict(kernel="flash_attention_bwd", shape=label, B=B, S=S, T=T,
               H=H, KV=KV, d=d, dv=dv, causal=causal, dtype=dtype_name(dtype),
               design="wide" if wide else fa.bwd_design(d, dv, dtype),
               launches=launched, rel_err=rel, tol=tol,
               max_abs_err=max(max_err(a, b) for a, b in zip(grads, plain)),
               plain_max_abs=max(float(b.float().abs().max())
                                 for b in plain))
    if wide:
        row.update(wide_route(q, k, v, dtype))
    if not rel <= tol or launched != 1:
        raise AssertionError(f"flash_attention_bwd differs at {label}: "
                             f"{row}")
    if not timed:
        sc = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float().repeat_interleave(H // KV, dim=2)) \
            / math.sqrt(d)
        if causal:
            sc = sc.masked_fill(torch.arange(S, device="cuda")[:, None]
                                < torch.arange(T, device="cuda")[None, :],
                                -math.inf)
        row["lse_max_abs_err"] = max_err(lse, torch.logsumexp(sc, dim=-1))
        if not row["lse_max_abs_err"] <= 1e-4 * (1 + float(lse.abs().max())):
            raise AssertionError(f"flash_attention lse differs at {label}: "
                                 f"{row}")
    if fault:
        bad = fa.backward_from_delta(q, k, v, lse, torch.zeros_like(lse),
                                     dout, causal)
        row["planted_fault_rel_err"] = grads_rel(bad, plain)
        if row["planted_fault_rel_err"] <= tol:
            raise AssertionError(f"flash_attention_bwd at {label}: the check "
                                 f"would pass the backward with D left at "
                                 f"zero")
        del bad
    del plain
    if timed:
        again = fa.flash_attention_backward(q, k, v, out, lse, dout, causal)
        row["bit_equal_rerun"] = all(torch.equal(a, b)
                                     for a, b in zip(grads, again))
        if not row["bit_equal_rerun"]:
            raise AssertionError(f"flash_attention_bwd at {label}: two runs "
                                 f"differ")
        del again
        smem = [fa.wide_smem_bytes(d, dv, kind, dtype)
                for kind in ("dkdv", "dq")] if wide \
            else [fa.bwd_smem_bytes(d, dv, dtype, True),
                  fa.bwd_smem_bytes(d, dv, dtype, False)]
        if wide:
            row["sdpa_backends"] = sdpa_backends(q, k, v, causal, KV != H,
                                                 dout)
        if row["design"] == "wgmma":
            plans = [fa.wgmma_plan(d, dv, dq) for dq in (False, True)]
            row["plans"] = [p._asdict() for p in plans]
            if smem != [p.smem_bytes for p in plans]:
                raise AssertionError(f"flash_attention_bwd at {label}: the "
                                     f"source's shared memory {smem} is not "
                                     f"the plans' {plans}")
        flops, nbytes = costs.flash_bwd(B, S, T, H, KV, d, dv, causal,
                                        q.element_size())
        b_ms, b_by = bound(nbytes, ops=flops, peak=peak_for(dtype))
        ms = device_ms(lambda: fa.flash_attention_backward(
            q, k, v, out, lse, dout, causal), reps=3, rounds=5)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        o_lib = sdpa(*leaves, is_causal=causal, enable_gqa=KV != H)
        do_lib = dout.transpose(1, 2)
        row.update(ms=ms,
                   plain_ms=device_ms(lambda: fa.flash_attention_backward_plain(
                       q, k, v, dout, causal), reps=1, rounds=3),
                   bound_ms=b_ms, bound_by=b_by,
                   **timed_extras("flash_attention_bwd", label, ms, b_ms),
                   library=f"scaled_dot_product_attention(is_causal="
                           f"{causal}) backward",
                   library_ms=device_ms(lambda: torch.autograd.grad(
                       o_lib, leaves, do_lib, retain_graph=True),
                       reps=3, rounds=5),
                   dynamic_smem_bytes=smem,
                   build=build_facts("flash_attention_wide",
                                     "wide_bwd_wgmma" if dtype == torch.bfloat16
                                     else "wide_d")
                   if wide else build_facts("flash_attention_bwd",
                                            f"ILi{d}ELi{dv}E"))
        del o_lib, leaves
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


def check_grad_through_wrapper(name: str, label: str, fwd, plain_bwd,
                               inputs, dout, tol: float, counters,
                               expect=None) -> dict:
    """A kernel's gradient as a caller gets it at a shape the wrapper pads
    (autograd through the padding, the kernel's ``autograd.Function`` and
    the slice) against ``plain_bwd`` (autograd through the plain version)
    within ``tol`` (``grads_rel``); the forward and the backward kernel
    must each have launched once (``counters``: their modules and count
    names)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    before = [getattr(m, c) for m, c in counters]
    out = fwd(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    launched = [getattr(m, c) - b for (m, c), b in zip(counters, before)]
    plain = plain_bwd(*inputs, dout)
    torch.cuda.synchronize()
    rel = grads_rel(grads, plain)
    row = dict(kernel=name, shape=label, dtype=dtype_name(inputs[0].dtype),
               rel_err=rel, tol=tol, launches=launched,
               max_abs_err=max(max_err(a, b) for a, b in zip(grads, plain)))
    if launched != (expect or [1] * len(counters)) or not rel <= tol:
        raise AssertionError(f"{name} gradient through the wrapper at "
                             f"{label}: {row}")
    emit("kernel_check", **row)
    return row


def flash_grad_row(B, S, H, KV, d, dv, dtype, causal, label, seed=0):
    """K6's gradient at a pair the wrapper pads, against autograd through
    the plain version."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k = randn((B, S, H, d), dtype, g), randn((B, S, KV, d), dtype, g)
    v = randn((B, S, KV, dv), dtype, g)
    dout = randn((B, S, H, dv), dtype, g)
    return check_grad_through_wrapper(
        "flash_attention_bwd", label,
        lambda *t: fa.flash_attention_kernel(*t, causal),
        lambda q, k, v, do: fa.flash_attention_backward_plain(q, k, v, do,
                                                              causal),
        (q, k, v), dout, BWD_TOL[dtype],
        [(fa, "LAUNCHES"), (fa, "BWD_LAUNCHES")])


def rwkv_grad_row(B, S, H, N, label, seed=0):
    """K8's gradient (fp32) at an N the wrapper pads, y's alone, against
    autograd through the plain version."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, v = randn((B, S, H, N), torch.float32, g), \
        randn((B, S, H, N), torch.float32, g)
    k = randn((B, S, H, N), torch.float32, g, 0.3)
    w = torch.sigmoid(randn((B, S, H, N), torch.float32, g))
    u = randn((B * H, N), torch.float32, g, 0.1)
    s0 = randn((B, H, N, N), torch.float32, g, 0.1)
    dy = randn((B, S, H, N), torch.float32, g)
    return check_grad_through_wrapper(
        "rwkv6_scan_bwd", label,
        lambda *t: rs.rwkv6_scan_kernel(*t)[0],
        lambda *t: rs.rwkv6_scan_backward_plain(*t[:6], t[6]),
        (r, k, v, w, u, s0), dy, BWD_TOL[torch.float32],
        [(rs, "LAUNCHES"), (rs, "BWD_LAUNCHES")])


def rwkv_bwd_undecayed(r, k, v, w, u, init, dy, dstate):
    """A planted fault: K8's gradient with the state gradient carried back
    without its decay, G_t = G_{t+1} + r_t dy_t^T (not diag(w_t) G_{t+1}
    + ...), the formulas of csrc/rwkv6_scan_bwd.cu stepped in plain
    PyTorch.  Returns (dr, dk, dv, dw, du, dinit) in fp32."""
    B, S, H, N = r.shape
    uf = u.reshape(B, H, N)
    P = init.clone()
    states = []
    for t in range(S):
        states.append(P)
        P = w[:, t, :, :, None] * P + k[:, t, :, :, None] * v[:, t, :, None]
    G = dstate.clone()
    grads = [torch.empty_like(r) for _ in range(4)]
    du = torch.zeros_like(uf)
    for t in reversed(range(S)):
        vd = (v[:, t] * dy[:, t]).sum(-1, keepdim=True)          # [B, H, 1]
        grads[0][:, t] = (states[t] * dy[:, t, :, None]).sum(-1) \
            + uf * k[:, t] * vd
        grads[1][:, t] = (G * v[:, t, :, None]).sum(-1) + uf * r[:, t] * vd
        grads[2][:, t] = (G * k[:, t, :, :, None]).sum(-2) \
            + (r[:, t] * uf * k[:, t]).sum(-1, keepdim=True) * dy[:, t]
        grads[3][:, t] = (G * states[t]).sum(-1)
        du += r[:, t] * k[:, t] * vd
        G = G + r[:, t, :, :, None] * dy[:, t, :, None]
    return (*grads, du.reshape(B * H, N), G)


def check_mamba_bwd(B, S, H, G, N, P, Q, dtype, label, timed=False,
                    fault=False, seed=0, extra=None):
    """K7's backward (``mamba2_scan_backward``: the state gradients at the
    chunks' ends, then each chunk's gradients) on seeded inputs from a
    nonzero initial state, with nonzero gradients of y and of the final
    state, from the forward kernel's own saved states, against
    ``mamba2_scan_backward_plain`` within ``BWD_TOL``.  The forward's
    output with the states asked for must equal its output without.
    With ``fault`` the gate must reject the backward with the state
    gradients dropped between chunks (``backward_from_dstates`` given
    zeros but at the last chunk).  Timed rows add two runs bit-equal, the
    plain backward's time and the bound: flops 2 Q^2 (2 N + 2 P) + 8 Q N P
    a (b h, chunk) and 2 Q^2 N a (b g, chunk) at the operands' peak
    (``costs.mamba_bwd``, at the chunk the row runs);
    bytes the gradient's own, each once: x, dt, A, Bm, Cm, init, dy and
    dstate in, their gradients out.  The chunk-entry states that this
    design saves are not the function's traffic and are reported apart
    (``saved_state_bytes``); the forward that saves them is timed beside
    it (``forward_with_states_ms``).  Rows print the plan's heads a block,
    tiles a group and threads a block (``bwd_plan``), and the backward's
    launches (one); fp32 rows print ``BOUNDARY_NOISE``'s K7 term beside
    their distance from the plain backward (``rel_err``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = randn((B, S, H, P), dtype, g)
    dt = torch.nn.functional.softplus(randn((B, S, H), torch.float32, g))
    A = -torch.exp(randn((B * H,), torch.float32, g, 0.5))
    Bm = randn((B, S, G, N), dtype, g)
    Cm = randn((B, S, G, N), dtype, g)
    init = randn((B, H, N, P), torch.float32, g, 0.3)
    dy = randn((B, S, H, P), dtype, g)
    dstate = randn((B, H, N, P), torch.float32, g, 0.3)
    args = (x, dt, A, Bm, Cm, Q)
    y, st, s_prev = ms._forward(*args, init, True)
    y0, st0, _ = ms._forward(*args, init, False)
    if not (torch.equal(y, y0) and torch.equal(st, st0)):
        raise AssertionError(f"mamba2_scan at {label}: saving the states "
                             f"changed the output")
    del y0, st0
    before = ms.BWD_LAUNCHES
    grads = ms.mamba2_scan_backward(*args, s_prev, dy, dstate)
    launched = ms.BWD_LAUNCHES - before
    plain = ms.mamba2_scan_backward_plain(*args, init, dy, dstate)
    torch.cuda.synchronize()
    rel = grads_rel(grads, plain)
    tol = BWD_TOL[dtype]
    groups = ms.split_plan(N, P)
    n_groups = len(groups[0]) * len(groups[1])
    Ng, Pg = ms.group_n(N), groups[1][0][1]   # a launch's widest group
    dd = torch.float32 if ms.fp32_design(N, dtype) else dtype   # its design
    heads = ms.bwd_heads(x[..., :Pg].to(dd), Bm[..., :Ng].to(dd), Q)
    row = dict(kernel="mamba2_scan_bwd", shape=label, B=B, S=S, H=H, G=G,
               N=N, P=P, Q=Q, dtype=dtype_name(dtype), heads=heads,
               tiles=-(-(H // G) // heads), rel_err=rel, tol=tol,
               rel_by_grad=[max_err(a, b) / (float(b.float().abs().max())
                                             + 1e-30)
                            for a, b in zip(grads, plain)],
               max_abs_err=max(max_err(a, b) for a, b in zip(grads, plain)),
               plain_max_abs=max(float(b.float().abs().max())
                                 for b in plain), launches=launched,
               groups=groups, design=dtype_name(dd),
               threads=ms.bwd_threads(Q, Ng))
    if dtype == torch.float32:         # the witness noise it stands for
        row["boundary_noise"] = BOUNDARY_NOISE[1]
    row.update(extra or {})
    if not (rel <= tol and launched == n_groups):
        raise AssertionError(f"mamba2_scan_bwd differs at {label}: {row}")
    if fault:
        ds, _ = ms.backward_dstates(x, dt, A, Cm, Q, dy, dstate, heads)
        ds[:, :-1] = 0
        bad = ms.backward_from_dstates(*args, s_prev, dy, ds, heads)
        row["planted_fault_rel_err"] = grads_rel(bad, plain[:5])
        if row["planted_fault_rel_err"] <= tol:
            raise AssertionError(f"mamba2_scan_bwd at {label}: the check "
                                 f"would pass the backward without the "
                                 f"state gradients between chunks")
        del bad, ds
    if timed:
        again = ms.mamba2_scan_backward(*args, s_prev, dy, dstate)
        row["bit_equal_rerun"] = all(torch.equal(a, b)
                                     for a, b in zip(grads, again))
        if not row["bit_equal_rerun"]:
            raise AssertionError(f"mamba2_scan_bwd at {label}: two runs "
                                 f"differ")
        del again
        flops, nbytes = costs.mamba_bwd(B, S, H, G, N, P, Q,
                                        x.element_size())
        b_ms, b_by = bound(nbytes, ops=flops, peak=peak_for(dtype))
        t_ms = device_ms(lambda: ms.mamba2_scan_backward(
            *args, s_prev, dy, dstate), reps=3, rounds=5)
        row.update(ms=t_ms, forward_with_states_ms=device_ms(
            lambda: ms._forward(*args, init, True), reps=3, rounds=5),
                   plain_ms=device_ms(lambda: ms.mamba2_scan_backward_plain(
                       *args, init, dy, dstate), reps=1, rounds=3),
                   bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                   saved_state_bytes=s_prev.numel() * s_prev.element_size(),
                   **timed_extras("mamba2_scan_bwd", label, t_ms, b_ms),
                   library_ms=None,
                   library="none: no single PyTorch call computes the "
                           "gradient of a chunked SSD scan",
                   scratch_bytes=ms.bwd_scratch_bytes(B, S, H, G, Ng, Pg,
                                                      Q, dd, heads),
                   dynamic_smem_bytes=ms.bwd_smem_bytes(Q, Ng, Pg, heads,
                                                        dd),
                   build=build_facts("mamba2_scan_bwd", "ssd_"))
        src_smem = ms.kernel_bwd_smem_bytes(Q, Ng, Pg, heads, dd)
        if tuple(src_smem) != tuple(row["dynamic_smem_bytes"]) \
                or ms.kernel_bwd_threads(Q, Ng) != row["threads"]:
            raise AssertionError(f"mamba2_scan_bwd at {label}: the wrapper's "
                                 f"shared memory {row['dynamic_smem_bytes']}"
                                 f" or threads {row['threads']} are not the "
                                 f"source's {src_smem}")
    del plain, grads
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


def check_rwkv_bwd(B, S, H, N, label, timed=False, plain_rows=None,
                   fault=False, seed=0):
    """K8's backward (``rwkv6_scan_backward``) in fp32 on seeded inputs
    drawn as ``check_rwkv`` draws them, from a nonzero initial state, with
    nonzero gradients of y and of the final state, from the forward
    kernel's own saved states, against ``rwkv6_scan_backward_plain`` on
    the first ``plain_rows`` batch rows (all by default) within
    ``BWD_TOL``.  The forward's output with the states asked for must
    equal its output without.  With ``fault`` the gate must reject the
    gradient whose state gradient is not decayed by w
    (``rwkv_bwd_undecayed``).  Timed rows add two runs bit-equal, the
    plain backward's time on those rows and the bound: the chunked form's
    operations (``rwkv_bwd_flops``) at the fp32 peak; bytes the
    gradient's own, each once: r, k, v, w, u, init, dy and dstate in,
    their gradients out.  The states that this design saves are reported
    apart (``saved_state_bytes``)."""
    dtype = torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = randn((B, S, H, N), dtype, g)
    k = randn((B, S, H, N), dtype, g, 0.3)
    v = randn((B, S, H, N), dtype, g)
    w = torch.sigmoid(randn((B, S, H, N), torch.float32, g))
    u = randn((B * H, N), torch.float32, g, 0.1)
    s0 = randn((B, H, N, N), torch.float32, g, 0.1)
    dy = randn((B, S, H, N), dtype, g)
    dstate = randn((B, H, N, N), torch.float32, g, 0.3)
    y, st, states = rs._forward(r, k, v, w, u, s0, True)
    y0, st0, _ = rs._forward(r, k, v, w, u, s0, False)
    if not (torch.equal(y, y0) and torch.equal(st, st0)):
        raise AssertionError(f"rwkv6_scan at {label}: saving the states "
                             f"changed the output")
    del y0, st0
    grads = rs.rwkv6_scan_backward(r, k, v, w, u, states, dy, dstate)
    n = B if plain_rows is None else plain_rows
    pargs = (r[:n], k[:n], v[:n], w[:n], u[:n * H], s0[:n], dy[:n],
             dstate[:n])
    plain = rs.rwkv6_scan_backward_plain(*pargs)
    rows = [t[:n] for t in grads[:4]] + [grads[4][:n * H], grads[5][:n]]
    torch.cuda.synchronize()
    rel = grads_rel(rows, plain)
    tol = BWD_TOL[dtype]
    row = dict(kernel="rwkv6_scan_bwd", shape=label, B=B, S=S, H=H, N=N,
               dtype=dtype_name(dtype), checked_rows=n, rel_err=rel, tol=tol,
               rel_by_grad=[max_err(a, b) / (float(b.float().abs().max())
                                             + 1e-30)
                            for a, b in zip(rows, plain)],
               max_abs_err=max(max_err(a, b) for a, b in zip(rows, plain)),
               plain_max_abs=max(float(b.float().abs().max())
                                 for b in plain))
    if not rel <= tol:
        raise AssertionError(f"rwkv6_scan_bwd differs at {label}: {row}")
    if fault:
        bad = rwkv_bwd_undecayed(*pargs)
        row["planted_fault_rel_err"] = grads_rel(bad, plain)
        if row["planted_fault_rel_err"] <= tol:
            raise AssertionError(f"rwkv6_scan_bwd at {label}: the check "
                                 f"would pass the backward whose state "
                                 f"gradient is not decayed by w")
        del bad
    if timed:
        again = rs.rwkv6_scan_backward(r, k, v, w, u, states, dy, dstate)
        row["bit_equal_rerun"] = all(torch.equal(a, b)
                                     for a, b in zip(grads, again))
        if not row["bit_equal_rerun"]:
            raise AssertionError(f"rwkv6_scan_bwd at {label}: two runs "
                                 f"differ")
        del again
        flops, nbytes = costs.rwkv_bwd(B, S, H, N, rs.SAVE_EVERY)
        b_ms, b_by = bound(nbytes, ops=flops)
        t_ms = device_ms(lambda: rs.rwkv6_scan_backward(
            r, k, v, w, u, states, dy, dstate), reps=3, rounds=5)
        smem = rs.bwd_smem_bytes(N)
        if rs.kernel_bwd_smem_bytes(N) != smem:
            raise AssertionError(f"rwkv6_scan_bwd at {label}: the wrapper's "
                                 f"shared memory {smem} is not the source's")
        row.update(ms=t_ms,
                   plain_ms=device_ms(lambda: rs.rwkv6_scan_backward_plain(
                       *pargs), reps=1, rounds=3),
                   plain_ms_rows=n, bound_ms=b_ms, bound_by=b_by,
                   bound_bytes=nbytes, saved_state_bytes=4 * states.numel(),
                   **timed_extras("rwkv6_scan_bwd", label, t_ms, b_ms),
                   library_ms=None,
                   library="none: no single PyTorch call computes the "
                           "gradient of the RWKV6 recurrence",
                   blocks=2 * B * H * rs.saved_states(S),
                   threads=rs.bwd_threads(N),
                   dynamic_smem_bytes=smem,
                   scratch_bytes=rs.bwd_scratch_bytes(B, S, H, N),
                   build=build_facts("rwkv6_scan_bwd", "wkv_bwd"))
    del plain, grads
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


# K7's and K8's backward at the chunk and state sizes the zoo reaches
# (zamba2-2.7b: Q 128, N = P = 64, G 1; the smoke config: Q 32, N = P = 16;
# ragged last chunks; two groups), then timed at the models' training
# shapes (the train phase's batch, 4 x 2048 tokens): zamba2-2.7b's 80
# heads in bf16, rwkv6-3b's 40 heads in fp32 (the model's type for K8)
MAMBA_BWD_SHAPES = {"zamba2 chunk": (1, 384, 4, 1, 64, 64, 128),
                    "smoke chunk": (2, 128, 4, 1, 16, 16, 32),
                    "ragged 200 of Q 128": (2, 200, 3, 1, 64, 64, 128),
                    "ragged 70 of Q 32": (1, 70, 3, 1, 16, 16, 32),
                    "groups": (2, 96, 4, 2, 16, 16, 32),
                    # the bf16 plan cuts the group into 2 or 4 tiles of 4
                    # or 2 heads (one or two blocks an SM); last chunk 16
                    "head tiles, ragged 2000 of Q 32": (2, 2000, 8, 1, 32,
                                                        32, 32),
                    # mamba2's d_state 128 (two tiles of 64 state rows) at
                    # the chunk each type runs there (kernel_chunk: 64 in
                    # fp32): last chunks of 72 (8 in fp32) and 2, two
                    # groups, and a second tile of 36 rows at N 100
                    "N 128, ragged 200": (2, 200, 3, 1, 128, 64, 128),
                    "N 128 groups": (2, 96, 4, 2, 128, 32, 32),
                    "N 100, ragged 130": (1, 130, 6, 2, 100, 24, 64)}
SCAN_BWD_TIMED = {"zamba2-2.7b train": (4, 2048, 80, 1, 64, 64, 128),
                  "rwkv6-3b train": (4, 2048, 40, 64),
                  # mamba2-2.7b (state-spaces/mamba2-2.7b: d_state 128,
                  # headdim 64, 80 heads of d_inner 5120, one group) at
                  # the train phase's batch; the chunk the pair runs there
                  # (kernel_chunk) and the other one, timed beside it
                  "mamba2-2.7b train": (4, 2048, 80, 1, 128, 64, 128)}


def scan_bwd_rows():
    """K7's backward in fp32 and bf16 at ``MAMBA_BWD_SHAPES`` (each at
    the chunk its type runs, ``kernel_chunk``; N 128 among them) and K8's
    at every N of ``HEAD_DIMS`` (S 100: a last stretch of 4 steps) and at
    S 1000 (many stretches, the last of 8 steps), then both timed at
    ``SCAN_BWD_TIMED`` with their planted faults (K7 also in fp32), K7 also
    at mamba2-2.7b's
    training shape at both chunks of N 128 (64 and 128; ``chunk_runs``
    marks the one a gradient runs at); K8 must refuse a bf16 gradient on
    CUDA tensors.  The fp32 K7 rows' worst distance from the plain
    backward is printed beside ``BOUNDARY_NOISE``'s K7 term
    (``k7_bwd_fp32``).  Returns the timed rows and the largest errors."""
    worst = {"mamba2_scan_bwd": 0.0, "rwkv6_scan_bwd": 0.0}
    fp32_rel = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape in MAMBA_BWD_SHAPES.items():
            B, S, H, G, N, P, Q = shape
            shape = (B, S, H, G, N, P, ms.kernel_chunk(Q, N, dtype))
            r = check_mamba_bwd(*shape, dtype, label,
                                fault=label in ("groups", "N 128 groups"))
            if dtype == torch.float32:
                fp32_rel = max(fp32_rel, r["rel_err"])
            if dtype == torch.bfloat16 and label.startswith("head tiles") \
                    and not (r["heads"] > 1 and r["tiles"] > 1):
                raise AssertionError(f"mamba2_scan_bwd at {label}: the plan "
                                     f"is not several tiles of several "
                                     f"heads: {r}")
            worst["mamba2_scan_bwd"] = max(worst["mamba2_scan_bwd"],
                                           r["max_abs_err"])
    for N in rs.HEAD_DIMS:
        r = check_rwkv_bwd(2, 100, 3, N, f"N {N}", fault=N == 16)
        worst["rwkv6_scan_bwd"] = max(worst["rwkv6_scan_bwd"],
                                      r["max_abs_err"])
    # 62 whole stretches and a last one of 8 steps, at rwkv6's N
    r = check_rwkv_bwd(2, 1000, 3, 64, "ragged 1000 of 16")
    worst["rwkv6_scan_bwd"] = max(worst["rwkv6_scan_bwd"], r["max_abs_err"])
    # N 48 through the wrapper: padded to 64, the gradient sliced back
    r = rwkv_grad_row(2, 100, 3, 48, "padded N 48")
    worst["rwkv6_scan_bwd"] = max(worst["rwkv6_scan_bwd"], r["max_abs_err"])
    q = torch.zeros((1, 4, 2, 16), dtype=torch.bfloat16, device="cuda",
                    requires_grad=True)
    try:                               # a type the backward does not take
        rs.rwkv6_scan_kernel(q, q, q, q, torch.zeros((2, 16), device="cuda"))
    except TypeError:
        pass
    else:
        raise AssertionError("rwkv6_scan took a bf16 gradient")
    # the fp32 design (the agreement checks' type) timed at the same shape
    check_mamba_bwd(*SCAN_BWD_TIMED["zamba2-2.7b train"], torch.float32,
                    "zamba2-2.7b train fp32", timed=True)
    rows = {"mamba2_scan_bwd": check_mamba_bwd(
        *SCAN_BWD_TIMED["zamba2-2.7b train"], torch.bfloat16,
        "zamba2-2.7b train", timed=True, fault=True),
        "rwkv6_scan_bwd": check_rwkv_bwd(
        *SCAN_BWD_TIMED["rwkv6-3b train"], "rwkv6-3b train", timed=True,
        plain_rows=1, fault=True)}
    for k, r in rows.items():
        worst[k] = max(worst[k], r["max_abs_err"])
    B, S, H, G, N, P, Q = SCAN_BWD_TIMED["mamba2-2.7b train"]
    ran = ms.kernel_chunk(Q, N, torch.bfloat16)
    for q in (ran, 64 if ran == 128 else 128):
        r = check_mamba_bwd(B, S, H, G, N, P, q, torch.bfloat16,
                            f"mamba2-2.7b train, chunk {q}", timed=True,
                            fault=q == ran, extra=dict(chunk_runs=q == ran))
        worst["mamba2_scan_bwd"] = max(worst["mamba2_scan_bwd"],
                                       r["max_abs_err"])
    emit("k7_bwd_fp32", worst_rel_err=fp32_rel,
         boundary_noise=BOUNDARY_NOISE[1],
         within_boundary_noise=fp32_rel <= BOUNDARY_NOISE[1])
    return rows, worst


def train_kernel_phase():
    """The backward kernels.  K6's: at every (d, dv) pair of ``PAIRS``,
    fp32 and bf16, causal and not, at S = T = 100 (ragged tiles) and at
    S 96 != T 160, with 2 query heads a KV head, and at 4 a KV head; then
    timed at each of ``BWD_TIMED`` (two runs bit-equal), where at
    gemma-7b's training shape the gate must reject D left at zero.  Then
    K7's and K8's (``scan_bwd_rows``).  Returns the main row of each
    backward (K6 at gemma-7b's shape) and the largest errors.

    Alone on the card: ``python3 -c 'import chip_smoke as c;
    c.cuda_build.build_all(); c.train_kernel_phase()'``."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for d, dv in fa.PAIRS:
                for S, T in ((100, 100), (96, 160)):
                    r = check_flash_bwd(2, S, 4, 2, d, dtype, causal,
                                        f"pair {d, dv} S {S} T {T}", dv=dv,
                                        T=T)
                    worst = max(worst, r["max_abs_err"])
            r = check_flash_bwd(1, 130, 8, 2, 64, dtype, causal, "G 4")
            worst = max(worst, r["max_abs_err"])
        # (96, 96) through the wrapper: on (128, 128), padded and sliced
        r = flash_grad_row(2, 100, 4, 2, 96, 96, dtype, True,
                           "padded (96, 96)")
        worst = max(worst, r["max_abs_err"])
    rows = {label: check_flash_bwd(c["B"], c["S"], c["H"], c["KV"], c["d"],
                                   torch.bfloat16, True, label, dv=c["dv"],
                                   timed=True,
                                   fault=label == "gemma-7b train")
            for label, c in BWD_TIMED.items()}
    worst = max([worst] + [r["max_abs_err"] for r in rows.values()])
    main, errs = scan_bwd_rows()
    main["flash_attention_bwd"] = rows["gemma-7b train"]
    errs["flash_attention_bwd"] = worst
    return main, errs


def sdpa_backends(q, k, v, causal: bool, gqa: bool, dout=None) -> dict:
    """``scaled_dot_product_attention`` on q, k, v ([B, S, H, d] layouts)
    under each of its backends alone: its device ms, or why it refused;
    given ``dout``, its backward's (the forward once, then the backward
    alone, timed)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(b):
                if dout is None:
                    sdpa(qt, kt, vt, is_causal=causal, enable_gqa=gqa)
                    torch.cuda.synchronize()
                    out[b.name] = device_ms(lambda: sdpa(
                        qt, kt, vt, is_causal=causal, enable_gqa=gqa),
                        reps=3, rounds=3)
                else:
                    leaves = [t.detach().requires_grad_()
                              for t in (qt, kt, vt)]
                    o = sdpa(*leaves, is_causal=causal, enable_gqa=gqa)
                    do = dout.transpose(1, 2)
                    out[b.name] = device_ms(lambda: torch.autograd.grad(
                        o, leaves, do, retain_graph=True), reps=2, rounds=3)
                    del o, leaves
        except (RuntimeError, torch.OutOfMemoryError) as e:
            out[b.name] = f"refused: {str(e)[:120]}"
        torch.cuda.empty_cache()
    return out


def wide_route(q, k, v, dtype) -> dict:
    """What K6's wide route runs at q, k, v's widths in ``dtype``: bf16
    the wgmma kernels at ``wide_pair``'s widths (zero-padded where the
    caller's are no multiple of 8, the copy's ms given), each kernel's
    plan (``wide_plan``), which must equal the source's own, and the score
    work; fp32 the CUDA-core kernels, which form the scores once a group
    of ``WIDE_GROUP`` value columns."""
    d, dv = q.shape[3], v.shape[3]
    if dtype != torch.bfloat16:
        return dict(design="wide_cuda_cores",
                    score_work=dict(forward=-(-dv // fa.WIDE_GROUP)))
    pair = fa.wide_pair(d, dv, dtype)
    plans = {kind: fa.wide_plan(*pair, kind) for kind in fa.WIDE_KINDS}
    for kind, plan in plans.items():
        src = fa.wide_source_plan(*pair, kind)
        if src != plan or fa.wide_smem_bytes(*pair, kind, dtype) \
                != plan.smem_bytes:
            raise AssertionError(f"flash_attention_wide at {pair}: the "
                                 f"source's {kind} plan {src} is not "
                                 f"wide_plan's {plan}")
    row = dict(design="wide_wgmma", runs_at=list(pair),
               plans={kind: p._asdict() for kind, p in plans.items()},
               score_work=fa.wide_score_work(*pair))
    if pair != (d, dv):
        row["pad_ms"] = device_ms(lambda: fa.pad_to_pair(q, k, v, pair),
                                  reps=3, rounds=3)
    return row


def check_rwkv_wide_bwd(B, S, H, N, label, timed=False, plain_rows=None,
                        seed=0):
    """K8's gradient at N past ``rs.BLOCK_N`` as a caller gets it
    (``RWKV6Blocks``: the forward and backward kernels on the stacked
    blocks, one launch each), fp32, from a nonzero state, with gradients
    of y and of the final state, against autograd through the plain
    version on the first ``plain_rows`` rows within ``BWD_TOL``.  Timed
    rows add the backward's time (autograd's backward of the recorded
    forward: the kernel on the blocks and their sums), the plain
    backward's on those rows and the bound of the gradient's own work at
    N (``costs.rwkv_bwd``)."""
    dtype = torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = randn((B, S, H, N), dtype, g)
    k = randn((B, S, H, N), dtype, g, 0.3)
    v = randn((B, S, H, N), dtype, g)
    w = torch.sigmoid(randn((B, S, H, N), dtype, g))
    u = randn((B * H, N), dtype, g, 0.1)
    s0 = randn((B, H, N, N), dtype, g, 0.1)
    dy = randn((B, S, H, N), dtype, g)
    dstate = randn((B, H, N, N), dtype, g, 0.3)
    leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0)]
    before = (rs.LAUNCHES, rs.BWD_LAUNCHES)
    y, st = rs.rwkv6_scan_kernel(*leaves)
    grads = torch.autograd.grad((y, st), leaves, (dy, dstate),
                                retain_graph=timed)
    launched = [rs.LAUNCHES - before[0], rs.BWD_LAUNCHES - before[1]]
    n = B if plain_rows is None else plain_rows
    pargs = (r[:n], k[:n], v[:n], w[:n], u[:n * H], s0[:n], dy[:n],
             dstate[:n])
    plain = rs.rwkv6_scan_backward_plain(*pargs)
    rows = [t[:n] for t in grads[:4]] + [grads[4][:n * H], grads[5][:n]]
    torch.cuda.synchronize()
    rel = grads_rel(rows, plain)
    tol = BWD_TOL[dtype]
    row = dict(kernel="rwkv6_scan_bwd", shape=label, B=B, S=S, H=H, N=N,
               dtype=dtype_name(dtype), blocks_a_way=rs.padded_n(N)
               // rs.BLOCK_N, checked_rows=n, rel_err=rel, tol=tol,
               launches=launched,
               max_abs_err=max(max_err(a, b) for a, b in zip(rows, plain)),
               plain_max_abs=max(float(b.float().abs().max())
                                 for b in plain))
    if launched != [1, 1] or not rel <= tol:
        raise AssertionError(f"rwkv6_scan_bwd differs at {label}: {row}")
    if timed:
        flops, nbytes = costs.rwkv_bwd(B, S, H, N, rs.SAVE_EVERY)
        b_ms, b_by = bound(nbytes, ops=flops)
        t_ms = device_ms(lambda: torch.autograd.grad(
            (y, st), leaves, (dy, dstate), retain_graph=True),
            reps=3, rounds=5)
        row.update(ms=t_ms,
                   plain_ms=device_ms(lambda: rs.rwkv6_scan_backward_plain(
                       *pargs), reps=1, rounds=3),
                   plain_ms_rows=n, bound_ms=b_ms, bound_by=b_by,
                   **timed_extras("rwkv6_scan_bwd", label, t_ms, b_ms),
                   library_ms=None,
                   library="none: no single PyTorch call computes the "
                           "gradient of the RWKV6 recurrence")
    del plain, grads
    emit("kernel_check", **row)
    torch.cuda.empty_cache()
    return row


# the lifted widths (K5-K8 past the instances the zoo's widths run), at
# small shapes, fp32 and bf16: K7 P 128 and 96, N 256 and 160; K8 N 128
# and 96; K6 these (d, dv) causal and not ((300, 100): bf16 zero-padded
# to whole 16-byte rows, the gradient through the wrapper); K5 these
# (d, dv)
WIDE_K7 = {"P 128": (1, 200, 3, 1, 64, 128, 64),
           "P 96": (1, 200, 3, 1, 64, 96, 64),
           "N 256": (1, 200, 3, 1, 256, 32, 64),
           "N 160": (1, 200, 3, 1, 160, 32, 64)}
WIDE_K8 = (128, 96)
WIDE_K6 = ((320, 320), (512, 512), (288, 512), (512, 128), (576, 512),
           (300, 100))
# (d, dv, page, P[, decode_case's options, and "rows"]) at 3 rows (or
# "rows") x 5 heads (``wide_k5_case``); fp32 runs every row on the TF32
# walk
WIDE_K5 = ((640, 512, 16, 5), (576, 640, 16, 5), (1024, 1024, 16, 5),
           # bf16: a ragged width (rows not whole 16-byte chunks) on the
           # TF32 walk; on the tensor-core walk, two groups of its 1024
           # value columns, and Q streamed through K's ring entries past
           # d 4800 (as the TF32 walk streams it at every row here), each
           # a page of 256 tokens a split, so that a split walks 4 tiles
           (1001, 520, 16, 5), (768, 1280, 256, 8), (4928, 520, 256, 8),
           # the ragged width at pages of 256: a split walks several tiles
           (1001, 520, 256, 4),
           # ragged rows at pages of 7 over a pool of exactly the table's
           # 9 slots, every page full: the table names the pool's last
           # slot, whose last row ends mid-window (cp.async reads only the
           # bytes that remain)
           (1001, 602, 7, 3, dict(n_slots=9, length=21)),
           # Q resident, one K chunk, and a second group of 6 value columns
           # (a tile of two ring entries, so the copies run tiles ahead of
           # the reads), ragged in both types, every row full: each split a
           # page of 4 tiles; then at pages of 7, so that a token's shifts
           # differ from tile to tile (at pages that are whole windows they
           # repeat every tile), over 64 rows, so that each split is 30
           # pages, 4 tiles
           (60, 1030, 256, 4, dict(length=1024)),
           (60, 1030, 7, 60, dict(rows=64, length=420)))
# one timed row a lifted axis, at a zoo family's own total width with
# that axis alone changed: mamba2-2.7b's d_inner 5120 as 40 heads of P
# 128 (N 128) and its 80 heads of P 64 at N 256; rwkv6-3b's 2560 as 20
# heads of N 128; K6 (512, 512) at 8 heads, and (576, 512) at 16 query
# heads over one KV head (deepseek-v2's absorbed MLA: kv_lora_rank 512 +
# rope 64 against the latent); K5 (1024, 1024) at 8 rows x 16 heads over
# 4096 tokens, in bf16 (the tensor-core walk), in fp32 and at a ragged bf16
# (1001, 1000) (the TF32 walk)
WIDE_TIMED = {"mamba2-2.7b P 128": (4, 2048, 40, 1, 128, 128, 128),
              "mamba2-2.7b N 256": (4, 2048, 80, 1, 256, 64, 128),
              "rwkv6-3b N 128": (4, 2048, 20, 128),
              "(512, 512) x 8 heads": (4, 2048, 8, 8, 512, 512),
              "(576, 512) MLA x 16 heads": (4, 2048, 16, 1, 576, 512),
              "(1024, 1024) decode": (8, 16, 1024, 16, 256),
              "(1024, 1024) decode fp32": (8, 16, 1024, 1024, 16, 256,
                                           torch.float32),
              "(1001, 1000) decode bf16": (8, 16, 1001, 1000, 16, 256,
                                           torch.bfloat16)}


def wide_k5_case(d, dv, page, P, dtype, opts=None):
    """A ``WIDE_K5`` row's inputs: 3 rows (or ``opts["rows"]``) x 5 heads,
    ``decode_case`` given the row's other options."""
    opts = dict(opts or {})
    return decode_case(opts.pop("rows", 3), 5, d, page, P, dtype, dv=dv,
                       **opts)


def wide_phase():
    """The widths past the kernels' instances, forward and backward
    (``WIDE_K5``-``WIDE_K8``), each row against its plain version with its
    launches counted, then one timed row a lifted axis (``WIDE_TIMED``),
    each printing its seconds; the build's seconds of the sources that
    hold the new instances lead.  Returns the largest error of each
    kernel.

    Alone on the card: ``python3 -c 'import chip_smoke as c;
    c.cuda_build.build_all(); c.wide_phase()'``."""
    emit("wide_build", seconds_by_source={
        k: cuda_build.BUILD_SECONDS.get(k) for k in (
            "decode_attention", "flash_attention_wide", "mamba2_scan",
            "mamba2_scan_bwd")},
        new_instances={
            "decode_attention": build_facts("decode_attention",
                                            "decode_walk_kernel",
                                            "decode_walk_tc_kernel"),
            "flash_attention_wide": build_facts("flash_attention_wide",
                                                "wide_")},
        # ptxas's warnings, and its notes of a wgmma pipeline serialised
        warnings=[ln for ln in cuda_build.BUILD_LOG.get(
            "flash_attention_wide", "").splitlines()
            if "arning" in ln or "Performance Loss" in ln][:20])
    errs = {}

    def note(r):
        errs[r["kernel"]] = max(errs.get(r["kernel"], 0.0), r["max_abs_err"])
        t = time.perf_counter() - t0
        emit("wide_row", kernel=r["kernel"], shape=r["shape"], seconds=t)
        return r

    for dtype in (torch.float32, torch.bfloat16):
        for label, (B, S, H, G, N, P, Q) in WIDE_K7.items():
            t0 = time.perf_counter()
            note(check_mamba(B, S, H, G, N, P, Q, dtype, f"wide {label}"))
            t0 = time.perf_counter()
            note(check_mamba_bwd(B, S, H, G, N, P,
                                 ms.kernel_chunk(Q, N, dtype), dtype,
                                 f"wide {label}"))
        for N in WIDE_K8:
            t0 = time.perf_counter()
            note(check_rwkv(1, 100, 3, N, dtype, f"wide N {N}"))
        for causal in (True, False):
            for d, dv in WIDE_K6:
                t0 = time.perf_counter()
                note(check_flash(1, 100, 4, 2, d, dtype, causal,
                                 f"wide {d, dv}", dv=dv))
                t0 = time.perf_counter()
                if fa.wide_pair(d, dv, dtype) != (d, dv):
                    # bf16 at widths TMA cannot map: through the padding
                    note(flash_grad_row(1, 100, 4, 2, d, dv, dtype, causal,
                                        f"wide {d, dv}"))
                else:
                    note(check_flash_bwd(1, 100, 4, 2, d, dtype, causal,
                                         f"wide {d, dv}", dv=dv))
        for d, dv, page, P, *opts in WIDE_K5:
            t0 = time.perf_counter()
            note(check_decode(wide_k5_case(d, dv, page, P, dtype, *opts),
                              f"wide {d, dv} page {page}"))
    for N in WIDE_K8:                  # the gradient is fp32 only
        t0 = time.perf_counter()
        note(check_rwkv_wide_bwd(2, 100, 3, N, f"wide N {N}"))
    for label in ("mamba2-2.7b P 128", "mamba2-2.7b N 256"):
        B, S, H, G, N, P, Q = WIDE_TIMED[label]
        t0 = time.perf_counter()
        note(check_mamba(B, S, H, G, N, P, Q, torch.bfloat16, label,
                         timed=True))
        t0 = time.perf_counter()
        note(check_mamba_bwd(B, S, H, G, N, P,
                             ms.kernel_chunk(Q, N, torch.bfloat16),
                             torch.bfloat16, label, timed=True))
    B, S, H, N = WIDE_TIMED["rwkv6-3b N 128"]
    t0 = time.perf_counter()
    note(check_rwkv(B, S, H, N, torch.float32, "rwkv6-3b N 128", timed=True,
                    plain_rows=1))
    t0 = time.perf_counter()
    note(check_rwkv_wide_bwd(B, S, H, N, "rwkv6-3b N 128", timed=True,
                             plain_rows=1))
    for label in ("(512, 512) x 8 heads", "(576, 512) MLA x 16 heads"):
        B, S, H, KV, d, dv = WIDE_TIMED[label]
        t0 = time.perf_counter()
        note(check_flash(B, S, H, KV, d, torch.bfloat16, True, label,
                         timed=True, fault=True, dv=dv))
        t0 = time.perf_counter()
        note(check_flash_bwd(B, S, H, KV, d, torch.bfloat16, True, label,
                             dv=dv, timed=True, fault=True))
    B, H, d, page, P = WIDE_TIMED["(1024, 1024) decode"]
    t0 = time.perf_counter()
    note(check_decode(decode_case(B, H, d, page, P, torch.bfloat16,
                                  length=P * page, dv=d),
                      "(1024, 1024) decode", timed=True,
                      fault=decode_rescale_dropped))
    for label in ("(1024, 1024) decode fp32", "(1001, 1000) decode bf16"):
        B, H, d, dv, page, P, dtype = WIDE_TIMED[label]
        t0 = time.perf_counter()
        note(check_decode(decode_case(B, H, d, page, P, dtype,
                                      length=P * page, dv=dv),
                          label, timed=True, fault=decode_rescale_dropped))
        torch.cuda.empty_cache()
    return errs


def serve_shape_case():
    """The serve phase's attention launch: one request's 8 KV-head rows of
    5 query heads over a 4097-token history in the arena's pool."""
    c = SERVE
    P = c["context"] // c["page"] + 1
    return decode_case(c["kv_heads"], c["q_heads"] // c["kv_heads"],
                       c["head_dim"], c["page"], P, torch.float32,
                       n_slots=SERVE_POOL, length=c["context"] + 1)


# K5's width rows, (B, H, d, dv, page, P[, lengths]) in both types: widths
# past the square instances ((96, 96), (64, 32), rows that are not whole
# 16-byte chunks (100, 60), the wide ones small); then route 5's widths
# (bf16 whole chunks past 256 up to (576, 512): MLA's latent at 1, 5, 64,
# 65, 70 and 128 heads, pages of 7, 16 and 256, (264, 256), (320, 512),
# (200, 304); rows of length 0 and 1) and, in fp32 and at (100, 60) bf16,
# the head counts about route 2's (the lanes, up to 4) and route 3's (the
# TF32 walk, past 4)
DECODE_WIDTHS = ((3, 8, 96, 96, 16, 4), (2, 4, 64, 32, 32, 2),
                 (2, 5, 100, 60, 8, 5), (2, 3, 200, 64, 16, 3),
                 (2, 1, 256, 256, 16, 6), (2, 20, 576, 512, 16, 4),
                 (2, 1, 576, 512, 7, 10), (2, 5, 576, 512, 256, 3),
                 (2, 65, 576, 512, 7, 12), (2, 70, 576, 512, 16, 5),
                 (2, 128, 576, 512, 256, 2), (2, 70, 264, 256, 16, 4),
                 (2, 8, 320, 512, 7, 9), (2, 3, 200, 304, 16, 3),
                 (2, 4, 100, 60, 7, 6),
                 (4, 64, 576, 512, 16, 8, (0, 1, 77, 128)))
# the timed zoo widths: gemma-7b's KV pages (d 256: 8 sequences x 16 KV
# heads, 1 query head each) and deepseek-v2's paged MLA latent (keys 576 =
# kv_lora_rank 512 + rope 64, values 512, 128 query heads on one latent
# row) at 4096 tokens in pages of 64, in bf16 and fp32: (B, H, d, dv), KV
# heads, type
DECODE_TIMED = (
    ("gemma-7b decode", (128, 1, 256, 256), 16, torch.bfloat16),
    ("deepseek-v2 MLA latent decode", (8, 128, 576, 512), 1, torch.bfloat16),
    ("gemma-7b decode fp32", (128, 1, 256, 256), 16, torch.float32),
    ("deepseek-v2 MLA latent decode fp32", (8, 128, 576, 512), 1,
     torch.float32))


def decode_width_phase():
    """K5 at ``DECODE_WIDTHS`` in both types, then timed at
    ``DECODE_TIMED`` (the MLA latent rows against the planted
    ``decode_rescale_dropped``, the others ``decode_split_dropped``).
    Returns the largest error.

    Alone on the card: ``python3 -c 'import chip_smoke as c;
    c.cuda_build.build_all(("decode_attention",));
    c.decode_width_phase()'``."""
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, d, dv, page, P, *lens in DECODE_WIDTHS:
            r = check_decode(decode_case(B, H, d, page, P, dtype, dv=dv,
                                         lens=lens[0] if lens else None),
                             f"width {d, dv} {B, H, page, P}")
            err = max(err, r["max_abs_err"])
    for label, shape, kv, dtype in DECODE_TIMED:
        B, H, d, dv = shape
        fault = decode_rescale_dropped if d == 576 else decode_split_dropped
        r = check_decode(decode_case(B, H, d, 64, 64, dtype,
                                     length=4096, dv=dv),
                         label, timed=True, kv_heads=kv, fault=fault)
        err = max(err, r["max_abs_err"])
        torch.cuda.empty_cache()
    return {"decode_attention": err}


def kernel_phase():
    main = {}
    errs = {"tac_probe": 0.0, "page_gather": 0.0, "page_scatter": 0.0}
    W = E2E["cache_entries"]
    for dtype in (torch.float32, torch.bfloat16):
        for nb, ways, D, B in ((16, 8, 64, 32), (8, 4, 128, 16),
                               (32, 16, 32, 64)):
            r = check_probe(nb, ways, D, B, dtype)
            errs["tac_probe"] = max(errs["tac_probe"], r["max_abs_err"])
        # value rows past the old cap of 1536 columns: tiles of 1024
        for D in (1537, 4096):
            check_probe(16, 8, D, 32, dtype, exact=True)
        for n_slots, page, d, N in ((9, 1, 2, 8), (16, 4, 32, 12),
                                    (64, 16, 8, 40)):
            for check in (check_gather, check_scatter):
                r = check(n_slots, page, d, N, dtype)
                errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
    # the fused path's shapes: one bucket of W ways; pool [W + 1, 1, V + 1]
    main["tac_probe"] = check_probe(1, W, 1, 256, torch.float32, timed=True)
    check_probe(1, DEPLOY_SLOTS, 1, 256, torch.float32, timed=True)
    # a shard of the tac_ops phase: 8192 buckets x 8 ways, D 1
    check_probe(TAC_OPS["buckets"], TAC_OPS["ways"], 1, TAC_OPS["batch"],
                torch.float32, timed=True)
    main["page_scatter"] = check_scatter(W + 1, 1, 2, 256, torch.float32,
                                         timed=True)
    # one bandwidth-sized scatter (serving-like 8 KB pages)
    check_scatter(4096, 16, 128, 256, torch.float32, timed=True)
    # K2 at the shapes it launches at, timed in fp32; the serve append is
    # its main-path shape
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape in gather_shapes().items():
            r = check_gather(*shape, dtype, label,
                             timed=dtype == torch.float32)
            errs["page_gather"] = max(errs["page_gather"], r["max_abs_err"])
            if label == "serve append" and dtype == torch.float32:
                main["page_gather"] = r
    # paged decode attention: tests/test_kernels.py's shapes, the serve
    # phase's launch, and decode_32k at qwen2.5-32b's width (the plain
    # version checks its first plain_seqs sequences: all 128 would not fit
    # beside the pool)
    errs["decode_attention"] = errs["cms_sketch"] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, d, page, P in ((3, 8, 32, 16, 4), (2, 4, 64, 32, 2),
                                 (4, 16, 16, 8, 8)):
            r = check_decode(decode_case(B, H, d, page, P, dtype),
                             f"test_kernels {B, H, d, page, P}")
            errs["decode_attention"] = max(errs["decode_attention"],
                                           r["max_abs_err"])
        # rows of length 0 and 1, rows whose trailing splits hold no page
        # (table entries past seq_len -1), a one-page table, and enough
        # rows that a split holds several pages
        for B, H, d, page, P, lens in (
                (4, 5, 128, 16, 32, (0, 1, 40, 512)),
                (3, 8, 32, 16, 1, (0, 1, 16)),
                (160, 5, 64, 8, 40, (0, 1, *np.random.default_rng(9)
                                     .integers(0, 321, 158)))):
            r = check_decode(decode_case(B, H, d, page, P, dtype, lens=lens),
                             f"edge {B, H, d, page, P}")
            errs["decode_attention"] = max(errs["decode_attention"],
                                           r["max_abs_err"])
    main["decode_attention"] = check_decode(
        serve_shape_case(), "serve", timed=True, kv_heads=SERVE["kv_heads"])
    c = DECODE_32K
    r = check_decode(decode_32k_case(c), "decode_32k", timed=True,
                     plain_rows=c["plain_seqs"] * c["kv_heads"],
                     kv_heads=c["kv_heads"])
    torch.cuda.empty_cache()
    errs["decode_attention"] = max(errs["decode_attention"], r["max_abs_err"])
    for k, e in decode_width_phase().items():
        errs[k] = max(errs[k], e)
    # count-min sketch: tests/test_kernels.py's sweep and saturation case,
    # the hint filter's default sketch (d 4, w 10,000) on a batch of 256
    # with repeated keys and warm counters, and B 16,384 (past the earlier
    # design's cap of 12,288) with a hot key of 2048 copies that
    # saturates, these three timed; then columns out of the row, an odd
    # width, B to 40,000
    for d, w, B in ((4, 256, 64), (2, 512, 128), (4, 128, 32)):
        check_cms(*cms_case(d, w, B), f"test_kernels {d, w, B}")
    check_cms(*cms_case(2, 64, 32, heavy=32,
                        counters=np.full((2, 64), 250, np.int32),
                        ab=(np.asarray([3, 7], np.uint32),
                            np.asarray([1, 5], np.uint32))), "saturation",
              timed=True)
    rs = np.random.RandomState(1)                 # classify_batch's draws
    ab = ((rs.randint(1, 2 ** 31 - 1, size=4).astype(np.uint32) | 1),
          rs.randint(0, 2 ** 31 - 1, size=4).astype(np.uint32))
    warm = np.random.RandomState(5).randint(0, 40, (4, 10_000)) \
        .astype(np.int32)
    main["cms_sketch"] = check_cms(*cms_case(4, 10_000, 256, heavy=64,
                                             key_range=5000, counters=warm,
                                             ab=ab),
                                   "hint_filter", timed=True)
    check_cms(*cms_case(4, 10_000, 16_384, heavy=2048, key_range=5000,
                        counters=warm, ab=ab), "B 16384", timed=True)
    for d, w, B in ((3, 4099, 5000), (1, 7, 3000), (2, 10_000, 40_000)):
        check_cms_out_of_row(d, w, B)
    for k in main:
        errs[k] = max(errs[k], main[k]["max_abs_err"])
    return main, errs


# ------------------------------------------------------------- end to end
def reset_launches():
    tp.LAUNCHES = pg.GATHER_LAUNCHES = pg.SCATTER_LAUNCHES = 0
    tfk.STEP_LAUNCHES = tfk.ADMIT_LAUNCHES = 0
    da.LAUNCHES = cms.LAUNCHES = 0
    fa.LAUNCHES = fa.BWD_LAUNCHES = ms.LAUNCHES = rs.LAUNCHES = 0
    ms.BWD_LAUNCHES = rs.BWD_LAUNCHES = 0


def launches():
    return {"tac_probe": tp.LAUNCHES, "page_gather": pg.GATHER_LAUNCHES,
            "page_scatter": pg.SCATTER_LAUNCHES,
            "tac_fused_step": tfk.STEP_LAUNCHES,
            "tac_fused_admit": tfk.ADMIT_LAUNCHES,
            "decode_attention": da.LAUNCHES, "cms_sketch": cms.LAUNCHES,
            "flash_attention": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "mamba2_scan": ms.LAUNCHES, "mamba2_scan_bwd": ms.BWD_LAUNCHES,
            "rwkv6_scan": rs.LAUNCHES, "rwkv6_scan_bwd": rs.BWD_LAUNCHES}


FUSED_KERNELS = ("tac_fused_step", "tac_fused_admit")
ARENA_KERNELS = ("tac_probe", "page_gather", "page_scatter")
SERVE_KERNELS = ARENA_KERNELS + ("decode_attention",)


def on_cpu_threads(fn, *args, **kw):
    """``fn`` with torch on one CPU thread (small CPU ops lose time to
    thread hand-offs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(threads)


# the processes CpuSide starts; any still running when the script ends
# is killed
CPU_SIDES = []
atexit.register(lambda: [p.kill() for p in CPU_SIDES if p.poll() is None])


class CpuSide:
    """``chip_smoke.<name>(*args, **kw)`` on the CPU in a process of its
    own (torch on one thread, no CUDA device visible), started at once so
    that it runs beside the card's side of a comparison; ``result()``
    waits for it and returns ``(result, wall s)``."""

    def __init__(self, name: str, *args, **kw):
        fd, self.out = tempfile.mkstemp(suffix=".pkl")
        os.close(fd)
        here = str(Path(__file__).resolve().parent)
        code = ("import pickle, sys, time\n"
                f"sys.path.insert(0, {here!r})\n"
                "import torch\n"
                "torch.set_num_threads(1)\n"
                "import chip_smoke\n"
                "name, args, kw, out = pickle.load(sys.stdin.buffer)\n"
                "t0 = time.perf_counter()\n"
                "res = getattr(chip_smoke, name)(*args, **kw)\n"
                "wall = time.perf_counter() - t0\n"
                "with open(out, 'wb') as f:\n"
                "    pickle.dump((res, wall), f)\n")
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], stdin=subprocess.PIPE,
            stdout=sys.stderr, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        CPU_SIDES.append(self.proc)
        self.proc.stdin.write(pickle.dumps((name, args, kw, self.out)))
        self.proc.stdin.close()

    def result(self):
        rc = self.proc.wait()
        try:
            if rc != 0 or not os.path.getsize(self.out):
                raise RuntimeError(f"the CPU side {self.name} exited {rc} "
                                   f"with no result")
            with open(self.out, "rb") as f:
                return pickle.load(f)
        finally:
            os.unlink(self.out)


def run_query(query: str, device: str, mode: str = "async",
              duration: float = E2E["duration"],
              warmup: float = E2E["warmup"], batch: int = E2E["batch"]):
    c = E2E
    if query == "ysb":
        eng = build_ysb("tac", mode, YSBConfig(rate=c["rate"], seed=11),
                        cache_entries=c["cache_entries"],
                        parallelism=c["parallelism"], source_parallelism=1,
                        io_workers=8, fused=True, fused_batch=batch,
                        device=device)
    else:
        cfg = NexmarkConfig(rate=c["rate"], active_window=1.0, oo_bound=0.3,
                            seed=7)
        eng = build_query(query, "tac", mode, cfg,
                          cache_entries=c["cache_entries"],
                          parallelism=c["parallelism"],
                          source_parallelism=1, io_workers=4,
                          buffer_timeout=0.002, fused=True,
                          fused_batch=batch, device=device)
    t0 = time.perf_counter()
    m = eng.run(duration=duration, warmup=warmup)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {k: m.get(k) for k in ("n_outputs", "p50", "p99", "p999",
                                 "throughput", "stateful_hit_rate",
                                 "stateful_fused")}
    res["fused_batches"] = sum(v["batches"] for k, v in m.items()
                               if k.endswith("_fused"))
    return res, wall


def counted(total: dict, label: str, fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch count set to 0 just before;
    adds its counts to ``total`` and requires both fused kernels to have
    launched.  Returns ``fn``'s result and its counts."""
    reset_launches()
    out = fn(*args, **kw)
    counts = launches()
    for k in total:
        total[k] += counts[k]
    if min(counts[k] for k in FUSED_KERNELS) == 0:
        raise AssertionError(f"{label}: a fused kernel never launched: "
                             f"{counts}")
    return out, counts


def step_a_batch(label: str, counts: dict, res: dict) -> None:
    """One launch a batch: the whole fused_step is tac_fused_step."""
    if counts["tac_fused_step"] != res["fused_batches"]:
        raise AssertionError(f"{label}: {counts['tac_fused_step']} "
                             f"tac_fused_step launches for "
                             f"{res['fused_batches']} batches")


def cpu_compare(query: str, mode: str,
                batch: int = E2E["batch"]) -> CpuSide:
    """The CPU side of ``card_equals_cpu``'s comparison of ``query`` in
    ``mode`` at fused batch ``batch``, started now."""
    return CpuSide("run_query", query, "cpu", mode, batch=batch, **COMPARE)


def card_equals_cpu(total: dict, query: str, mode: str,
                    cpu_side: CpuSide, batch: int = E2E["batch"]) -> dict:
    """``query`` in ``mode`` at fused batch ``batch`` on the card and, in
    ``cpu_side`` (``cpu_compare``), on the CPU over the same events
    (``COMPARE``: a duration and a warm-up); the results must be equal.
    The card run's launches go to ``total``, the comparisons' own count,
    apart from the phase's full runs.  Returns the comparison's facts for
    the phase's line."""
    run = COMPARE
    (gpu, gpu_wall), counts = counted(total, f"{query} {mode} compare",
                                      run_query, query, "cuda", mode,
                                      batch=batch, **run)
    (cpu, cpu_wall), _ = cpu_side.result()
    if gpu != cpu or not gpu["n_outputs"]:
        raise AssertionError(f"{query} {mode}: cuda run {gpu} != cpu run "
                             f"{cpu}, or no outputs")
    step_a_batch(f"{query} {mode} compare", counts, gpu)
    return dict(equal=True, compared=dict(run, n_outputs=gpu["n_outputs"],
                                          fused_batches=gpu["fused_batches"],
                                          cuda_wall_s=gpu_wall,
                                          launches=counts),
                cpu_wall_s=cpu_wall)


def e2e_phase():
    """q5, q7 and YSB fused on the card at the e2e deployment, each held
    equal to the CPU's run: YSB at full length, q5 and q7 over the shorter
    stream of ``COMPARE``.  Returns the launch counts of the full runs and
    those of the comparisons' card runs."""
    total = {k: 0 for k in launches()}
    compare = {k: 0 for k in launches()}
    cpu_sides = {q: cpu_compare(q, "async") for q in ("q5", "q7")}
    for query in ("q5", "q7", "ysb"):
        (gpu, gpu_wall), counts = counted(total, query, run_query, query,
                                          "cuda")
        if not gpu["n_outputs"]:
            raise AssertionError(f"{query}: no outputs")
        step_a_batch(query, counts, gpu)
        if query == "ysb":
            cpu, cpu_wall = on_cpu_threads(run_query, query, "cpu")
            if gpu != cpu:
                raise AssertionError(f"{query}: cuda run {gpu} != cpu run "
                                     f"{cpu}")
            same = dict(equal=True, cpu_wall_s=cpu_wall)
        else:
            same = card_equals_cpu(compare, query, "async",
                                   cpu_sides[query])
        emit("e2e", query=query, cuda_wall_s=gpu_wall, launches=counts,
             step_launches_per_batch=counts["tac_fused_step"]
             / gpu["fused_batches"], **same, **gpu)
    return total, compare


# a fused batch past the step kernel's old 256-lane cap
WIDE_BATCH = 1024


def wide_cpu_sides() -> dict:
    """The CPU sides of ``wide_batch_phase``, started now (q5's takes about
    a minute of the CPU: main starts them before the kernel checks)."""
    return {q: cpu_compare(q, "async", WIDE_BATCH) for q in ("q5", "ysb")}


def wide_batch_phase(sides=None):
    """q5 and YSB fused at ``fused_batch`` 1024 on the card over the stream
    of ``COMPARE``, each held equal to the CPU's run beside it
    (``CpuSide``, from ``wide_cpu_sides``), one ``tac_fused_step`` launch a
    batch of 1024 lanes.  Returns the card runs' launch counts."""
    total = {k: 0 for k in launches()}
    sides = sides or wide_cpu_sides()
    for query in ("q5", "ysb"):
        emit("e2e_wide", query=query, batch=WIDE_BATCH,
             **card_equals_cpu(total, query, "async", sides[query],
                               WIDE_BATCH))
    return total


def prefetch_phase():
    """The paper's mode on the device plane: q5 and q7 fused at the e2e
    deployment (a shorter run) in ``prefetch`` mode on the card, held equal
    to the CPU over the shorter stream of ``COMPARE`` (one
    ``tac_fused_step`` launch a batch), and in ``sync`` mode on the card.  The headline's gate (prefetch p99.9 below sync, at
    >= 0.98x its throughput; tests/test_system.py) is printed, not
    enforced: at this deployment both modes give the same p99.9 on q5 and
    on q7, in the reference as in the port (PERF.md section 7).  Returns
    the launch counts of the card's runs and those of the comparisons'."""
    total = {k: 0 for k in launches()}
    compare = {k: 0 for k in launches()}
    cpu_sides = {q: cpu_compare(q, "prefetch") for q in ("q5", "q7")}
    for query in ("q5", "q7"):
        runs = {}
        for mode in ("prefetch", "sync"):
            (runs[mode], wall), counts = counted(
                total, f"{query} {mode}", run_query, query, "cuda", mode,
                PREFETCH_DURATION)
            step_a_batch(f"{query} {mode}", counts, runs[mode])
            line = dict(query=query, mode=mode, cuda_wall_s=wall,
                        launches=counts)
            if mode == "prefetch":
                line.update(card_equals_cpu(compare, query, mode,
                                            cpu_sides[query]))
            r = runs[mode]
            emit("prefetch", **line, n_outputs=r["n_outputs"], p50=r["p50"],
                 p99=r["p99"], p999=r["p999"], throughput=r["throughput"],
                 hit_rate=r["stateful_hit_rate"],
                 fused=r["stateful_fused"])
        kp, sync = runs["prefetch"], runs["sync"]
        emit("prefetch_headline", query=query, gated=False,
             p999_below_sync=kp["p999"] < sync["p999"],
             throughput_ratio=kp["throughput"] / sync["throughput"],
             hit_rate_prefetch=kp["stateful_hit_rate"],
             hit_rate_sync=sync["stateful_hit_rate"])
    return total, compare


# ------------------------------------------------- checkpoints and recovery
def count_spec() -> FusedSpec:
    """The counting operator's device encoding (tests/test_fused.py)."""
    return FusedSpec(kind="sum", width=1, weight_of=lambda tup: 1.0,
                     encode=lambda s: None if s is None else [float(s)],
                     decode=lambda v: int(round(float(v[0]))))


HOST_MODULES = ("builtins", "repro_torch.streaming.events")


def foreign_types(obj) -> set:
    """The types in ``obj`` (walked through containers and object
    attributes) that are not plain host types: builtins and the engine's
    event records.  A snapshot must hold nothing else: a tensor would tie
    the checkpoint to the device it was taken on."""
    bad, seen, todo = set(), set(), [obj]
    while todo:
        x = todo.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if type(x).__module__ not in HOST_MODULES:
            bad.add(f"{type(x).__module__}.{type(x).__qualname__}")
            continue
        if isinstance(x, dict):
            todo.extend(x.keys())
            todo.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            todo.extend(x)
        elif hasattr(x, "__dict__"):
            todo.extend(vars(x).values())
        elif hasattr(x, "__slots__"):
            todo.extend(getattr(x, a, None) for a in x.__slots__)
    return bad


class PoolCopies:
    """Counts and times ``FusedPlane._pool_host``, the whole-pool copy to
    the host that a barrier makes twice a subtask (``flush_dirty`` and the
    ``entries`` manifest), while the ``with`` block runs."""

    def __init__(self):
        self.n, self.ms = 0, 0.0

    def __enter__(self):
        self._orig = orig = FusedPlane._pool_host

        def timed(plane):
            if plane._on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(plane)
            self.ms += (time.perf_counter() - t0) * 1e3
            self.n += 1
            return out
        FusedPlane._pool_host = timed
        return self

    def __exit__(self, *exc):
        FusedPlane._pool_host = self._orig


def plane_bytes(op) -> int:
    """The card bytes one fused plane of ``op`` holds (pool, directory,
    staging), as the allocator counts them: a fresh plane's."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    plane = op._new_cache()
    torch.cuda.synchronize()
    n = torch.cuda.memory_allocated() - before
    del plane
    return n


def recovery_run(scenario: str, device: str, failures: int = 1):
    """benchmarks/recovery.py's ``run_one`` for q5 on the port's fused
    plane in ``prefetch`` mode: checkpoints every 0.8 s over a replayable
    source, ``failures`` whole-job failures (``scenario`` "cold" or
    "warmed"; none for "unfailed").  Returns run_one's metrics (simulated
    time, equal on every device) and what this run measured on the host
    and the device."""
    c = RECOVERY
    cfg = NexmarkConfig(rate=c["rate"], active_window=c["active_window"],
                        oo_bound=c["oo_bound"], seed=7)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = build_query("q5", "tac", "prefetch", cfg,
                      cache_entries=c["cache_entries"], backend=LOCAL_NVME,
                      parallelism=c["parallelism"], source_parallelism=1,
                      io_workers=c["io_workers"],
                      buffer_timeout=c["buffer_timeout"],
                      window_size=c["window_size"],
                      window_slide=c["window_slide"], replayable=True,
                      fused=True, fused_batch=c["batch"], device=device)
    # every epoch's record kept, for the walk below
    coord = CheckpointCoordinator(eng, interval=c["ckpt_interval"],
                                  store=SnapshotStore(keep=1 << 30))
    coord.start()
    t_fail = c["warmup"] + c["fail_at"]
    if scenario != "unfailed":
        for at in (t_fail, c["warmup"] + SECOND_FAIL_AT)[:failures]:
            inject_failure_at(eng, at=at, mode=scenario,
                              replay_speedup=c["replay_speedup"])
    with PoolCopies() as copies:
        m = eng.run(duration=c["duration"], warmup=c["warmup"])
    op = eng.operators["stateful"]
    info = dict(wall_s=time.perf_counter() - t0, pool_copies=copies.n,
                pool_copy_ms=copies.ms,
                barriers=coord.epochs_completed + coord.rolled_back)
    if device == "cuda":
        torch.cuda.synchronize()
        gc.collect()
        info.update(mem_bytes=torch.cuda.memory_allocated() - mem0,
                    plane_bytes=plane_bytes(op))
    bad = foreign_types([coord.store.records, coord.store.materialized])
    if bad:
        raise AssertionError(f"recovery {scenario} on {device}: snapshot "
                             f"records hold {sorted(bad)}")
    info["records_walked"] = len(coord.store.records)
    lat = np.asarray(eng.latencies)
    t = np.asarray(eng.latency_t)
    ck = m.get("checkpoint", {})
    res = dict(n_outputs=m["n_outputs"], p50=m["p50"], p99=m["p99"],
               p999=m["p999"], throughput=m["throughput"],
               hit_rate=m["stateful_hit_rate"], fused=m["stateful_fused"],
               epochs_completed=ck.get("epochs_completed", 0),
               snapshot_bytes=ck.get("snapshot_bytes_total", 0),
               failures=coord.failures)
    if scenario != "unfailed":
        rec = m.get("recovery", {})
        done = [d for d in eng.operators["source"].replay_done_t
                if d is not None]
        t_resume = rec.get("last_t_resume", t_fail)
        sel = lat[(t >= t_resume) & (t < t_resume + c["spike_window"])]
        res.update(
            post_restore_p99=float(np.percentile(sel, 99)) if len(sel)
            else None,
            recovery_time=(max(done) if done else c["warmup"]
                           + c["duration"]) - t_fail,
            downtime=rec.get("last_downtime"),
            restore_bytes=rec.get("last_restore_bytes"),
            warmup_hints=rec.get("warmup_hints", 0),
            replayed=rec.get("replayed", 0),
            restored_epoch=rec.get("last_epoch"))
    return res, info


def chaos_count(fused: bool, device: str = "cuda", events: bool = True,
                seed: int = 29, t_cut: float = 0.9):
    """tests/test_fused.py's ``run_chaos_count`` on the port: count per
    key through a live run over a replayable source, with checkpoints, a
    warmed failure and a load shift on the simulated clock.  The source
    is cut on its logical clock, so the final keyed state is a function of
    the seed alone (exactly-once state effects).  Returns that state and
    the failures that fired."""
    eng = Engine()
    rng = np.random.Generator(np.random.PCG64(seed))

    def gen(lt):
        if lt >= t_cut:
            return None
        return int(rng.integers(20)), None, 64

    def apply_count(tup, state):
        return ((state or 0) + 1, [])

    kw = dict(policy="tac", mode="async", cache_capacity=8 * 64,
              state_size=64, io_workers=2)
    if fused:
        kw.update(fused=count_spec(), fused_batch=8, device=device)
    src = eng.add(SourceOp(eng, "src", 1, 4000.0, gen, replayable=True))
    op = eng.add(StatefulOp(eng, "agg", 1, apply_count, LOCAL_NVME, **kw))
    eng.connect(src, op)
    coord = CheckpointCoordinator(eng, interval=0.2)
    coord.start()
    if events:
        def fire_failure():
            if coord.in_recovery:
                eng.sim.after(0.05, fire_failure)
                return
            coord.fail(mode="warmed", down_time=0.05, replay_speedup=4.0)

        eng.sim.at(0.45, fire_failure)
        eng.sim.at(0.60, setattr, src, "rate_scale", 2.5)
        eng.sim.at(0.80, setattr, src, "rate_scale", 1.0)
    src.start()
    eng.sim.after(eng.marker_interval, eng._inject_marker)
    t = 0.0
    while True:
        t += 0.25
        eng.sim.run_until(t)
        log_end = src.log_base[0] + len(src.log[0])
        if (src.logical_t[0] >= t_cut and src.replay_pos[0] >= log_end
                and not coord.in_recovery):
            break
        if t >= 30.0:
            raise AssertionError("chaos count run failed to quiesce")
    eng.sim.run_until(t + 0.5)               # drain in-flight I/O
    src.stopped = True
    for e in op.caches[0].flush_dirty():
        op.backends[0].write(e.key, e.state, 64)
    state = {k: v for k, v in op.backends[0].data.items() if v is not None}
    return state, coord.failures


def recovery_phase():
    """Checkpoints, a crash and a restore of the fused device plane at
    BENCH_recovery.json's q5 configuration: ``unfailed``, ``cold`` and
    ``warmed`` on the card, ``warmed`` also on the CPU (equal results);
    a warmed run with two failures whose card memory must stay within one
    plane of the unfailed run's; no tensor in any snapshot record; then
    the exactly-once count per key on the card against the golden run.
    Every card run must launch both fused kernels."""
    total = {k: 0 for k in launches()}
    card = {}
    for scenario in ("unfailed", "cold", "warmed"):
        (res, info), counts = counted(total, f"recovery {scenario}",
                                      recovery_run, scenario, "cuda")
        card[scenario] = (res, info)
        line = dict(scenario=scenario, **res, **info, launches=counts)
        if scenario == "warmed":
            cpu, cpu_info = on_cpu_threads(recovery_run, scenario, "cpu")
            if cpu != res:
                raise AssertionError(f"recovery warmed: cuda run {res} != "
                                     f"cpu run {cpu}")
            line.update(equal=True, cpu_wall_s=cpu_info["wall_s"])
        emit("recovery", **line)
    if card["unfailed"][0]["failures"] != 0 or \
            min(card[s][0]["failures"] for s in ("cold", "warmed")) < 1:
        raise AssertionError("recovery: the failures did not fire as set")
    if card["cold"][0]["warmup_hints"] != 0 or \
            card["warmed"][0]["warmup_hints"] == 0:
        raise AssertionError("recovery: cold must issue no warm-up hints "
                             "and warmed some")
    (res, info), counts = counted(total, "recovery, two failures",
                                  recovery_run, "warmed", "cuda", failures=2)
    base = card["unfailed"][1]["mem_bytes"]
    grown = info["mem_bytes"] - base
    if res["failures"] != 2 or grown > info["plane_bytes"]:
        raise AssertionError(f"recovery: {res['failures']} failures, card "
                             f"memory {grown} bytes above the unfailed run "
                             f"(one plane: {info['plane_bytes']})")
    emit("recovery_memory", failures=res["failures"],
         mem_bytes=info["mem_bytes"], unfailed_mem_bytes=base,
         grown_bytes=grown, plane_bytes=info["plane_bytes"],
         wall_s=info["wall_s"], launches=counts)
    (fused, fails), counts = counted(total, "exactly-once", chaos_count,
                                     fused=True, device="cuda")
    golden, _ = chaos_count(fused=False, events=False)
    if fails < 1 or not golden or fused != golden:
        raise AssertionError(f"exactly-once: {fails} failures, the card's "
                             f"state differs from the golden run's")
    emit("exactly_once", failures=fails, keys=len(golden),
         count=sum(golden.values()), equal=True, launches=counts)
    return total


# ------------------------------------------------------- deployment size
def resident_plane(slots: int, batch: int = E2E["batch"]):
    """A q5-like counting plane with ``slots`` keys resident and batches
    of ``batch`` lanes, and the time it took to fill."""
    spec = count_spec()
    t0 = time.perf_counter()
    plane = FusedPlane(slots * 96, 96, spec, batch=batch, device="cuda")
    for k in range(slots):
        plane.insert(k, 1, 0.0)
    plane._sync()
    torch.cuda.synchronize()
    return plane, spec, time.perf_counter() - t0


def lanes_for(spec, picks):
    return [[Lane(int(k), 1.0, spec.weight(None), False, False, None)
             for k in row] for row in picks]


# the plane's batch widths timed alone: the e2e runs' and past the step
# kernel's old 256-lane cap
PLANE_BATCHES = (E2E["batch"], 1024, 4096)


def plane_phase(slots: int, B: int = E2E["batch"], n_batches: int = 200):
    torch.cuda.reset_peak_memory_stats()
    plane, spec, fill_s = resident_plane(slots, B)
    picks = np.random.default_rng(3).integers(0, slots,
                                              size=(n_batches + 1, B))
    batches = lanes_for(spec, picks)
    plane.batch_step(batches[0])
    torch.cuda.synchronize()
    # the host's garbage collections inside the timed loop (through
    # gc.callbacks), so a collection is not taken for the plane's own cost
    in_gc = {"s": 0.0, "n": 0, "t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            in_gc["t0"] = time.perf_counter()
        else:
            in_gc["s"] += time.perf_counter() - in_gc["t0"]
            in_gc["n"] += 1

    gc.callbacks.append(on_gc)
    n0 = tfk.STEP_LAUNCHES
    t0 = time.perf_counter()
    for lanes in batches[1:]:
        res = plane.batch_step(lanes)
    wall = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    steps = tfk.STEP_LAUNCHES - n0
    if steps != n_batches:
        raise AssertionError(f"plane at batch {B}: {steps} tac_fused_step "
                             f"launches for {n_batches} batches")
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
         step_launches=steps, tuples_per_s=n_batches * B / wall, batch_ms=wall / n_batches * 1e3,
         gc_ms_per_batch=in_gc["s"] / n_batches * 1e3,
         gc_collections=in_gc["n"], host_objects=len(gc.get_objects()),
         fill_s=fill_s, mem_allocated_bytes=torch.cuda.memory_allocated(),
         mem_peak_bytes=torch.cuda.max_memory_allocated())


def device_activity(prof):
    """The device side of a ``torch.profiler`` trace: busy ms as the union
    of the device events' intervals (summing ``self_device_time_total``
    over ``key_averages()`` counts each kernel twice, under its own name
    and under the aten op that launched it), its events by name
    ([name, count, ms], heaviest first), and how many times CUPTI found
    the launch queue full (its "Command Buffer Full" marker, not device
    work)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    full = sum(e.name == "Command Buffer Full" for e in events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name != "Command Buffer Full")
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        if e.name != "Command Buffer Full":
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.end
                               - e.time_range.start)
    ops = sorted(([k, n, us / 1e3] for k, (n, us) in by_name.items()),
                 key=lambda r: -r[2])
    return busy_us / 1e3, ops, full


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
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for lanes in batches[1:n_batches + 1]:
            plane.batch_step(lanes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    device_ms, dev, _ = device_activity(prof)
    per = lambda us: us / 1e3 / n_batches
    host = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)
    # the CUDA runtime calls a batch makes (cudaLaunchKernel,
    # cudaMemcpyAsync, ...), and the port's kernels among the launches
    runtime = {a.key: a.count / n_batches for a in avgs
               if a.key.startswith("cuda")}
    emit("profile_torch", slots=slots, batches=n_batches,
         batch_ms=wall_ms / n_batches, device_ms_per_batch=device_ms
         / n_batches, device_busy_share=device_ms / wall_ms,
         runtime_calls_per_batch=runtime,
         kernel_launches_per_batch={k: n / n_batches
                                    for k, n in launches().items() if n},
         host_ops=[[a.key[:60], a.count / n_batches,
                    per(a.self_cpu_time_total)] for a in host[:top]],
         device_ops=[[name[:60], n / n_batches, ms / n_batches]
                     for name, n, ms in dev[:top]])
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


# ------------------------------------------------------------------ serving
def serve_page_keys(sid: int, n: int) -> np.ndarray:
    return np.asarray([sid * PAGE_KEY_STRIDE + p + 1 for p in range(n)],
                      np.int32)


def serve_seeds(c):
    """Every session's K and V pages ([sessions, KV heads * pages, page,
    d] each), made once from the seed; both runs of a mode seed their
    stores with the same read-only arrays."""
    n_keys = c["kv_heads"] * (c["context"] // c["page"] + 1)
    shape = (c["sessions"], n_keys, c["page"], c["head_dim"])
    rng = np.random.default_rng(c["seed"])
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def serve_run(c, mode: str, device: str, seeds):
    """The loop of examples/serve_stream.py with a real decode step: per
    scheduled request, one page-table probe over its KV-head rows, the new
    token's K/V row appended to the last page (gather -> write -> stage),
    one paged attention launch over the pools, and ``complete_token`` with
    the appended pages dirty.  The SimClock advances a fixed ``decode_s``
    per token, so the stats depend on the data and not on the device.
    Returns (stats, attention outputs, store, wall s, attention ms per
    step on the card)."""
    KV, d, page = c["kv_heads"], c["head_dim"], c["page"]
    G = c["q_heads"] // KV
    P = c["context"] // page + 1
    n_keys = KV * P
    ways = c["ways"]
    arena = PagedStateArena(math.ceil(c["cache_sessions"] * n_keys / ways),
                            ways, {"k": ((page, d), torch.float32),
                                   "v": ((page, d), torch.float32)},
                            device=device)
    store = TieredStore(backing_model=BackendModel(
        "session-store", c["store_latency"], c["store_bandwidth"],
        parallelism=32), page_bytes=page * d * 4, workers=8)
    ks, vs = seeds
    for sid in range(c["sessions"]):
        for i, key in enumerate(serve_page_keys(sid, n_keys)):
            store.seed(int(key), {"k": ks[sid, i], "v": vs[sid, i]})
    clock = SimClock()
    sched = ContinuousBatchingScheduler(arena, store, mode=mode,
                                        max_batch=c["max_batch"], clock=clock,
                                        metrics=ServingMetrics())
    rng = np.random.RandomState(c["seed"])
    arrivals = np.cumsum(rng.exponential(1.0 / c["rate"], c["requests"]))
    sessions = rng.randint(0, c["sessions"], c["requests"])
    reqs = [Request(rid=i, session=int(sessions[i]),
                    page_keys=serve_page_keys(int(sessions[i]), n_keys),
                    n_tokens=c["decode_tokens"])
            for i in range(c["requests"])]
    length = dict.fromkeys(range(c["sessions"]), c["context"])
    draw = np.random.RandomState(c["seed"] + 1)   # q and new K/V rows
    on_card = torch.device(device).type == "cuda"
    outs, events = [], []
    t0 = time.perf_counter()
    i = rounds = 0
    while i < len(reqs) or sched.pending:
        rounds += 1
        if rounds > 100 * len(reqs):
            raise AssertionError(f"serve {mode}: no progress after {rounds} "
                                 f"scheduling rounds")
        while i < len(reqs) and arrivals[i] <= clock.now():
            sched.submit(reqs[i])
            i += 1
        batch = sched.schedule()
        if not batch:
            if sched.wait_for_progress():
                continue
            if i < len(reqs):
                clock.sleep(max(1e-6, arrivals[i] - clock.now()))
                continue
            break
        for req in batch:
            keys = req.page_keys.reshape(KV, P)
            hit, table = arena.page_table(keys)
            if not hit.all():
                # evicted between scheduling and execution (sync staging
                # for a later batch member); retried next round
                req.state = "queued"
                continue
            pos = length[req.session]
            if pos >= P * page:
                raise AssertionError("a session outgrew its pages")
            last_page, off = divmod(pos, page)
            q, k_new, v_new = (torch.from_numpy(
                draw.standard_normal(shape).astype(np.float32)).to(device)
                for shape in ((KV, G, d), (KV, d), (KV, d)))
            last = table[:, last_page]
            blocks = arena.gather(last)
            blocks["k"][:, off] = k_new
            blocks["v"][:, off] = v_new
            arena.stage(last, blocks)
            lens = torch.full((KV,), pos + 1, dtype=torch.int32,
                              device=device)
            if on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = paged_decode_attention(q, arena.pools["k"],
                                         arena.pools["v"], table, lens)
            if on_card:
                ev[1].record()
                events.append(ev)
            outs.append(out.cpu())
            length[req.session] = pos + 1
            clock.advance(c["decode_s"])
            sched.complete_token(req, dirty_keys=keys[:, last_page])
    sched.drain_dirty()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (sched.stats(), outs, store, wall,
            [a.elapsed_time(b) for a, b in events])


def store_pages(store: TieredStore, seeds) -> dict:
    """Each tier's pages, {tier: {key: {pool: array}}}, a page still the
    seeds' own (seeded, never written) as its place in them, (pool,
    flat index), so that a store crosses processes without the seeds."""
    out = {}
    for tier in ("host", "backing"):
        pages = {}
        for key, blocks in getattr(store, tier).data.items():
            pages[key] = {}
            for pool, x in blocks.items():
                seed = seeds[0 if pool == "k" else 1]
                if isinstance(x, np.ndarray) and x.base is seed:
                    x = (pool, (x.__array_interface__["data"][0]
                                - seed.__array_interface__["data"][0])
                         // x.nbytes)
                elif isinstance(x, torch.Tensor):   # the page alone, not
                    x = x.numpy().copy()            # the pool it views
                pages[key][pool] = x
        out[tier] = pages
    return out


def same_store(a: TieredStore, b: dict, seeds, tol: float) -> bool:
    """Store ``a`` and the pages ``b`` of another (``store_pages``) hold the
    same keys in each tier and, page by page, the same contents within
    ``tol``."""
    flat = [s.reshape(-1, *s.shape[2:]) for s in seeds]
    for tier in ("host", "backing"):
        da_, db_ = getattr(a, tier).data, b[tier]
        if set(da_) != set(db_):
            return False
        for key, blocks in da_.items():
            for pool, x in blocks.items():
                y = db_[key][pool]
                if isinstance(y, tuple):
                    y = flat[0 if y[0] == "k" else 1][y[1]]
                if not np.allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol):
                    return False
    return True


def serve_cpu(mode: str):
    """``serve_run`` of ``mode`` on the CPU at SERVE, for a ``CpuSide``:
    (stats, attention outputs, ``store_pages``, wall s)."""
    seeds = serve_seeds(SERVE)
    stats, outs, store, wall, _ = serve_run(SERVE, mode, "cpu", seeds)
    return stats, outs, store_pages(store, seeds), wall


def serve_cpu_sides() -> dict:
    """The CPU sides of ``serve_phase``, started now (together about half a
    minute of the CPU: main starts them before the kernel checks)."""
    return {mode: CpuSide("serve_cpu", mode) for mode in ("sync", "prefetch")}


def serve_phase(sides=None):
    c = SERVE
    seeds = serve_seeds(c)
    sides = sides or serve_cpu_sides()
    total = {k: 0 for k in launches()}
    for mode in ("sync", "prefetch"):
        reset_launches()
        gpu = serve_run(c, mode, "cuda", seeds)
        counts = launches()
        cpu = sides[mode].result()[0]
        stats, outs = gpu[0], gpu[1]
        if stats != cpu[0]:
            raise AssertionError(f"serve {mode}: card stats {stats} != "
                                 f"cpu stats {cpu[0]}")
        if len(outs) != len(cpu[1]) or not all(
                allclose(a, b, 2e-5) for a, b in zip(outs, cpu[1])):
            raise AssertionError(f"serve {mode}: attention outputs differ")
        if not same_store(gpu[2], cpu[2], seeds, 2e-5):
            raise AssertionError(f"serve {mode}: store contents differ")
        if not stats["n_tokens"] or min(counts[k] for k in SERVE_KERNELS) == 0:
            raise AssertionError(f"serve {mode}: no tokens or a kernel never "
                                 f"launched: {counts}")
        for k in total:
            total[k] += counts[k]
        emit("serve", mode=mode, equal_stats=True, steps=len(outs),
             cuda_wall_s=gpu[3], cpu_wall_s=cpu[3],
             attn_ms_mean=statistics.fmean(gpu[4]),
             attn_ms_median=statistics.median(gpu[4]),
             max_abs_err=max(max_err(a, b) for a, b in zip(outs, cpu[1])),
             launches=counts,
             **{k: stats[k] for k in (
                 "n_tokens", "ttft_p50", "ttft_p99", "tpot_p50",
                 "arena_hit_rate", "arena_admits", "arena_evictions",
                 "arena_dirty_evictions", "store_writebacks",
                 "staging_overlap")})
    return total


def q5_bids(n: int):
    """The first ``n`` bids of the q5 stream (the e2e phase's generator
    settings): auction keys (int32), event times and prices (float32)."""
    cfg = NexmarkConfig(rate=E2E["rate"], active_window=1.0, oo_bound=0.3,
                        seed=7)
    gen = NexmarkGen(cfg)
    keys, ts, prices, i = [], [], [], 0
    while len(keys) < n:
        rec = gen(i / cfg.rate)
        i += 1
        if rec[1]["type"] == BID:
            keys.append(rec[1]["auction"])
            ts.append(rec[3])
            prices.append(rec[1]["price"])
    return (np.asarray(keys, np.int32), np.asarray(ts, np.float32),
            np.asarray(prices, np.float32))


def hints_phase(n_batches: int = 200, batch: int = 256):
    """The q5 bid stream's auction keys, in batches, through the port's
    ``HintFilter.classify_batch`` on two filters: ``device="cuda"``, whose
    sketch stays on the card and runs the kernel, and ``device="cpu"``,
    which runs its plain version.  Hot masks, counters and the aging
    count must be equal after every batch."""
    stream = q5_bids(n_batches * batch)[0].reshape(n_batches, batch)
    # the default sketch on both; both draw the same hash multipliers
    cpu_filt = HintFilter(mode="hot", device="cpu")
    card_filt = HintFilter(mode="hot", device="cuda")
    reset_launches()
    n_hot = 0
    cpu_s = cuda_s = 0.0
    for keys in stream:
        t0 = time.perf_counter()
        hot_cpu = cpu_filt.classify_batch(keys)
        cpu_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        hot = card_filt.classify_batch(keys)
        cuda_s += time.perf_counter() - t0
        if not (card_filt._dev["counters"].is_cuda
                and np.array_equal(hot, hot_cpu)
                and torch.equal(card_filt._dev["counters"].cpu(),
                                cpu_filt._dev["counters"])
                and card_filt._dev["since_aging"]
                == cpu_filt._dev["since_aging"]):
            raise AssertionError("hints: card and cpu sketches differ")
        n_hot += int(hot.sum())
    counts = launches()
    if counts["cms_sketch"] != n_batches:
        raise AssertionError(f"hints: {counts['cms_sketch']} sketch kernel "
                             f"launches for {n_batches} batches")
    emit("hints", batches=n_batches, batch=batch, equal=True,
         distinct_keys=int(len(np.unique(stream))),
         hot_share=n_hot / stream.size, cuda_s=cuda_s, cpu_s=cpu_s,
         launches=counts)
    return counts


# the tac_ops phase: the device TAC's calls of the sharded state plane
# (DESIGN.md §7, §9-§11) at the deployment size, DEPLOY_SLOTS slots in
# four logical shards of 8192 buckets x 8 ways, D = 1 (the width every
# directory of both packages is built with); the q5 bid stream's keys with
# their event times, the watermark trailing each batch's lowest event time
# by q5's out-of-order bound and q5's window (nexmark.py: 2 s) as the
# retention; a bin of shard 3's keys moves to shard 0 once
TAC_OPS = dict(shards=4, buckets=8192, ways=8, batches=200, batch=256,
               lateness=0.3, retention=2.0, admit_every=10, flush_every=20,
               bins=8)


def host_outputs(out) -> list:
    """A call's outputs as host arrays, in order; the state the call
    returns is left out (the directories are compared apart)."""
    if isinstance(out, tac_torch.TACState):
        return []
    if isinstance(out, tuple):
        return [a for o in out for a in host_outputs(o)]
    if isinstance(out, torch.Tensor):
        return [out.cpu().numpy()]
    return [np.asarray(out)]


def tac_ops_phase(c=TAC_OPS):
    """``lookup``, ``admit``, ``shard_of``, ``probe_owned``,
    ``admit_owned``, ``evict_expired``, ``set_dirty``, ``flush_dirty``,
    ``export_mask`` and ``import_entries`` on four shards on the card, and
    the same sequence on CPU tensors: after every call every output and
    all four directories must be bit-equal.  Returns the card's launch
    counts; K1 must have launched."""
    n, S = c["shards"], c["batches"]
    if n * c["buckets"] * c["ways"] != DEPLOY_SLOTS:
        raise AssertionError("tac_ops: the shards do not hold DEPLOY_SLOTS")
    keys, ts, vals = (a.reshape(S + 1, c["batch"], *a.shape[1:]) for a in
                      q5_bids((S + 1) * c["batch"]))
    vals = vals[..., None]
    sides = {dev: [tac_torch.init(c["buckets"], c["ways"], 1, device=dev)
                   for _ in range(n)] for dev in ("cuda", "cpu")}
    wall = {"cuda": 0.0, "cpu": 0.0}
    by_call = {}                 # call -> [count, card s, CPU s]
    tally = dict(calls=0, hits=0, lookup_hits=0, dropped=0, reclaimed=0,
                 flushed=0, migrated=0)

    def both(label, call):
        """``call(shards)`` on the card's shards and on the CPU's; returns
        the card's outputs as host arrays."""
        outs = {}
        row = by_call.setdefault(label, [0, 0.0, 0.0])
        row[0] += 1
        for i, dev in enumerate(("cuda", "cpu")):
            t0 = time.perf_counter()
            outs[dev] = call(sides[dev])
            if dev == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            wall[dev] += dt
            row[1 + i] += dt
        card, cpu = host_outputs(outs["cuda"]), host_outputs(outs["cpu"])
        if len(card) != len(cpu) or not all(
                a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b) for a, b in zip(card, cpu)):
            raise AssertionError(f"tac_ops {label}: card outputs {card} "
                                 f"!= cpu outputs {cpu}")
        for s in range(n):
            for f in tac_torch.TACState._fields:
                if not torch.equal(getattr(sides["cuda"][s], f).cpu(),
                                   getattr(sides["cpu"][s], f)):
                    raise AssertionError(f"tac_ops {label}: shard {s}'s "
                                         f"{f} differ")
        tally["calls"] += 1
        return card

    def run():
        exported = {}
        for i in range(S):
            k, t, v = keys[i], ts[i], vals[i]
            nk, nt, nv = keys[i + 1], ts[i + 1], vals[i + 1]
            for s in range(n):
                out = both("admit_owned", lambda sh: tac_torch.admit_owned(
                    sh[s], k, t, s, n, v))
                tally["dropped"] += int(out[-1])
            for s in range(n):
                hit = both("probe_owned", lambda sh: tac_torch.probe_owned(
                    sh[s], nk, s, n))[1]
                tally["hits"] += int(hit.sum())
                hit = both("lookup", lambda sh: tac_torch.lookup(
                    sh[s], nk, nt))[1]
                tally["lookup_hits"] += int(hit.sum())
            owner = both("shard_of", lambda sh: tac_torch.shard_of(
                torch.from_numpy(k).to(sh[0].keys.device), n))[0]
            if owner.tolist() != [hash_partition(int(x), n) for x in k]:
                raise AssertionError("tac_ops: shard_of != hash_partition")
            wm = float(t.min()) - c["lateness"]
            for s in range(n):
                tally["reclaimed"] += int(both(
                    "evict_expired", lambda sh: tac_torch.evict_expired(
                        sh[s], wm, c["retention"]))[0])
            if i % c["admit_every"] == c["admit_every"] - 1:
                s = (i // c["admit_every"]) % n
                own = np.mod(nk, n) == s
                both("admit", lambda sh: tac_torch.admit(
                    sh[s], nk[own], nt[own], nv[own]))
            if i % c["flush_every"] == c["flush_every"] - 1:
                for s in range(n):
                    both("set_dirty", lambda sh: tac_torch.set_dirty(
                        sh[s], k))
                    out = both("flush_dirty",
                               lambda sh: tac_torch.flush_dirty(sh[s]))
                    tally["flushed"] += len(out[0])
            if i == S // 2:
                resident = sides["cuda"][3].keys.cpu().numpy()
                mask = (resident // n) % c["bins"] == 0

                def drain(sh):
                    exported[sh[0].keys.device.type] = e = \
                        tac_torch.export_mask(sh[3], mask)
                    return e
                tally["migrated"] = len(both("export_mask", drain)[0])
                both("import_entries", lambda sh: tac_torch.import_entries(
                    sh[0], *exported[sh[0].keys.device.type][1:5]))

    reset_launches()
    on_cpu_threads(run)
    counts = launches()
    if counts["tac_probe"] == 0 or not (tally["hits"] and tally["reclaimed"]
                                        and tally["flushed"]
                                        and tally["migrated"]):
        raise AssertionError(f"tac_ops: K1 never launched or a call did "
                             f"nothing: {counts}, {tally}")
    emit("tac_ops", batches=S, batch=c["batch"], shards=n,
         slots=DEPLOY_SLOTS, equal=True, **tally, cuda_s=wall["cuda"],
         cpu_s=wall["cpu"], by_call=by_call, launches=counts)
    return counts


# ------------------------------------------------------------ LM models
# the models phase: each model at its published width and depth
# (configs/zamba2_2_7b.py, rwkv6_3b.py, qwen3_moe_30b_a3b.py,
# llava_next_mistral_7b.py, seamless_m4t_large_v2.py; deepseek_v2_236b.py
# cut to its dense prefix and six MoE layers, 50.4 GB of its 471 in bf16),
# bf16 weights drawn from a seeded generator on the card; 4 requests of
# 2048 prompt tokens (llava: after 2880 stub image tokens of width 1024;
# seamless: from an encoder bank of 1536 frames), one prefill and 16
# greedy decode steps; the prefill/decode consistency of
# tests/test_models.py at 128 tokens (prefill of 127, decode of the 128th:
# a length both chunkings take; the MoE models without capacity drops, as
# tests/test_models.py's _no_drop_cfg (no_drop), their fp32 runs with the
# expert products in fp32 (fp32_experts) and at fp32_layers, since
# qwen3-moe in fp32 is 122 GB); the card against the
# port's CPU run at full width and cut depth (zamba2: one shared block and
# six Mamba2 layers; rwkv6, qwen3-moe, llava, seamless: two layers, two
# encoder layers too; deepseek-v2: its dense prefix and one MoE layer) on
# one request of 256 tokens (zamba2, a multiple of its chunk, as
# ssd_chunked requires), 200 (rwkv6, which the reference steps one token
# at a time and the port runs through K8) or 128 (the new models; llava
# after 256 image tokens, seamless from 96 frames).  Both
# checks are required within fp32_limit in fp32, as tests/test_models.py
# runs its consistency check (the readings are 1e-5 or less).  In bf16
# these random-weight models amplify rounding from layer to layer (the
# CPU's own bf16 logits sit 0.017-0.068 from its fp32 ones), so bf16 is
# held layer by layer: each layer that runs a kernel, and each MoE layer
# (WITNESS), run again on the CPU from the card's own inputs to it, agrees
# within the bf16 tolerance; and the card's bf16 logits are no farther from the CPU's fp32
# ones than bf16_vs_fp32 times the CPU's own bf16 logits are
LM = dict(archs=("zamba2-2.7b", "rwkv6-3b", "qwen3-moe-30b-a3b",
                 "deepseek-v2-236b", "llava-next-mistral-7b",
                 "seamless-m4t-large-v2"),
          requests=4, prompt=2048, decode=16, consistency=128,
          layers={"deepseek-v2-236b": 7},
          fp32_layers={"qwen3-moe-30b-a3b": 4, "deepseek-v2-236b": 2},
          cut={"zamba2-2.7b": 6, "rwkv6-3b": 2, "qwen3-moe-30b-a3b": 2,
               "deepseek-v2-236b": 2, "llava-next-mistral-7b": 2,
               "seamless-m4t-large-v2": 2},
          cut_tokens={"zamba2-2.7b": 256, "rwkv6-3b": 200,
                      "qwen3-moe-30b-a3b": 128, "deepseek-v2-236b": 128,
                      "llava-next-mistral-7b": 128,
                      "seamless-m4t-large-v2": 128},
          frames=1536, consistency_frames=96, cut_frames=96,
          cut_image_tokens=256, seed=0, fp32_limit=1e-3, bf16_vs_fp32=1.25)
# the layers that run K6-K8, as the model modules look them up
WITNESS = {"zamba2-2.7b": ((lm_mod, "attention"),
                           (ssm_mod, "mamba2_block_with_state")),
           "rwkv6-3b": ((ssm_mod, "rwkv6_time_mix"),),
           "qwen3-moe-30b-a3b": ((lm_mod, "attention"),
                                 (lm_mod, "moe_ffn")),
           "deepseek-v2-236b": ((lm_mod, "mla_attention"),
                                (lm_mod, "moe_ffn")),
           "llava-next-mistral-7b": ((lm_mod, "attention"),),
           "seamless-m4t-large-v2": ((lm_mod, "attention"),)}
LM_KERNELS = {"gemma-7b": ("flash_attention",),
              "zamba2-2.7b": ("flash_attention", "mamba2_scan"),
              "rwkv6-3b": ("rwkv6_scan",),
              "qwen3-moe-30b-a3b": ("flash_attention",),
              "deepseek-v2-236b": ("flash_attention",),
              "llava-next-mistral-7b": ("flash_attention",),
              "seamless-m4t-large-v2": ("flash_attention",)}
# the serve_lm phase: tests/test_system.py's serving config through the
# port's run_serving (smoke models, as the reference runs them); zamba2
# and rwkv6 take 32-token prompts, since at 16 the reference's _grow_kv
# pads their 16-wide state axes as if they were time (ROADMAP.md §3);
# deepseek-v2's pages hold MLA's latent cache and its dense prefix's
ZAMBA2_STATE_PAGES = 3         # serve_lm's zamba2-2.7b pages a session
SERVE_LM = dict(n_sessions=12, n_requests=24, decode_tokens=2,
                store_latency=0.03, cache_sessions=6, arrival_rate=500.0,
                prompts={"gemma-7b": 16, "zamba2-2.7b": 32, "rwkv6-3b": 32,
                         "deepseek-v2-236b": 32})


def rel_err(a, b) -> float:
    """max |a - b| over max |b|: tests/test_models.py's metric."""
    return max_err(a, b) / (float(b.float().abs().max()) + 1e-9)


def cut_cfg(arch: str, layers: int, dtype: str):
    """``lm_model``'s config for ``arch`` at ``layers``, without weights."""
    cfg = get_config(arch).replace(dtype=dtype, num_layers=layers)
    if cfg.encoder_decoder:
        cfg = cfg.replace(num_encoder_layers=layers)
    return cfg


def lm_model(arch: str, layers=None, dtype="bfloat16"):
    """The arch's model on the card at full width, ``layers`` deep (an
    encoder-decoder's encoder cut alike) or at its LM["layers"] depth."""
    layers = layers or LM["layers"].get(arch)
    cfg = cut_cfg(arch, layers, dtype) if layers \
        else get_config(arch).replace(dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(LM["seed"])
    return cfg, build_model(cfg, "cuda").init_params(gen)


def no_drop(cfg):
    """tests/test_models.py's _no_drop_cfg: no MoE capacity drops, so a
    prefill of S - 1 tokens and one of S route alike.  Its factor of 16
    drops nothing only where E / K <= 16; deepseek-v2 (160 experts, 6 a
    token) takes E / K, so an expert can hold every token of a row."""
    if not cfg.moe:
        return cfg
    mo = cfg.moe
    return cfg.replace(moe=dataclasses.replace(mo, capacity_factor=max(
        16.0, mo.num_experts / mo.num_experts_per_tok)))


def fp32_expert_product(a, w):
    """``layers._expert_product`` without its rounding to bf16."""
    B, E, C, X = a.shape
    y = torch.bmm(a.transpose(0, 1).reshape(E, B * C, X).float(), w.float())
    return y.reshape(E, B, C, -1).transpose(0, 1).to(a.dtype)


@contextlib.contextmanager
def fp32_experts(cfg):
    """An fp32 MoE model's expert products kept in fp32.  The reference
    rounds each expert product to bf16 whatever the model's type
    (``preferred_element_type=bfloat16``), so the same token in two
    batches of other shapes (a prefill, a decode; the card, the CPU) can
    land one bf16 step apart, which random-weight layers amplify to
    ~1e-3 of the logits on the CPU alone: the fp32 checks, which hold the
    cache paths and the kernels, take the products in fp32 on both sides,
    and so do not hold ``_expert_product`` itself; the bf16 checks run the
    function as it is, and WITNESS holds each MoE layer's card output
    (its bf16 products on the card) against a CPU rerun."""
    if not (cfg.moe and cfg.dtype == "float32"):
        yield
        return
    saved = layers_mod._expert_product
    layers_mod._expert_product = fp32_expert_product
    try:
        yield
    finally:
        layers_mod._expert_product = saved


def tokens(cfg, B: int, S: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)


def lm_batch(cfg, B: int, S: int, seed: int, n_img=None, frames=None):
    """A prefill batch of B requests of S tokens: with n_img stub image
    tokens for a vision model (its configured count by default), with an
    encoder bank of ``frames`` frames for an encoder-decoder; and the
    number of image tokens before the text, which decode positions
    count."""
    batch = {"tokens": tokens(cfg, B, S, seed)}
    g = torch.Generator().manual_seed(seed + 100)
    fe = cfg.frontend
    n = 0
    if fe and fe.kind == "vision":
        n = fe.num_tokens if n_img is None else n_img
        batch["frontend_embeds"] = torch.randn((B, n, fe.embed_dim),
                                               generator=g)
    if cfg.encoder_decoder:
        batch["frames"] = torch.randn((B, frames, fe.embed_dim), generator=g)
    return batch, n


def params_on_cpu(module):
    """The model's parameter tree (names, lists) as CPU tensors."""
    if isinstance(module, torch.nn.ModuleList):
        return [params_on_cpu(m) for m in module]
    tree = {k: v.detach().cpu() for k, v in module._parameters.items()}
    tree.update({k: params_on_cpu(m) for k, m in module._modules.items()})
    return tree


def kernel_names(path) -> set:
    """The ``__global__`` functions of one CUDA source or header."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")
    return set(pat.findall(Path(path).read_text()))


def port_kernel_names() -> set:
    """The ``__global__`` functions of the port's CUDA sources and shared
    headers."""
    return {name for src in (*cuda_build.CSRC.glob("*.cu"),
                             *cuda_build.CSRC.glob("*.cuh"))
            for name in kernel_names(src)}


def bwd_kernel_ms(prof) -> dict:
    """A ``profile_step``'s device time in each kernel of the backward
    sources (K6's, K7's, K8's), by name with its template arguments:
    [launches, ms].  K7's kernel (a) is the shared chunk-state kernel's
    gradient instance, ``ssd_state_kernel<true>``."""
    mine = set().union(*(kernel_names(cuda_build.CSRC / f"{src}.cu")
                         for src in ("flash_attention_bwd", "mamba2_scan_bwd",
                                     "rwkv6_scan_bwd")))
    pat = re.compile(r"::(\w+(?:<[^>(]*>)?)\(")
    out = {}
    for name, n, ms_, _ in prof["port_kernels"]:
        m = pat.search(name)
        if m and (m.group(1).split("<")[0] in mine
                  or m.group(1) == "ssd_state_kernel<true>"):
            c, t = out.get(m.group(1), (0, 0.0))
            out[m.group(1)] = [c + n, t + ms_]
    return out


def profile_step(fn, top: int = 10):
    """Device time of one call by kernel, from ``torch.profiler``: the
    call's wall ms, the device's busy ms, the heaviest kernels, and the
    port's own kernels (``csrc/``) with their share of the busy time,
    heavy or not."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, ops, full = device_activity(prof)
    ours = tuple(f"(anonymous namespace)::{k}{c}" for k in port_kernel_names()
                 for c in "<(")
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_busy_share=busy / wall_ms, launch_queue_full=full,
                device_ops=[[name[:70], n, ms] for name, n, ms in ops[:top]],
                port_kernels=[[name[:70], n, ms, ms / busy]
                              for name, n, ms in ops
                              if any(k in name for k in ours)])


def consistency(model, cfg, S: int):
    """decode(prefill(x[:-1]), x[-1]) against prefill(x), rel, without
    MoE capacity drops (the same image tokens or frames on both sides)."""
    batch, n_img = lm_batch(cfg, LM["requests"], S, seed=2,
                            frames=LM["consistency_frames"])
    cfg_was = model.cfg
    model.cfg = no_drop(cfg_was)
    try:
        with fp32_experts(cfg_was):
            lg_full, _ = model.prefill(batch)
            _, cache = model.prefill(dict(batch,
                                          tokens=batch["tokens"][:, :-1]))
            t_old = S - 1 + n_img
            cache = _grow_kv(cache, t_old, t_old + 1)
            lg_dec, _ = model.decode(cache, {
                "tokens": batch["tokens"][:, -1:], "pos": t_old})
    finally:
        model.cfg = cfg_was
    if not bool(torch.isfinite(lg_dec).all()):
        raise AssertionError(f"{cfg.name}: decode logits not finite")
    return rel_err(lg_dec, lg_full)


def serve_full(model, cfg):
    """4 requests of 2048 tokens (after the image tokens, or from the
    encoder bank): one prefill, then 16 greedy decode steps.  Returns the
    metrics, the cache, the last token and its position, and the prefill
    batch."""
    c = LM
    batch, n_img = lm_batch(cfg, c["requests"], c["prompt"], seed=1,
                            frames=c["frames"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    t = n_img + c["prompt"]
    cache = _grow_kv(cache, t, t + c["decode"])
    tok = logits.argmax(-1, keepdim=True).int()
    t0 = time.perf_counter()
    for i in range(c["decode"]):
        logits, cache = model.decode(cache, {"tokens": tok, "pos": t + i})
        finite = finite and bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1, keepdim=True).int()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not finite:
        raise AssertionError(f"{cfg.name}: logits not finite")
    n_prompt = c["requests"] * c["prompt"]
    return dict(prefill_ms=prefill_s * 1e3,
                prefill_tokens_per_s=n_prompt / prefill_s,
                image_tokens=n_img,
                decode_ms_per_token=decode_s / c["decode"] * 1e3,
                decode_tokens_per_s=c["requests"] * c["decode"] / decode_s,
                mem_peak_bytes=torch.cuda.max_memory_allocated()), \
        cache, tok, t + c["decode"] - 1, batch


def on_cpu(x):
    """Tensors, parameter trees and containers of them, on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, torch.nn.Module):
        return params_on_cpu(x)
    if isinstance(x, (list, tuple)):
        return type(x)(on_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: on_cpu(v) for k, v in x.items()}
    return x


def recorded_prefill(model, batch, layers):
    """One prefill of ``batch`` (a dict, or a tensor of tokens) with every
    call of ``layers`` ([(module, function name)]) recorded as (function,
    arguments, outputs), on the CPU."""
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    calls = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in layers]

    def recorder(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((fn, on_cpu(args), on_cpu(kw), on_cpu(out)))
            return out
        return call

    for mod, name, fn in saved:
        setattr(mod, name, recorder(fn))
    try:
        logits, cache = model.prefill(batch)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return logits, cache, calls


def layer_rels(calls):
    """Each recorded call run again on the CPU (the plain versions) from
    the card's own inputs: the worst rel of its outputs against the
    card's, call by call."""
    rels = []
    for fn, args, kw, out in calls:
        cpu = fn(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        cpus = cpu if isinstance(cpu, tuple) else (cpu,)
        rels.append(max(rel_err(a, b) for a, b in zip(outs, cpus)))
    return rels


def card_vs_cpu(arch: str, repeat: bool = False):
    """Full width, cut depth: the card's prefill (kernels) against the
    port's CPU prefill (plain versions) on the same weights, in fp32 and in
    bf16 (the fp32 weights rounded): rel of the logits and of the worst
    cache leaf.  In bf16 also each layer of WITNESS run again on the CPU
    from the card's inputs to it, and the card's and the CPU's bf16 logits
    against the CPU's fp32 ones (how far bf16 rounding alone moves the
    model).  The fp32 CPU prefill, which the 1e-3 gate reads, runs on one
    thread (``on_cpu_threads``): its sums' order is then the code's alone,
    not how many threads the CPU's libraries take or how they split a
    product, which other processes' load or a first call in the process
    can change.  With ``repeat`` it runs twice and the row gives the two
    runs' distance (``cpu_repeat_rel``, 0 when they are bit-equal)."""
    res, fp32_logits = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg, model = lm_model(arch, LM["cut"][arch], dtype)
        batch, _ = lm_batch(cfg, 1, LM["cut_tokens"][arch], seed=3,
                            n_img=LM["cut_image_tokens"],
                            frames=LM["cut_frames"])
        layers = WITNESS[arch] if dtype == "bfloat16" else ()
        with fp32_experts(cfg):
            lg, cache, calls = recorded_prefill(model, batch, layers)
            cpu_model = build_model(cfg, "cpu").load_params(
                params_on_cpu(model))
            del model
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            if dtype == "float32":
                c_lg, c_cache = on_cpu_threads(cpu_model.prefill, batch)
            else:
                c_lg, c_cache = cpu_model.prefill(batch)
            cpu_s = time.perf_counter() - t0
            if repeat and dtype == "float32":
                again = on_cpu_threads(cpu_model.prefill, batch)
                cpu_repeat = max(rel_err(a, b) for a, b in zip(
                    tree_flatten((c_lg, c_cache))[0],
                    tree_flatten(again)[0]) if a.is_floating_point())
                del again
        rels = {"logits": rel_err(lg.cpu(), c_lg)}
        leaves, _ = tree_flatten(cache)
        c_leaves, _ = tree_flatten(c_cache)
        for i, (a, b) in enumerate(zip(leaves, c_leaves)):
            if a.is_floating_point():
                rels[f"cache_leaf_{i}"] = rel_err(a.cpu(), b)
            elif int(a) != int(b):
                raise AssertionError(f"{arch}: cache leaf {i} differs")
        res[dtype] = dict(cpu_prefill_s=cpu_s, rel_logits=rels["logits"],
                          rel_worst_leaf=max(rels.values()))
        if repeat and dtype == "float32":
            res[dtype].update(cpu_repeat_rel=cpu_repeat,
                              cpu_threads=1)
        if dtype == "float32":
            fp32_logits = c_lg
        else:
            by_layer = layer_rels(calls)
            res[dtype].update(
                layer_rels=by_layer, rel_worst_layer=max(by_layer),
                card_vs_cpu_fp32_logits=rel_err(lg.cpu(), fp32_logits),
                cpu_vs_cpu_fp32_logits=rel_err(c_lg, fp32_logits))
    return res


def models_phase():
    total = {k: 0 for k in launches()}
    mem_kb = int(re.search(r"MemTotal:\s+(\d+)",
                           Path("/proc/meminfo").read_text()).group(1))
    # card_vs_cpu holds the fp32 cut model on the host: at most a third
    # of its memory, so that the CPU run's activations fit beside it
    cut_bytes = {a: 4 * count_params(cut_cfg(a, LM["cut"][a], "float32"))
                 for a in LM["archs"]}
    emit("host", mem_total_kb=mem_kb, cpus=os.cpu_count(),
         cut_fp32_bytes=cut_bytes)
    if max(cut_bytes.values()) > mem_kb * 1024 / 3:
        raise AssertionError(f"models: a cut model does not fit the host's "
                             f"{mem_kb} kB: {cut_bytes}")
    for arch in LM["archs"]:
        cfg, model = lm_model(arch)
        n_params = sum(p.numel() for p in model.parameters())
        reset_launches()
        stats, cache, tok, last_pos, batch = serve_full(model, cfg)
        counts = launches()
        need = LM_KERNELS[arch]
        if min(counts[k] for k in need) == 0:
            raise AssertionError(f"{arch}: a kernel never launched: {counts}")
        for k in total:
            total[k] += counts[k]
        rel_bf16 = consistency(model, cfg, LM["consistency"])
        prof_prefill = profile_step(lambda: model.prefill(batch))
        prof_decode = profile_step(lambda: model.decode(
            cache, {"tokens": tok, "pos": last_pos}))
        del model, cache, batch
        torch.cuda.empty_cache()
        fp32_layers = LM["fp32_layers"].get(arch)
        _, model = lm_model(arch, fp32_layers, dtype="float32")
        rel = consistency(model, model.cfg, LM["consistency"])
        del model
        torch.cuda.empty_cache()
        # the phase's first CPU fp32 prefill, repeated
        cut = card_vs_cpu(arch, repeat=arch == LM["archs"][0])
        bf = cut["bfloat16"]
        if not (rel < LM["fp32_limit"]
                and cut["float32"]["rel_worst_leaf"] < LM["fp32_limit"]
                and bf["rel_worst_layer"] < TOL[torch.bfloat16]
                and bf["card_vs_cpu_fp32_logits"]
                <= LM["bf16_vs_fp32"] * bf["cpu_vs_cpu_fp32_logits"]):
            raise AssertionError(f"{arch}: fp32 prefill/decode rel {rel}, "
                                 f"card vs cpu {cut}")
        emit("models", arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
             params=n_params, requests=LM["requests"], prompt=LM["prompt"],
             decode_steps=LM["decode"], launches=counts,
             consistency_tokens=LM["consistency"],
             consistency_rel_fp32=rel, consistency_rel_bf16=rel_bf16,
             consistency_fp32_layers=fp32_layers or cfg.num_layers,
             cut_layers=LM["cut"][arch], cut_tokens=LM["cut_tokens"][arch],
             card_vs_cpu_fp32=cut["float32"],
             card_vs_cpu_bf16=cut["bfloat16"], **stats)
        emit("models_profile", arch=arch, prefill=prof_prefill,
             decode_step=prof_decode)
        torch.cuda.empty_cache()
    return total


def graphed_step_check(arch: str, prompt: int) -> dict:
    """run_serving's step on the card (``GraphedStep``: one CUDA graph a
    decode position) against the eager step on the same perturbed pages of
    a seeded session: logits, pages and aux must be bit-equal.  Returns the
    row with both steps' ms (host clock, the mean of 20 after a sync)."""
    scfg = get_smoke_config(arch)
    model = build_model(scfg, "cuda").init_params(
        torch.Generator(device="cuda").manual_seed(LM["seed"]))
    rng = np.random.RandomState(LM["seed"])
    tokens = rng.randint(0, scfg.vocab_size, (1, prompt)).astype(np.int32)
    _, kv = model.prefill({"tokens": torch.from_numpy(tokens)})
    kv = _grow_kv(kv, prompt, prompt + SERVE_LM["decode_tokens"] + 8)
    pager = StatePager(kv, ServeConfig.page_elems)
    pages, aux = pager.to_pages(kv)
    step = decode_step(model, pager)
    one = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    positions = range(prompt, prompt + SERVE_LM["decode_tokens"])
    graphed = GraphedStep(step, pages, aux, one, positions)
    gen = torch.Generator(device="cuda").manual_seed(LM["seed"])
    row = dict(arch=arch, positions=list(positions), equal=True)
    for p in positions:
        pos = torch.tensor(p, dtype=torch.int32)
        moved = pages + 0.01 * torch.randn(pages.shape, device="cuda",
                                           generator=gen)
        want, got = step(moved, aux, one, pos), graphed(moved, aux, one, pos)
        row["equal"] &= bool(
            torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
            and [int(a) for a in want[2]] == [int(a) for a in got[2]])
        for name, fn in (("eager_ms", step), ("graph_ms", graphed)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn(moved, aux, one, pos)
            torch.cuda.synchronize()
            row.setdefault(name, []).append(
                (time.perf_counter() - t0) / 20 * 1e3)
    if not row["equal"]:
        raise AssertionError(f"serve_lm {arch}: the graphed step differs "
                             f"from the eager step: {row}")
    return row


def serve_lm_phase():
    """run_serving on the card in sync and prefetch mode for each arch of
    SERVE_LM.  Its decode step is a CUDA graph a position: the kernels
    count where the warm-up and the capture launch them and in the
    sessions' prefills; a replay goes through no wrapper and adds none."""
    total = {k: 0 for k in launches()}
    c = SERVE_LM
    for arch, prompt in c["prompts"].items():
        emit("serve_lm_graph", **graphed_step_check(arch, prompt))
        cfg = ServeConfig(arch=arch, n_sessions=c["n_sessions"],
                          n_requests=c["n_requests"], prompt_len=prompt,
                          decode_tokens=c["decode_tokens"],
                          store_latency=c["store_latency"],
                          cache_sessions=c["cache_sessions"],
                          arrival_rate=c["arrival_rate"])
        res = {}
        for mode in ("sync", "prefetch"):
            reset_launches()
            t0 = time.perf_counter()
            out = run_serving(cfg, mode, device="cuda")
            wall = time.perf_counter() - t0
            counts = launches()
            need = LM_KERNELS[arch] + ARENA_KERNELS
            if arch == "zamba2-2.7b" \
                    and out["n_pages_per_session"] != ZAMBA2_STATE_PAGES:
                raise AssertionError(f"serve_lm {arch}: "
                                     f"{out['n_pages_per_session']} pages a "
                                     f"session, K2's timed shape has "
                                     f"{ZAMBA2_STATE_PAGES}")
            if out["n_tokens"] != c["n_requests"] * c["decode_tokens"] \
                    or min(counts[k] for k in need) == 0:
                raise AssertionError(f"serve_lm {arch} {mode}: tokens "
                                     f"{out['n_tokens']}, launches {counts}")
            for k in total:
                total[k] += counts[k]
            res[mode] = out
            emit("serve_lm", arch=arch, mode=mode, prompt_len=prompt,
                 wall_s=wall, launches=counts,
                 **{k: out[k] for k in (
                     "n_tokens", "ttft_p50", "ttft_p99", "tpot_p50",
                     "arena_hit_rate", "staging_overlap",
                     "store_writebacks", "n_pages_per_session")})
        if not (res["prefetch"]["staging_overlap"]
                > res["sync"]["staging_overlap"]
                and res["prefetch"]["ttft_p99"] < res["sync"]["ttft_p99"]):
            raise AssertionError(f"serve_lm {arch}: prefetch does not beat "
                                 f"sync: {res}")
    return total


# the train phase: gemma-7b at its published width (configs/gemma_7b.py),
# 8 of its 28 layers (bf16 params and grads, fp32 moments: 12 bytes a
# parameter, 36 GB for 3.0 B parameters; all 28 would need 102 GB), 4 x
# 2048 tokens a step of the synthetic bigram stream, layers recomputed in
# the backward; the card against the CPU at 2 layers in fp32 on 512 tokens
# (the CPU's time); then examples/train_lm_torch.py as it runs
TRAIN = dict(arch="gemma-7b", layers=8, batch=4, seq=2048, steps=20,
             timed=10, lr=3e-4, warmup=5, seed=0, cpu_layers=2, cpu_batch=1,
             cpu_seq=512, loss_rel=1e-4, grad_rel=1e-3, peak_gb=70.0,
             boundary_rel=1e-2)
# zamba2's fp32 leaves through its bf16 gradient boundaries are held to
# boundary_rel (grad_rel holds them with the boundaries as identities);
# the relative noises on K7's output of the CPU's witness runs: one
# rounding of fp32 (2^-24), and K7's fp32 backward's distance from its
# plain version on the card: 5.82e-5 of the largest gradient (dA at the
# "zamba2 chunk" row; the other gradients 1.7e-5 at most) with its inputs
# split bf16 hi + lo, on an H100 80GB HBM3 at 700 W
BOUNDARY_NOISE = (2.0 ** -24, 5.82e-5)
# zamba2-2.7b (K6, K7) and rwkv6-3b (K8) the same way at their published
# width and depth (configs/zamba2_2_7b.py: 54 layers, 2.44 B parameters,
# 29 GB of state; configs/rwkv6_3b.py: 32 layers, 3.10 B, 37 GB), fewer
# steps to keep the script's time
TRAIN_SSM = {"zamba2-2.7b": dict(TRAIN, arch="zamba2-2.7b", layers=None,
                                 steps=12, timed=6),
             "rwkv6-3b": dict(TRAIN, arch="rwkv6-3b", layers=None, steps=12,
                              timed=6)}
# a Mamba2 at the published family's state size: zamba2-2.7b's config
# (d_model 2560, headdim 64, expand 2, one group) with
# state-spaces/mamba2-2.7b's d_state 128 and chunk 256, at published
# width, 8 of 54 layers, 4 steps (warm-up 1: three at the peak rate)
TRAIN_D128 = dict(TRAIN, arch="zamba2-2.7b", layers=8, steps=4, timed=2,
                  warmup=1, ssm=dict(state_dim=128, chunk=256),
                  kernels=("mamba2_scan", "mamba2_scan_bwd"))
# the kernels each arch's training step must launch, forward and backward
TRAIN_KERNELS = {"gemma-7b": ("flash_attention", "flash_attention_bwd"),
                 "zamba2-2.7b": ("flash_attention", "flash_attention_bwd",
                                 "mamba2_scan", "mamba2_scan_bwd"),
                 "rwkv6-3b": ("rwkv6_scan", "rwkv6_scan_bwd")}


def train_full_width(c=TRAIN):
    """(a) the training step at full width: ``c``'s steps through
    ``build_training`` on the card (every layer when ``c["layers"]`` is
    None; ``c["ssm"]`` replaces fields of the config's SSM), each kernel
    of ``c["kernels"]`` (the arch's ``TRAIN_KERNELS``) launched.  Returns
    its JSON row and the launch counts of those steps (the arch's train
    path)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    over = {} if c["layers"] is None else dict(num_layers=c["layers"])
    if "ssm" in c:
        over["ssm"] = dataclasses.replace(get_config(c["arch"]).ssm,
                                          **c["ssm"])
    kernels = c.get("kernels", TRAIN_KERNELS[c["arch"]])
    state, step_fn, _, cfg = build_training(
        c["arch"], smoke=False, batch=c["batch"], seq=c["seq"], lr=c["lr"],
        seed=c["seed"], device="cuda", warmup=c["warmup"], remat="block",
        **over)
    n_params = sum(t.numel() for t in tree_flatten(state[0])[0])
    losses, step_ms = [], []
    reset_launches()
    for step in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, step)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        emit("train_step", arch=c["arch"], step=step, loss=losses[-1],
             ms=step_ms[-1], grad_norm=float(met["grad_norm"]),
             lr=float(met["lr"]))
    clocks = smi_clocks()                # right after the timed steps
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.median(step_ms[-c["timed"]:])
    prof = profile_step(lambda: step_fn(state, c["steps"]))
    layer = k7_layer_check(step_fn, state, c["steps"] + 1) \
        if "mamba2_scan_bwd" in kernels else None
    row = dict(arch=c["arch"], layers=cfg.num_layers, of_layers=get_config(
        c["arch"]).num_layers, d_model=cfg.d_model, params=n_params,
        batch=c["batch"], seq=c["seq"], dtype=cfg.dtype, remat=cfg.remat,
        lr_peak=c["lr"], warmup=c["warmup"], losses=losses,
        step_ms=ms_step, step_ms_all=step_ms,
        tokens_per_s=c["batch"] * c["seq"] / (ms_step / 1e3),
        peak_gb=peak / 1e9, launches=counts, ssm=c.get("ssm"),
        kernel_launches={k: counts[k] for k in kernels},
        device_busy_share=prof["device_busy_share"], clocks=clocks,
        bwd_kernels=bwd_kernel_ms(prof), k7_layer=layer, profile=prof)
    del state
    torch.cuda.empty_cache()
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and all(counts[k] > 0 for k in kernels)
            and row["peak_gb"] < c["peak_gb"]):
        raise AssertionError(f"train {c['arch']} at full width: {row}")
    return row, counts


@contextlib.contextmanager
def k7_first_backward(record: dict):
    """K7's backward (``ms.mamba2_scan_backward``) with its first call
    inside recorded into ``record``: copies of its arguments and of the
    gradients it returned."""
    real = ms.mamba2_scan_backward

    def recording(*args):
        grads = real(*args)
        if not record:
            record["args"] = [a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args]
            record["grads"] = [g.clone() for g in grads]
        return grads

    ms.mamba2_scan_backward = recording
    try:
        yield
    finally:
        ms.mamba2_scan_backward = real


def k7_layer_check(step_fn, state, step: int) -> dict:
    """K7's backward at one layer's real training inputs: one more step
    of ``step_fn``, whose first call of K7's backward (the last Mamba2
    layer's: the forward's inputs and saved states, the cotangent the
    step gave it) is recorded and held against
    ``mamba2_scan_backward_plain`` on the same card tensors within
    ``BWD_TOL`` of its type (zamba2 trains in bf16: the tensor-core
    design).  Training starts every scan from a zero state, which the
    saved state entering the first chunk must show."""
    rec = {}
    with k7_first_backward(rec):
        step_fn(state, step)
    torch.cuda.synchronize()
    x, dt, A, Bm, Cm, Q, s_prev, dy, dstate = rec["args"]
    if bool(s_prev[:, 0].any()):
        raise AssertionError("k7_layer_check: the scan did not start from "
                             "a zero state")
    plain = ms.mamba2_scan_backward_plain(x, dt, A, Bm, Cm, Q, None, dy,
                                          dstate)
    grads = rec["grads"]
    tol = BWD_TOL[x.dtype]
    B, S, H, P = x.shape
    row = dict(shape=[B, S, H, Bm.shape[2], Bm.shape[3], P, Q],
               dtype=dtype_name(x.dtype), heads=ms.bwd_heads(x, Bm, Q),
               dstate=dstate is not None, rel_err=grads_rel(grads, plain),
               tol=tol,
               rel_by_grad=[max_err(a, b) / (float(b.float().abs().max())
                                             + 1e-30)
                            for a, b in zip(grads, plain)])
    del rec, plain, grads
    torch.cuda.empty_cache()
    if x.dtype != torch.bfloat16 or not row["rel_err"] <= tol:
        raise AssertionError(f"K7's backward at a layer's training inputs: "
                             f"{row}")
    return row


def leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(
            tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}.{i}")]
    return [prefix]


def card_and_cpu_grads(arch: str, card_faults=None, cpu_noises=()):
    """The step's loss and gradient (``loss_and_grads``, as
    ``make_train_step`` takes them) at TRAIN's cpu_layers in fp32, on the
    card and on the CPU from the same parameters and batch: (loss on the
    card, on the CPU, the leaves' relative errors, the card's launch
    counts, the CPU's seconds, the extra runs).  Each of ``card_faults``
    (name: context manager) reruns the card inside it, and each of
    ``cpu_noises`` reruns the CPU with K7's output perturbed by that
    relative noise (``k7_output_noise``); each extra run is held against
    the CPU's own gradient: {name: (loss_rel, the leaves' relative
    errors)}."""
    c = TRAIN
    (params, _), _, model, cfg = build_training(
        arch, smoke=False, batch=c["cpu_batch"], seq=c["cpu_seq"],
        lr=c["lr"], seed=c["seed"], device="cuda", warmup=c["warmup"],
        num_layers=c["cpu_layers"], remat="block", dtype="float32")
    batch = batch_at(DataConfig(cfg.vocab_size, c["cpu_seq"],
                                c["cpu_batch"], seed=c["seed"]), 0, "cuda")
    leaves, treedef = tree_flatten(params)
    cpu_params = tree_unflatten(treedef, [t.detach().cpu() for t in leaves])
    card_runs = {}
    for name, ctx in {"": contextlib.nullcontext(),
                      **(card_faults or {})}.items():
        reset_launches()
        with ctx:
            loss, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        card_runs[name] = (float(loss), launches(),
                           [g.cpu() for g in tree_flatten(grads)[0]])
        del grads
    del params, leaves
    torch.cuda.empty_cache()
    cpu_model = build_model(cfg, "cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, cpu_params, cpu_batch)
    cpu_s = time.perf_counter() - t0
    names = leaf_names(cpu_params)
    ref = tree_flatten(cpu_grads)[0]
    cpu_loss = float(cpu_loss)

    def held(loss, grads):
        return (abs(float(loss) - cpu_loss) / abs(cpu_loss),
                {n: float((a - b).norm() / b.norm())
                 for n, a, b in zip(names, grads, ref)})

    extra = {name: held(loss, grads)
             for name, (loss, _, grads) in card_runs.items() if name}
    for noise in cpu_noises:
        with k7_output_noise(noise):
            loss, grads = loss_and_grads(cpu_model, cpu_params, cpu_batch)
        extra[f"cpu, K7 output x (1 + {noise:g} n)"] = held(
            loss, tree_flatten(grads)[0])
    loss, counts, card = card_runs[""]
    return loss, cpu_loss, held(loss, card)[1], counts, cpu_s, extra


@contextlib.contextmanager
def identity_boundaries():
    """The models' bf16 gradient boundaries (``bf16_grad``) as identities,
    on both devices."""
    saved = [(m, m.bf16_grad) for m in (ssm_mod, lm_mod)]
    try:
        for m, _ in saved:
            m.bf16_grad = lambda x: x
        yield
    finally:
        for m, f in saved:
            m.bf16_grad = f


@contextlib.contextmanager
def k7_output_noise(rel: float, seed: int = 1):
    """The models' K7 (``ssm.mamba2_scan_kernel``) with its output y
    multiplied by 1 + rel n, n standard normal from a seeded generator: a
    stand-in for another device's rounding of the same scan."""
    real = ssm_mod.mamba2_scan_kernel
    g = torch.Generator().manual_seed(seed)

    def noisy(*args, **kw):
        y, state = real(*args, **kw)
        n = torch.randn(y.shape, generator=g).to(y.device, y.dtype)
        return y * (1 + rel * n), state

    ssm_mod.mamba2_scan_kernel = noisy
    try:
        yield
    finally:
        ssm_mod.mamba2_scan_kernel = real


@contextlib.contextmanager
def k7_state_grads_dropped():
    """A planted fault on the card: K7's backward with the state gradients
    between chunks dropped (all but the last chunk's set to zero before
    ``backward_from_dstates``), the fault the kernel gate plants."""
    real = ms.backward_dstates

    def dropped(*args, **kw):
        ds, dinit = real(*args, **kw)
        ds[:, :-1] = 0
        return ds, dinit

    ms.backward_dstates = dropped
    try:
        yield
    finally:
        ms.backward_dstates = real


def train_card_vs_cpu(arch: str = TRAIN["arch"]):
    """(b) the card against the CPU at TRAIN's cpu_layers in fp32
    (``card_and_cpu_grads``): the loss within TRAIN's loss_rel, each
    gradient leaf within grad_rel of its norm, every kernel of the arch's
    training launched.  zamba2 goes through its bf16 gradient boundaries
    (``bf16_grad``) on both devices, where a cotangent whose fp32 value
    differs in its last bits between the devices can round to the
    neighbouring bf16 value, and each boundary upstream turns those into
    more.  So its leaves are held to grad_rel with the boundaries as
    identities on both sides, and through the boundaries to boundary_rel,
    which the card's run with K7's state gradients dropped between chunks
    (``k7_state_grads_dropped``) must miss.  Beside them, the CPU against
    itself with K7's output perturbed (``k7_output_noise``) at
    ``BOUNDARY_NOISE`` through the boundaries and without them: how far
    the boundaries alone spread a difference of that size."""
    c = TRAIN
    zamba = arch == "zamba2-2.7b"
    loss, cpu_loss, rels, counts, cpu_s, extra = card_and_cpu_grads(
        arch, card_faults={"k7_state_grads_dropped": k7_state_grads_dropped()}
        if zamba else None, cpu_noises=BOUNDARY_NOISE if zamba else ())
    row = dict(arch=arch, layers=c["cpu_layers"], dtype="float32",
               batch=c["cpu_batch"], seq=c["cpu_seq"], loss_card=loss,
               loss_cpu=cpu_loss,
               loss_rel=abs(loss - cpu_loss) / abs(cpu_loss),
               grad_rel_worst=max(rels.values()),
               grad_rel_worst_leaf=max(rels, key=rels.get), grad_rel=rels,
               launches=counts, cpu_s=cpu_s)
    held, limit = row, c["grad_rel"]
    if zamba:
        limit = c["boundary_rel"]

        def summary(loss_rel, r):
            return dict(loss_rel=loss_rel, grad_rel_worst=max(r.values()),
                        grad_rel_worst_leaf=max(r, key=r.get),
                        leaves_above_grad_rel=sum(v > c["grad_rel"]
                                                  for v in r.values()))

        fault = summary(*extra.pop("k7_state_grads_dropped"))
        row.update(boundary_rel=limit, planted_fault=fault,
                   bf16_boundary_misses={k: v for k, v in rels.items()
                                         if v > c["grad_rel"]},
                   boundary_witness={k: summary(*v)
                                     for k, v in extra.items()})
        with identity_boundaries():
            loss_i, cpu_loss_i, rels_i, counts_i, _, extra_i = \
                card_and_cpu_grads(arch, cpu_noises=BOUNDARY_NOISE)
        held = dict(loss_rel=abs(loss_i - cpu_loss_i) / abs(cpu_loss_i),
                    grad_rel_worst=max(rels_i.values()),
                    grad_rel_worst_leaf=max(rels_i, key=rels_i.get))
        row.update(identity_boundaries=dict(
            held, grad_rel=rels_i, launches=counts_i,
            witness={k: summary(*v) for k, v in extra_i.items()}))
        if not fault["grad_rel_worst"] > limit:
            raise AssertionError(f"train card vs cpu {arch}: the limit "
                                 f"{limit} through the boundaries would pass "
                                 f"K7's state gradients dropped: {row}")
    if not (row["loss_rel"] <= c["loss_rel"]
            and row["grad_rel_worst"] <= limit
            and held["loss_rel"] <= c["loss_rel"]
            and held["grad_rel_worst"] <= c["grad_rel"]
            and all(counts[k] > 0 for k in TRAIN_KERNELS[arch])):
        raise AssertionError(f"train card vs cpu {arch}: {row}")
    return row


def train_example():
    """(c) examples/train_lm_torch.py on the card: the smoke gemma-7b,
    microbatches of two, a failure injected half-way; the example itself
    requires one restart and a falling loss."""
    path = Path(__file__).resolve().parent / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rep = example.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = launches()
    row = dict(example="examples/train_lm_torch.py", restarts=rep.restarts,
               steps_run=rep.steps_run, loss_first=rep.losses[0],
               loss_last=rep.losses[-1], wall_s=wall, launches=counts,
               printed=out.getvalue().splitlines())
    if not (rep.restarts == 1 and rep.losses[-1] < rep.losses[0]
            and counts["flash_attention_bwd"] > 0):
        raise AssertionError(f"train example: {row}")
    return row


def train_phase():
    """Training on the card: (a) gemma-7b, zamba2-2.7b and rwkv6-3b at
    full width (each arch's train path), (b) each against the CPU in
    fp32, then a Mamba2 at d_state 128 (``TRAIN_D128``), (c) the
    example's supervised run with a failure.  Returns the launch counts
    of each (a), by path."""
    paths = {}
    for path, c in (("train", TRAIN),
                    ("train_zamba2", TRAIN_SSM["zamba2-2.7b"]),
                    ("train_rwkv6", TRAIN_SSM["rwkv6-3b"])):
        row, paths[path] = train_full_width(c)
        emit("train", **row)
        emit("train_card_vs_cpu", **train_card_vs_cpu(c["arch"]))
    row, paths["train_mamba2_d128"] = train_full_width(TRAIN_D128)
    emit("train", **row)
    emit("train_example", **train_example())
    return paths


# ------------------------------------------- the launch and analysis slice
EXAMPLES = Path(__file__).resolve().parent / "examples"
# serve_lm_torch: its defaults (gemma-7b, every mode), then zamba2-2.7b and
# rwkv6-3b in prefetch mode for K7 and K8
SERVE_LM_RUNS = ([], ["--arch", "zamba2-2.7b", "--modes", "prefetch"],
                 ["--arch", "rwkv6-3b", "--modes", "prefetch"])
SERVE_EXAMPLE_KERNELS = ("tac_probe", "page_gather", "page_scatter",
                         "flash_attention", "mamba2_scan", "rwkv6_scan")


def run_example(name: str, args, where: Path = EXAMPLES) -> str:
    """``examples/<name>`` (or ``<where>/<name>``) run as a script with
    ``args``; its stdout.  A script that ends by ``sys.exit`` must exit
    0."""
    out, argv = io.StringIO(), sys.argv
    sys.argv = [str(where / name)] + list(args)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(where / name), run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"{name} {args} exited {e.code}") from e
    finally:
        sys.argv = argv
    return out.getvalue()


def serve_examples_phase(obs_side=None):
    """The serving examples at their default sizes on the card:
    ``serve_stream_torch.py`` prints what its ``--device cpu`` run prints,
    and ``serve_lm_torch.py`` (``launch/serve.py``'s ``main``) launches
    K1-K3 and K6-K8; then the quickstart (``quickstart_run``).  Returns
    the launch counts of the serving examples and of the quickstart's
    card run, by path; then the engine's report (``obs_report_run``, its
    CPU side ``obs_side`` if started already)."""
    total = {k: 0 for k in launches()}
    t0 = time.perf_counter()
    reset_launches()
    stream = {dev: run_example("serve_stream_torch.py", ["--device", dev])
              for dev in ("cuda", "cpu")}
    counts = launches()
    if stream["cuda"] != stream["cpu"] or "ttft" not in stream["cuda"]:
        raise AssertionError(f"serve_stream_torch: the card printed "
                             f"{stream['cuda'][-400:]!r}, the CPU "
                             f"{stream['cpu'][-400:]!r}")
    for k in total:
        total[k] += counts[k]
    emit("serve_examples", example="examples/serve_stream_torch.py",
         equal_to_cpu=True, summary=stream["cuda"].strip().splitlines()[-1],
         launches=counts, wall_s=time.perf_counter() - t0)
    for args in SERVE_LM_RUNS:
        reset_launches()
        t1 = time.perf_counter()
        printed = run_example("serve_lm_torch.py", args)
        counts = launches()
        for k in total:
            total[k] += counts[k]
        emit("serve_examples", example="examples/serve_lm_torch.py",
             args=args, printed=printed.strip().splitlines(),
             launches=counts, wall_s=time.perf_counter() - t1)
    if min(total[k] for k in SERVE_EXAMPLE_KERNELS) == 0:
        raise AssertionError(f"serve examples: a kernel never launched: "
                             f"{total}")
    emit("serve_examples_total", launches=total,
         wall_s=time.perf_counter() - t0)
    return {"serve_examples": total, "quickstart": quickstart_run(),
            "obs_report": obs_report_run(obs_side)}


TOOLS = Path(__file__).resolve().parent / "tools"
OBS_REPORT_ARGS = ["--fused", "--duration", "2", "--warmup", "1"]


def obs_report_cpu_side():
    """``obs_report_run``'s CPU side, started now in a process of its
    own."""
    return CpuSide("run_example", "obs_report_torch.py",
                   OBS_REPORT_ARGS + ["--device", "cpu"], TOOLS)


def obs_report_run(cpu_side=None):
    """``tools/obs_report_torch.py --fused --device cuda`` (the reference
    engine's observability report on the port, its q5 smoke pipeline on
    the fused plane) prints what its ``--device cpu`` run prints, line for
    line: the same simulated-time stage table, hint quality, evictions
    and fused rollup; both fused kernels launch.  Returns the card run's
    launch counts."""
    cpu_side = cpu_side or obs_report_cpu_side()
    t0 = time.perf_counter()
    reset_launches()
    card = run_example("obs_report_torch.py",
                       OBS_REPORT_ARGS + ["--device", "cuda"], TOOLS)
    counts = launches()
    card_s = time.perf_counter() - t0
    cpu, cpu_s = cpu_side.result()
    lines = card.strip().splitlines()
    if lines != cpu.strip().splitlines() \
            or not any("critical-path stages" in ln for ln in lines) \
            or not any("batch-fill" in ln for ln in lines):
        raise AssertionError(f"obs_report_torch: the card printed {card!r}, "
                             f"the CPU {cpu!r}")
    if min(counts[k] for k in FUSED_KERNELS) == 0:
        raise AssertionError(f"obs_report_torch: a fused kernel never "
                             f"launched: {counts}")
    emit("obs_report", tool="tools/obs_report_torch.py",
         args=OBS_REPORT_ARGS + ["--device", "cuda"], equal_to_cpu=True,
         printed=lines, launches=counts, cuda_wall_s=card_s,
         cpu_wall_s=cpu_s)
    return counts


def quickstart_run():
    """``examples/quickstart_torch.py --fused`` on the card prints what its
    ``--device cpu`` run prints, line for line; its fused run launches
    both fused kernels.  Returns the card run's launch counts."""
    cpu_side = CpuSide("run_example", "quickstart_torch.py",
                       ["--fused", "--device", "cpu"])
    t0 = time.perf_counter()
    reset_launches()
    card = run_example("quickstart_torch.py", ["--fused"])
    counts = launches()
    card_s = time.perf_counter() - t0
    cpu, cpu_s = cpu_side.result()
    lines = card.strip().splitlines()
    if lines != cpu.strip().splitlines() or "batch-fill" not in lines[-1]:
        raise AssertionError(f"quickstart_torch: the card printed {card!r}, "
                             f"the CPU {cpu!r}")
    if min(counts[k] for k in FUSED_KERNELS) == 0:
        raise AssertionError(f"quickstart_torch: a fused kernel never "
                             f"launched: {counts}")
    emit("serve_examples", example="examples/quickstart_torch.py",
         args=["--fused"], equal_to_cpu=True, printed=lines,
         launches=counts, cuda_wall_s=card_s, cpu_wall_s=cpu_s)
    return counts


# the mesh phase: gemma-7b at its published width, 2 of its 28 layers, 3
# AdamW steps of 2 microbatches of 2 x 1024 tokens, without a mesh and on
# a 1 x 1 DeviceMesh of one NCCL rank
MESH_TRAIN = dict(arch="gemma-7b", layers=2, batch=4, seq=1024, n_micro=2,
                  steps=3, lr=3e-4, warmup=5, seed=0)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_steps(mesh=None, c=MESH_TRAIN):
    """``c``'s steps through ``build_training`` (with ``mesh``, placed on
    it); (losses, step ms, final params)."""
    state, step_fn, _model, _cfg = build_training(
        c["arch"], smoke=False, batch=c["batch"], seq=c["seq"],
        n_micro=c["n_micro"], lr=c["lr"], seed=c["seed"], device="cuda",
        warmup=c["warmup"], mesh=mesh, num_layers=c["layers"],
        remat="block")
    losses, step_ms = [], []
    for step in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, step)
        loss = met["loss"]
        losses.append(float(loss.full_tensor() if hasattr(
            loss, "full_tensor") else loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, state[0]


def mesh_phase():
    """The port on a DeviceMesh: a one-rank NCCL group and a 1 x 1
    ``("data", "model")`` mesh.  gemma-7b's steps with parameters and
    moments as DTensors placed by ``policy_for(cfg, "train")`` and the
    gradients pinned by ``grad_shardings`` give the losses of the same
    steps without a mesh, bit for bit (on 1 x 1 the local ops are the same
    ops); K6's forward and backward launch under ``local_map``;
    ``int8_allreduce`` on the group equals quantise-dequantise;
    ``reshard_params`` from (1, 1) to (1,) keeps every leaf.  Returns the
    launch counts of the meshed steps."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.compression import (dequantize_int8,
                                                 int8_allreduce,
                                                 quantize_int8)
    from repro_torch.runtime.elastic import reshard_params
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        plain, plain_ms, _ = mesh_steps()
        torch.cuda.empty_cache()
        reset_launches()
        meshed, mesh_ms, params = mesh_steps(mesh)
        counts = launches()
        leaves = tree_flatten(params)[0]
        if not all(isinstance(t, DTensor) for t in leaves):
            raise AssertionError("mesh: a parameter is no DTensor")
        if meshed != plain or counts["flash_attention"] == 0 \
                or counts["flash_attention_bwd"] == 0:
            raise AssertionError(f"mesh: losses {meshed} against {plain} "
                                 f"without a mesh, launches {counts}")
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(4096, generator=g, device="cuda")
        reduced = int8_allreduce(x)
        int8_ok = torch.equal(reduced, dequantize_int8(*quantize_int8(x)))
        on1 = reshard_params(params, make_mesh((1,), ("data",)))
        reshard_ok = all(torch.equal(a.full_tensor(), b.full_tensor())
                         for a, b in zip(leaves, tree_flatten(on1)[0]))
        if not (int8_ok and reshard_ok):
            raise AssertionError(f"mesh: int8_allreduce {int8_ok}, "
                                 f"reshard_params {reshard_ok}")
        row = dict(arch=MESH_TRAIN["arch"], layers=MESH_TRAIN["layers"],
                   mesh=[1, 1], axes=["data", "model"], backend="nccl",
                   losses=meshed, losses_without_mesh=plain, equal=True,
                   step_ms=statistics.median(mesh_ms[1:]),
                   step_ms_without_mesh=statistics.median(plain_ms[1:]),
                   step_ms_all=mesh_ms, step_ms_all_without_mesh=plain_ms,
                   flash_attention_launches=counts["flash_attention"],
                   flash_attention_bwd_launches=counts[
                       "flash_attention_bwd"],
                   int8_allreduce_equal=True, reshard_equal=True,
                   n_params=len(leaves), launches=counts)
        del params, on1, leaves
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    emit("mesh", **row)
    return counts


DRYRUN_CELLS = (("gemma-7b", "train_4k", "single"),
                ("deepseek-v2-236b", "decode_32k", "multi"))


def dryrun_start():
    """``python -m repro_torch.launch.dryrun`` for each cell of
    ``DRYRUN_CELLS``, each in a process of its own (its fake process group
    must not meet this process's), all started now, on the CPU beside the
    card's phases; ``dryrun_phase`` collects them.  An analysis on meta
    tensors with the H100's figures: it runs nothing on the card."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = tempfile.mkdtemp()
    procs = []
    for cell in DRYRUN_CELLS:
        log = Path(out) / f"{'__'.join(cell)}.log"
        with open(log, "w") as f:      # a file: no pipe fills while it waits
            procs.append((cell, log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 cell[0], "--shape", cell[1], "--mesh", cell[2], "--out",
                 out], env=env, cwd=root, stdout=f,
                stderr=subprocess.STDOUT)))
    CPU_SIDES.extend(proc for _, _, proc in procs)
    return out, procs, time.perf_counter()


def dryrun_phase(started=None):
    """The dry-run cells of ``dryrun_start``: each record must be ``ok``."""
    out, procs, t0 = started or dryrun_start()
    try:
        for cell, log, proc in procs:
            try:
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            path = Path(out) / f"{'__'.join(cell)}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            if proc.returncode or not rec.get("ok"):
                raise AssertionError(f"dryrun {cell}: exit {proc.returncode}"
                                     f", {rec.get('error')}, "
                                     f"{log.read_text()[-2000:]}")
            r, mem = rec["roofline"], rec["memory"]
            emit("dryrun", arch=cell[0], shape=cell[1], mesh=cell[2],
                 dominant=r["dominant"],
                 roofline_fraction=r["roofline_fraction"],
                 live_gib=mem["live_bytes"] / 2 ** 30,
                 wall_s=rec["wall_s"], record=rec)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    emit("dryrun_total", wall_s=time.perf_counter() - t0)


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
         cuda=torch.version.cuda, clocks=smi_clocks())
    # float32 products in full float32: the tolerances are 2e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = cuda_build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in cuda_build.BUILD_LOG.items()}
    emit("build", seconds=build_s, seconds_by_source=cuda_build.BUILD_SECONDS,
         ptxas=ptxas)
    dryrun = dryrun_start()
    wide_sides = wide_cpu_sides()
    serve_sides = serve_cpu_sides()
    obs_side = obs_report_cpu_side()
    main_rows, errs = kernel_phase()
    for rows, e in (fused_kernel_phase(), lm_kernel_phase()):
        main_rows.update(rows)
        errs.update(e)
    rows, e = train_kernel_phase()
    main_rows.update(rows)
    errs.update(e)
    for k, e in wide_phase().items():    # the widths past the instances
        errs[k] = max(errs.get(k, 0.0), e)
    paths = dict(zip(("e2e", "e2e_compare"), e2e_phase()))
    paths.update(zip(("prefetch", "prefetch_compare"), prefetch_phase()))
    paths["recovery"] = recovery_phase()
    paths["e2e_wide"] = wide_batch_phase(wide_sides)
    for slots in (E2E["cache_entries"], DEPLOY_SLOTS):
        for batch in PLANE_BATCHES:
            plane_phase(slots, batch)
    for slots in (E2E["cache_entries"], DEPLOY_SLOTS):
        profile_phase(slots)
    paths["serve"] = serve_phase(serve_sides)
    paths["hints"] = hints_phase()
    paths["tac_ops"] = tac_ops_phase()
    paths["models"] = models_phase()
    paths["serve_lm"] = serve_lm_phase()
    paths.update(train_phase())
    paths.update(serve_examples_phase(obs_side))
    paths["mesh"] = mesh_phase()
    dryrun_phase(dryrun)
    names = {"tac_probe": ("tac_probe.cu",
                           "src/repro/kernels/tac_probe/tac_probe.py:36"),
             "page_gather": ("page_gather.cu",
                             "src/repro/kernels/page_gather/page_gather.py:26"),
             "page_scatter": ("page_gather.cu",
                              "src/repro/kernels/page_gather/page_gather.py:50"),
             "tac_fused_step": ("tac_fused.cu",
                                "src/repro/kernels/tac_probe/tac_probe.py:36"),
             "tac_fused_admit": (
                 "tac_fused.cu",
                 "src/repro/kernels/page_gather/page_gather.py:50"),
             "decode_attention": (
                 "decode_attention.cu",
                 "src/repro/kernels/decode_attention/decode_attention.py:64"),
             "cms_sketch": ("cms_sketch.cu",
                            "src/repro/kernels/cms_sketch/cms_sketch.py:38"),
             "flash_attention": (
                 "flash_attention.cu",
                 "src/repro/kernels/flash_attention/flash_attention.py:70"),
             # the gradients of the same TPU kernels (K6-K8), which have no
             # backward kernel of their own (the reference differentiates
             # pure jnp)
             "flash_attention_bwd": (
                 "flash_attention_bwd.cu",
                 "src/repro/kernels/flash_attention/flash_attention.py:70"),
             "mamba2_scan": ("mamba2_scan.cu",
                             "src/repro/kernels/mamba2_scan/mamba2_scan.py:66"),
             "mamba2_scan_bwd": (
                 "mamba2_scan_bwd.cu",
                 "src/repro/kernels/mamba2_scan/mamba2_scan.py:66"),
             "rwkv6_scan": ("rwkv6_scan.cu",
                            "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:52"),
             "rwkv6_scan_bwd": (
                 "rwkv6_scan_bwd.cu",
                 "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:52")}
    kernels = [dict(name=k, route="cuda",
                    source=f"src/repro_torch/csrc/{names[k][0]}",
                    replaces=names[k][1],
                    launches=sum(p[k] for p in paths.values()),
                    launches_by_path={n: p[k] for n, p in paths.items()},
                    max_abs_err=errs[k], ms=main_rows[k]["ms"],
                    plain_ms=main_rows[k]["plain_ms"],
                    bound_ms=main_rows[k]["bound_ms"],
                    bound_by=main_rows[k]["bound_by"],
                    library_ms=main_rows[k]["library_ms"],
                    # the walks past (576, 512) and the wgmma route at
                    # MLA's latent, on no main path: their kernel_check
                    # rows' launches and their timed rows
                    **({"wgmma": dict(kernel="decode_wgmma_kernel",
                                      launches=ROUTE_CHECK_LAUNCHES["wgmma"],
                                      rows=WG_ROWS),
                        "walk_tc": dict(kernel="decode_walk_tc_kernel",
                                        launches=ROUTE_CHECK_LAUNCHES[
                                            "walk_tc"],
                                        rows=WALK_TC_ROWS),
                        "walk": dict(kernel="decode_walk_kernel",
                                     launches=ROUTE_CHECK_LAUNCHES["walk"],
                                     rows=WALK_ROWS)}
                       if k == "decode_attention" else {}))
               for k in names]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
