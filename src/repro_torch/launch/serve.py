"""Serving driver: continuous-batching LM serving over the paged
session-state subsystem (``repro_torch.serving``, DESIGN.md §2/§6), in
PyTorch: the port of ``repro/launch/serve.py``.

Sessions' KV caches are RAVELED INTO FIXED-SIZE PAGES and persisted in the
tiered session store; the device-resident arena (TAC page table + physical
page pool) holds the working set.  The scheduler's ingest stage sees each
request's session key at enqueue time and in ``prefetch`` mode hints the
store, which stages the session's pages toward the arena while the request
queues.  The ``sync`` baseline stages on demand; ``async`` overlaps I/O but
has no lookahead window.

Decode compute is REAL (the smoke model, eager, on ``device``); store I/O
is modelled by the calibrated backend latencies on a virtual clock that the
measured compute also advances — so TTFT/TPOT mix real compute with
modelled staging and differ from device to device.  The model, the arena
and its pools sit on ``device`` ("cuda" unless the caller asks for "cpu");
the store's tiers hold host tensors.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 48
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import build_model
from repro_torch.serving import (ContinuousBatchingScheduler, PagedStateArena,
                                 Request, ServingMetrics, SimClock,
                                 TieredStore, WallClock)
from repro_torch.streaming.backend import BackendModel

PAGE_KEY_STRIDE = 4096     # page key = sid * stride + page_idx + 1


@dataclass
class ServeConfig:
    arch: str = "gemma-7b"
    n_sessions: int = 24
    n_requests: int = 48
    prompt_len: int = 32
    decode_tokens: int = 4
    cache_sessions: int = 8            # arena capacity (sessions)
    page_elems: int = 8192             # fp32 elements per state page
    arrival_rate: float = 400.0        # offered load, requests/s
    max_batch: int = 4
    store_latency: float = 0.012       # backing-tier base latency (s)
    store_bandwidth: float = 1.2e9
    wall_clock: bool = False


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """Leaves in ``jax.tree.flatten``'s order (dict keys sorted, lists and
    tuples in order) and the structure to rebuild the tree from them."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return [l for p in parts for l in p[0]], \
            ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        return [l for p in parts for l in p[0]], \
            (type(tree), None, [p[1] for p in parts])
    return [tree], None


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, subs = d
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        return kind(build(s) for s in subs)
    return build(treedef)


class StatePager:
    """Ravel the float leaves of a KV-cache tree into fixed-size pages
    (and back).  Non-float leaves (decode position) ride as aux state.
    Leaves are taken in ``jax.tree.flatten``'s order, so the pages of a
    cache equal the reference pager's pages of the same cache."""

    def __init__(self, example: Any, page_elems: int):
        leaves, self.treedef = tree_flatten(example)
        self.is_float = [l.is_floating_point() for l in leaves]
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(np.prod(s)) if f else 0
                      for s, f in zip(self.shapes, self.is_float)]
        self.total = sum(self.sizes)
        self.page_elems = page_elems
        self.n_pages = max(1, math.ceil(self.total / page_elems))

    def to_pages(self, kv: Any) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        leaves, _ = tree_flatten(kv)
        flat = torch.cat([l.float().reshape(-1)
                          for l, f in zip(leaves, self.is_float) if f])
        flat = torch.nn.functional.pad(
            flat, (0, self.n_pages * self.page_elems - self.total))
        pages = flat.reshape(self.n_pages, self.page_elems, 1)
        aux = [l for l, f in zip(leaves, self.is_float) if not f]
        return pages, aux

    def from_pages(self, pages: torch.Tensor, aux: List[Any]) -> Any:
        flat = pages.reshape(-1)[:self.total]
        leaves, off, ai = [], 0, 0
        for f, shape, dtype, size in zip(self.is_float, self.shapes,
                                         self.dtypes, self.sizes):
            if f:
                leaves.append(flat[off:off + size].reshape(shape).to(dtype))
                off += size
            else:
                leaves.append(aux[ai])
                ai += 1
        return tree_unflatten(self.treedef, leaves)


def page_keys(sid: int, n_pages: int) -> np.ndarray:
    assert n_pages < PAGE_KEY_STRIDE
    return np.asarray([sid * PAGE_KEY_STRIDE + p + 1
                       for p in range(n_pages)], np.int32)


def _grow_kv(kv: Any, prompt_len: int, T: int) -> Any:
    """Pad the KV time axis (== prompt_len) up to T decode slots: the first
    axis of a float leaf of rank >= 3 whose size is ``prompt_len``, as the
    reference does."""
    def grow(a):
        if a.dim() >= 3 and a.dtype != torch.int32:
            for ax in range(a.dim()):
                if a.shape[ax] == prompt_len:
                    shape = list(a.shape)
                    shape[ax] = T - prompt_len
                    return torch.cat([a, a.new_zeros(shape)], dim=ax)
        return a
    leaves, treedef = tree_flatten(kv)
    return tree_unflatten(treedef, [grow(l) for l in leaves])


def run_serving(cfg: ServeConfig, mode: str, seed: int = 0,
                device="cuda") -> Dict[str, float]:
    """Serve ``n_requests`` multi-turn requests in the given mode and return
    the metrics summary.  The arrival schedule is derived from (seed,
    arrival_rate) only, so different modes face EQUAL offered load."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    scfg = get_smoke_config(cfg.arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_model(scfg, device).init_params(gen)
    rng = np.random.RandomState(seed)

    T = cfg.prompt_len + cfg.decode_tokens + 8

    def prompt():
        return torch.from_numpy(rng.randint(0, scfg.vocab_size,
                                            (1, cfg.prompt_len))
                                .astype(np.int32))

    # ---- session histories -> pages in the backing tier
    _, kv0 = model.prefill({"tokens": prompt()})
    kv0 = _grow_kv(kv0, cfg.prompt_len, T)
    pager = StatePager(kv0, cfg.page_elems)

    backing = BackendModel("session-store", cfg.store_latency,
                           cfg.store_bandwidth, parallelism=32)
    store = TieredStore(backing_model=backing,
                        page_bytes=cfg.page_elems * 4, workers=8)
    session_aux: Dict[int, List[Any]] = {}
    for sid in range(cfg.n_sessions):
        _, kv = model.prefill({"tokens": prompt()})
        pages, aux = pager.to_pages(_grow_kv(kv, cfg.prompt_len, T))
        pages = pages.cpu()
        session_aux[sid] = aux
        for p, key in enumerate(page_keys(sid, pager.n_pages)):
            store.seed(int(key), {"state": pages[p]})

    # ---- arena sized for cache_sessions resident sessions
    ways = 4
    n_buckets = max(1, math.ceil(cfg.cache_sessions * pager.n_pages / ways))
    arena = PagedStateArena(n_buckets, ways,
                            {"state": ((cfg.page_elems, 1), torch.float32)},
                            device=device)

    clock = WallClock() if cfg.wall_clock else SimClock()
    sched = ContinuousBatchingScheduler(arena, store, mode=mode,
                                        max_batch=cfg.max_batch, clock=clock,
                                        metrics=ServingMetrics())

    # ---- one device step: pages -> KV -> decode -> pages
    def step(pages, aux, tok, pos):
        kv = pager.from_pages(pages, aux)
        kv["pos"] = pos
        logits, kv2 = model.decode(kv, {"tokens": tok, "pos": pos})
        pages2, aux2 = pager.to_pages(kv2)
        return logits, pages2, aux2

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    one = torch.ones((1, 1), dtype=torch.int32)
    # warm up outside the measurement
    warm_pages, warm_aux = pager.to_pages(kv0)
    step(warm_pages, warm_aux, one, torch.tensor(cfg.prompt_len,
                                                 dtype=torch.int32))
    sync()

    # ---- request stream (equal offered load across modes)
    arrivals = np.cumsum(rng.exponential(1.0 / cfg.arrival_rate,
                                         cfg.n_requests))
    sessions = rng.randint(0, cfg.n_sessions, cfg.n_requests)
    t0 = clock.now()
    pending: List[Request] = [
        Request(rid=i, session=int(sessions[i]),
                page_keys=page_keys(int(sessions[i]), pager.n_pages),
                n_tokens=cfg.decode_tokens,
                meta={"pos": cfg.prompt_len})
        for i in range(cfg.n_requests)]

    i = 0
    while i < cfg.n_requests or sched.pending:
        now = clock.now() - t0
        while i < cfg.n_requests and arrivals[i] <= now:
            sched.submit(pending[i])
            i += 1
        batch = sched.schedule()
        if not batch:
            if sched.wait_for_progress():
                continue
            if i < cfg.n_requests:       # idle until the next arrival
                clock.sleep(max(1e-6, arrivals[i] - (clock.now() - t0)))
                continue
            break                        # queue drained, nothing in flight
        for req in batch:
            sid = req.session
            hit, slots = arena.probe(req.page_keys, count=False)
            if not hit.all():
                # evicted between scheduling and execution (sync staging for
                # a later batch member can displace an earlier member's
                # page); the request stays queued and is retried next round
                req.state = "queued"
                continue
            pages = arena.gather(slots)["state"]
            pos = torch.tensor(req.meta["pos"], dtype=torch.int32)
            tw = time.perf_counter()
            _, pages2, aux2 = step(pages, session_aux[sid], one, pos)
            sync()
            clock.advance(time.perf_counter() - tw)
            arena.stage(slots, {"state": pages2})
            session_aux[sid] = aux2
            req.meta["pos"] += 1
            sched.complete_token(req, dirty_keys=req.page_keys)

    sched.drain_dirty()
    out = sched.stats()
    out["n_pages_per_session"] = pager.n_pages
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--sessions", type=int, default=24)
    ap.add_argument("--rate", type=float, default=400.0)
    ap.add_argument("--modes", default="sync,async,prefetch")
    ap.add_argument("--wall-clock", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    modes = args.modes.split(",")
    bad = [m for m in modes if m not in ("sync", "async", "prefetch")]
    if bad:
        ap.error(f"unknown mode(s) {bad}; choose from sync,async,prefetch")
    cfg = ServeConfig(arch=args.arch, n_requests=args.requests,
                      n_sessions=args.sessions, arrival_rate=args.rate,
                      wall_clock=args.wall_clock)
    res = {m: run_serving(cfg, m, device=args.device) for m in modes}
    for m, r in res.items():
        print(f"[serve] {m:8s} ttft p50={r['ttft_p50']*1e3:7.2f}ms "
              f"p99={r['ttft_p99']*1e3:7.2f}ms "
              f"hit={r['arena_hit_rate']:.2f} "
              f"overlap={r['staging_overlap']:.2f} "
              f"wb={r['store_writebacks']}")
    if "sync" in res and "prefetch" in res:
        print(f"[serve] prefetch TTFT speedup "
              f"p50 {res['sync']['ttft_p50']/res['prefetch']['ttft_p50']:.2f}x"
              f", p99 "
              f"{res['sync']['ttft_p99']/res['prefetch']['ttft_p99']:.2f}x")


if __name__ == "__main__":
    main()
