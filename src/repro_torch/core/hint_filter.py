# Copy of repro/core/hint_filter.py; differs only in `classify_batch`, which keeps
# its sketch on the `device` argument's card (tests/test_torch_isolation.py).
"""Selective hint admission for lookahead operators (DESIGN.md §13).

Every lookahead used to run one fixed rule: suppress the hint iff the
CMS classifies the key hot (paper §IV-B — hot keys are presumed
cache-resident).  This module generalises that into a per-subtask
``HintFilter`` with three modes:

  * ``all`` — admit everything (the ablation baseline; the CMS still
    counts so estimates stay comparable across modes).
  * ``hot`` — the legacy rule, bit-identical to the old inline
    ``update_and_classify`` call (the repo-wide default: existing
    benchmarks and their gates keep their behaviour).
  * ``selective`` — layered admission (decision table in §13):

      1. *residency* — a key hinted within ``resident_ttl`` was staged
         moments ago and is still resident or in flight; re-hinting is a
         duplicate (the PrefetchingManager would only renew it).  Only
         applied when the CMS estimate is >= ``resident_min_est``: a
         recently-hinted COLD key may already have been evicted (its
         staged entry loses every capacity fight), so "recently hinted"
         implies "still resident" only for keys hot enough to win
         renewals — suppressing below that estimate trades misses for
         saved duplicates at a bad rate.
      2. *cold* — CMS estimate <= ``cold_threshold``: the key is too
         cold for its staged entry to survive until a second access;
         under cache pressure such stagings end ``wasted``.  Off by
         default (0): suppressing first-occurrence keys trades recall
         for precision and must be an explicit choice.
      3. *budget* — a token bucket of ``budget_per_s`` admissions;
         when the bucket is dry only keys with estimate >=
         ``priority_threshold`` pass (hot-key prioritisation under
         hint-channel saturation).  Off by default (0 = unlimited).

Frequency vs identity: ``admit(key, now, freq_key=...)`` separates the
key being hinted (a ``WindowKey`` pane, say) from the key whose
FREQUENCY predicts its future (the pane's base key, stable across
windows).  ``hot`` mode ignores ``freq_key`` — the legacy rule counted
the full pane key, so suppression reset each window, and that behaviour
is preserved exactly.

Speculation (§13): the filter also decides which keys are worth hinting
*before* they appear upstream — ``speculate_ok`` gates next-pane window
pre-hints and join-partner frontier hints on the frequency estimate, and
``note_emit`` marks speculated keys resident so the later data-driven
hint is suppressed as a correct duplicate.

``classify_batch`` is the device twin: it feeds a key batch through the
``cms_sketch`` Pallas kernel (its own multiply-shift hashes and counter
state — same SEMANTICS as the host sketch, not the same hash values; see
repro/kernels/cms_sketch).  The tuple-at-a-time engine stays on the host
path; the batched path serves the device-resident fused pipeline and is
validated against the host semantics in tests.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.cms import CountMinFilter

MODES = ("all", "hot", "selective")

# admission verdicts (counter keys; "emitted" is the admit outcome)
EMIT = "emitted"
SUPPRESS_HOT = "suppressed_hot"
SUPPRESS_RESIDENT = "suppressed_resident"
SUPPRESS_COLD = "suppressed_cold"
SUPPRESS_BUDGET = "suppressed_budget"


class HintFilter:
    def __init__(self, mode: str = "hot",
                 cms_conf: Optional[dict] = None,
                 resident_ttl: float = 0.050,
                 resident_min_est: int = 0,
                 cold_threshold: int = 0,
                 budget_per_s: float = 0.0,
                 priority_threshold: Optional[int] = None,
                 speculative: bool = False,
                 spec_width: int = 2,
                 spec_min_est: Optional[int] = None,
                 sweep_every: int = 4096,
                 device: str = "cuda"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.mode = mode
        self.cms = CountMinFilter(**(cms_conf or {}))
        self.resident_ttl = float(resident_ttl)
        self.resident_min_est = int(resident_min_est)
        self.cold_threshold = int(cold_threshold)
        self.budget_per_s = float(budget_per_s)
        self.priority_threshold = int(
            self.cms.threshold if priority_threshold is None
            else priority_threshold)
        self.speculative = bool(speculative)
        self.spec_width = int(spec_width)
        # a key is worth speculating on once its frequency estimate says
        # it is trending hot (half the hot threshold by default)
        self.spec_min_est = int(
            max(1, self.cms.threshold // 2) if spec_min_est is None
            else spec_min_est)
        self.counters: Dict[str, int] = {
            EMIT: 0, SUPPRESS_HOT: 0, SUPPRESS_RESIDENT: 0,
            SUPPRESS_COLD: 0, SUPPRESS_BUDGET: 0}
        self.last_verdict = EMIT
        # residency model: key -> last admit time, swept lazily
        self._last_emit: Dict[Any, float] = {}
        self._sweep_every = int(sweep_every)
        self._since_sweep = 0
        # token bucket (admissions); 20 ms of burst headroom
        self._tokens = max(1.0, self.budget_per_s * 0.020)
        self._bucket_cap = self._tokens
        self._last_refill = 0.0
        # device-twin state for classify_batch, built lazily on first use
        # on ``device``
        self.device = device
        self._dev = None

    # -------------------------------------------------------------- admission
    def admit(self, key: Any, now: float, freq_key: Any = None) -> bool:
        """One hint-extraction decision; True = emit the hint.  The CMS
        counts on every call in every mode, so switching modes mid-run
        (or comparing modes across runs) keeps the frequency state
        comparable."""
        if self.mode == "hot":
            # legacy rule, counter-for-counter identical to the old
            # inline path (freq_key deliberately ignored — see module
            # docstring)
            if self.cms.update_and_classify(key):
                self.counters[SUPPRESS_HOT] += 1
                self.last_verdict = SUPPRESS_HOT
                return False
            self.counters[EMIT] += 1
            self.last_verdict = EMIT
            return True
        est, _hot = self.cms.update(key if freq_key is None else freq_key)
        if self.mode == "all":
            self.counters[EMIT] += 1
            self.last_verdict = EMIT
            return True
        # selective: residency -> cold -> budget
        if est >= self.resident_min_est:
            last = self._last_emit.get(key)
            if last is not None and now - last < self.resident_ttl:
                self.counters[SUPPRESS_RESIDENT] += 1
                self.last_verdict = SUPPRESS_RESIDENT
                return False
        if est <= self.cold_threshold:
            self.counters[SUPPRESS_COLD] += 1
            self.last_verdict = SUPPRESS_COLD
            return False
        if self.budget_per_s > 0:
            self._refill(now)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
            elif est < self.priority_threshold:
                # bucket dry: only hot-key hints pass (prioritisation
                # under hint-channel saturation)
                self.counters[SUPPRESS_BUDGET] += 1
                self.last_verdict = SUPPRESS_BUDGET
                return False
        self.counters[EMIT] += 1
        self.last_verdict = EMIT
        self.note_emit(key, now)
        return True

    def _refill(self, now: float) -> None:
        dt = now - self._last_refill
        self._last_refill = now
        if dt > 0:
            self._tokens = min(self._bucket_cap,
                               self._tokens + dt * self.budget_per_s)

    def note_emit(self, key: Any, now: float) -> None:
        """Record that a hint for ``key`` went out at ``now`` (also
        called for speculative hints, so the later data-driven hint for
        the same key is suppressed as resident — a correct duplicate)."""
        self._last_emit[key] = now
        self._since_sweep += 1
        if self._since_sweep >= self._sweep_every:
            self._since_sweep = 0
            cut = now - self.resident_ttl
            self._last_emit = {k: t for k, t in self._last_emit.items()
                               if t >= cut}

    # ------------------------------------------------------------ speculation
    def speculate_ok(self, freq_key: Any) -> bool:
        """Is ``freq_key`` hot enough to justify a speculative hint for
        a key PREDICTED from it (next window pane, next join partner)?"""
        return (self.speculative
                and self.cms.estimate(freq_key) >= self.spec_min_est)

    # ---------------------------------------------------------------- rollup
    def metrics_block(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"mode": self.mode}
        out.update(self.counters)
        return out

    def reset(self) -> None:
        """Crash semantics (DESIGN.md §7): filter state is soft —
        frequency counters, residency map, and bucket all re-learn."""
        self.cms.reset()
        self._last_emit.clear()
        self._since_sweep = 0
        self._tokens = self._bucket_cap
        self._dev = None

    # ------------------------------------------------------------ device twin
    def classify_batch(self, keys):
        """Batched hot/cold classification through the ``cms_sketch``
        kernel on ``self.device`` (its plain version on the CPU).
        Maintains a SEPARATE counter/hash state from the host sketch — the
        two share semantics, not hash values — and applies the same aging
        rule (halve every ``aging_interval`` updates).  The counters stay
        on the device between calls; a CUDA filter without a CUDA device
        raises here.  Returns a bool[B] hot mask on the host (one copy of
        B bytes from the device)."""
        import numpy as np
        import torch
        from repro_torch.kernels.cms_sketch.ops import cms_update_and_classify
        cms = self.cms
        if self._dev is None:
            rng = np.random.RandomState(1)
            on = lambda x: torch.from_numpy(  # noqa: E731
                x.astype(np.int64)).to(self.device)
            self._dev = {
                "counters": torch.zeros((cms.d, cms.w), dtype=torch.int32,
                                        device=self.device),
                "a": on(rng.randint(1, 2 ** 31 - 1, size=cms.d)
                        .astype(np.uint32) | 1),
                "b": on(rng.randint(0, 2 ** 31 - 1,
                                    size=cms.d).astype(np.uint32)),
                "since_aging": 0,
            }
        dev = self._dev
        keys = torch.as_tensor(np.asarray(keys, dtype=np.int32),
                               device=dev["counters"].device)
        counters, hot = cms_update_and_classify(
            keys, dev["counters"], dev["a"], dev["b"],
            threshold=cms.threshold, max_count=cms.max_count)
        dev["since_aging"] += int(keys.shape[0])
        if dev["since_aging"] >= cms.aging_interval:
            counters = counters >> 1
            dev["since_aging"] = 0
        dev["counters"] = counters
        return hot.cpu().numpy()
