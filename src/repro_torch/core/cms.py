"""Count-Min Sketch hot-key filter (paper §IV-B).

d rows x w columns of b-bit saturating counters; every ``aging_interval``
updates each counter is halved (integer right shift).  A key is HOT — and
its hint suppressed — iff ALL d touched counters are >= T.

This is the engine-side (Python/numpy) implementation used by lookahead
operators; ``repro_torch.kernels.cms_sketch`` is the TPU twin for on-device hint
extraction, validated against this oracle.
"""
from __future__ import annotations

import numpy as np

_PRIMES = (1000003, 10000019, 100000007, 1000000007, 10000000019,
           100000000003, 1000000000039, 10000000000037)


class CountMinFilter:
    def __init__(self, depth: int = 4, width: int = 10000, bits: int = 8,
                 threshold: int = 20, aging_interval: int = 1000,
                 seed: int = 0):
        assert depth <= len(_PRIMES)
        self.d = depth
        self.w = width
        self.max_count = (1 << bits) - 1
        self.threshold = threshold
        self.aging_interval = aging_interval
        self.counters = np.zeros((depth, width), dtype=np.uint32)
        rng = np.random.RandomState(seed)
        self._a = rng.randint(1, 2 ** 31 - 1, size=depth).astype(np.int64)
        self._b = rng.randint(0, 2 ** 31 - 1, size=depth).astype(np.int64)
        self._since_aging = 0
        self.memory_bytes = depth * width * (bits // 8 or 1)

        # pure-python mirrors of the hash params: the per-event path touches
        # only d counters, where python ints beat numpy dispatch ~10x
        self._ap = [int(a) for a in self._a]
        self._bp = [int(b) for b in self._b]
        self._rows_buf = [0] * depth
        self._flat = self.counters.reshape(-1)

    def _cols(self, key):
        if not isinstance(key, int):
            key = hash(key)
        w = self.w
        out = self._rows_buf
        for i in range(self.d):
            out[i] = ((self._ap[i] * key + self._bp[i])
                      % _PRIMES[i]) % w
        return out

    def reset(self) -> None:
        """Zero all counters (process-restart semantics, DESIGN.md §7:
        CMS frequency state is soft and re-learns after a crash).  The
        cached flat view aliases ``counters``, so zero in place."""
        self.counters[:] = 0
        self._since_aging = 0

    def update_and_classify(self, key: int) -> bool:
        """Count one occurrence; return True iff the key is (now) hot."""
        flat = self._flat
        w = self.w
        hot = True
        thr = self.threshold
        mx = self.max_count
        for i, c in enumerate(self._cols(key)):
            j = i * w + c
            v = flat[j] + 1
            if v <= mx:
                flat[j] = v
            if v < thr:
                hot = False
        self._since_aging += 1
        if self._since_aging >= self.aging_interval:
            self.counters >>= 1
            self._since_aging = 0
        return hot

    def update(self, key: int) -> tuple:
        """Count one occurrence; return ``(estimate, hot)`` where
        ``estimate`` is the post-update count-min estimate (min over
        rows, saturating) and ``hot`` matches ``update_and_classify``.
        The selective HintFilter (core/hint_filter.py) needs the
        estimate for its cold/priority thresholds, not just the hot bit
        — same single pass over the d touched counters."""
        flat = self._flat
        w = self.w
        thr = self.threshold
        mx = self.max_count
        est = mx + 1
        for i, c in enumerate(self._cols(key)):
            j = i * w + c
            v = flat[j] + 1
            if v <= mx:
                flat[j] = v
            else:
                v = mx
            if v < est:
                est = v
        self._since_aging += 1
        if self._since_aging >= self.aging_interval:
            self.counters >>= 1
            self._since_aging = 0
        return int(est), est >= thr

    def estimate(self, key: int) -> int:
        flat = self._flat
        return int(min(flat[i * self.w + c]
                       for i, c in enumerate(self._cols(key))))

    def is_hot(self, key: int) -> bool:
        flat = self._flat
        return all(flat[i * self.w + c] >= self.threshold
                   for i, c in enumerate(self._cols(key)))
