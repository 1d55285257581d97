"""Message types flowing through the dataflow engine."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional


@dataclass
class Tuple_:
    ts: float                 # event time (set at the source)
    key: Any                  # partitioning / state-access key (may be None)
    payload: Any = None
    size: int = 200           # serialized bytes (network accounting)
    ingest_t: float = 0.0     # processing time entering the pipeline
    trace: Any = None         # sampled critical-path span (obs.trace), or
    #                           None on the unsampled fast path — not
    #                           serialized, never crosses a checkpoint


class WindowKey(NamedTuple):
    """State-access key of one window pane: ``(base key, window id)``.

    Routing (``hash_partition``, ``ShardPlane.shard_of``) unwraps ``base``
    so every pane of a key — and every hint for it — lands on the subtask
    that owns the key itself (DESIGN.md §10).
    """
    base: Any
    wid: int


@dataclass
class Hint:
    """Keyed-prefetching hint (DESIGN.md §3, §10).

    ``ts`` is the PREDICTED ACCESS TIMESTAMP of ``key`` — it must be in
    the same clock domain the consuming cache orders entries by, and that
    domain differs per plane:

      * streaming engine: EVENT time.  Per-tuple lookaheads use the
        tuple's event timestamp (the access happens when the tuple
        reaches the stateful operator); windowed lookaheads use the
        WINDOW-FIRE DEADLINE (window end), the exact event time at which
        the pane is read on watermark advance.
      * serving scheduler: PROCESSING (wall/sim) time — the predicted
        decode-start time of the session (DESIGN.md §6).

    The two domains never mix inside one TAC: each stateful operator /
    arena orders by exactly one clock.  ``PrefetchingManager.on_hint``
    names the parameter ``access_ts`` for this reason.
    """
    key: Any
    ts: float                 # predicted access timestamp (see above)
    origin: str = ""          # lookahead operator that emitted the hint
    size: int = 24            # key + timestamp on the wire
    emit_t: float = 0.0       # processing time the lookahead emitted it
    #                           (hint-channel delay telemetry, DESIGN.md §12)


@dataclass
class Marker:
    marker_id: int
    origin: str = "controller"
    lookahead_id: Optional[str] = None
    size: int = 16


@dataclass
class Watermark:
    """Event-time watermark: a promise that no tuple with ``ts`` below
    this will follow on the same input (modulo allowed lateness).
    ``origin`` identifies the (channel, src subtask) pair so operators can
    take the min across ALL their inputs (DESIGN.md §10)."""
    ts: float
    origin: Any = None
    size: int = 16


@dataclass
class CheckpointBarrier:
    """Epoch-numbered checkpoint barrier (DESIGN.md §7).

    Injected at sources by the ``CheckpointCoordinator``
    (``streaming/recovery.py``) and broadcast downstream on every data
    edge.  Like watermarks, each copy is tagged with the (channel, src
    subtask) input it travelled on so a multi-input operator can ALIGN:
    it buffers post-barrier traffic from inputs whose barrier already
    arrived and snapshots only once every input reported (Chandy-Lamport
    via Flink-style aligned barriers)."""
    checkpoint_id: int        # epoch number
    origin: Any = None        # (channel id, src subtask) — set per copy
    size: int = 16
