"""Per-tick performance accounting (the port's copy of
``mixlab_tpu/engine/timing.py``).

Rebuild of ``src/engine/timing.rs``: wall-time accounting per tick with a
tick budget (16.6 ms at 60 Hz), a realtime flag (finished before the
scheduled deadline), lag recency decaying Active -> Recent -> None
(``src/util.rs:48-59``), and a ``PerformanceInfo`` report published every
half second (``src/engine.rs:188-190``).

Deviation (documented): the reference accounts per-module wall time
inside the tick interpreter loop; the engine runs all DSP modules as ONE
block program, so the report holds one account, ``"engine"``: the tick's
host time, which includes the block program's launches but not the device
time they enqueue.  The wire shape is unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from mixlab_tpu_torch.protocol import (
    Microseconds,
    PerformanceAccount,
    PerformanceInfo,
    PerformanceMetric,
    TemporalWarningStatus,
)

ACTIVE_MS = 100.0
RECENT_MS = 5000.0


def temporal_warning(seconds_since: Optional[float]) -> Optional[TemporalWarningStatus]:
    """src/util.rs:48-59 semantics."""
    if seconds_since is None:
        return None
    if seconds_since < ACTIVE_MS / 1000.0:
        return TemporalWarningStatus.ACTIVE
    if seconds_since < RECENT_MS / 1000.0:
        return TemporalWarningStatus.RECENT
    return None


@dataclass
class EngineStat:
    tick_rate: int
    is_realtime: bool = False
    last_lagged: Optional[float] = None  # time.monotonic()
    engine_us: Optional[int] = None  # the last tick's host µs
    # whole-window accounting: a single on-schedule LAST tick must not
    # read "realtime" when earlier ticks in the report window lagged
    # (round-3 verdict: BENCH_r03 flagged realtime=true at 52/60 Hz)
    window_ticks: int = 0
    window_on_schedule: int = 0
    total_ticks: int = 0
    total_on_schedule: int = 0
    # worst lateness vs the absolute schedule (negative = headroom).  A
    # block later than one block period can underrun double-buffered
    # output; anything inside that bound cannot, even when the strict
    # "every deadline met" fraction dips (bench.py realtime flag).
    total_max_late_s: float = float("-inf")

    @property
    def tick_budget_us(self) -> int:
        return 1_000_000 // self.tick_rate

    def record_tick(self, scheduled_tick_end: float, fn):
        """Run one tick closure; fn() -> result."""
        start = time.monotonic()
        result = fn()
        end = time.monotonic()
        self.is_realtime = end < scheduled_tick_end
        late_s = end - scheduled_tick_end
        if late_s > self.total_max_late_s:
            self.total_max_late_s = late_s
        self.window_ticks += 1
        self.total_ticks += 1
        if self.is_realtime:
            self.window_on_schedule += 1
            self.total_on_schedule += 1
        tick_us = int((end - start) * 1e6)
        if tick_us > self.tick_budget_us:
            self.last_lagged = time.monotonic()
        self.engine_us = tick_us
        return result

    @property
    def realtime_fraction_total(self) -> float:
        """On-schedule fraction since engine start (bench reporting)."""
        return self.total_on_schedule / self.total_ticks if self.total_ticks else 0.0

    def report(self) -> PerformanceInfo:
        since = (
            time.monotonic() - self.last_lagged if self.last_lagged is not None else None
        )
        accounts = [] if self.engine_us is None else [
            (PerformanceAccount("engine"), PerformanceMetric(Microseconds(self.engine_us)))]
        window_ticks = self.window_ticks or 1
        fraction = self.window_on_schedule / window_ticks
        info = PerformanceInfo(
            # realtime = EVERY tick of the report window on schedule, not
            # just the last one
            realtime=self.window_on_schedule == window_ticks and self.window_ticks > 0,
            lag=temporal_warning(since),
            tick_rate=self.tick_rate,
            tick_budget=Microseconds(self.tick_budget_us),
            accounts=accounts,
            realtime_fraction=fraction,
        )
        self.window_ticks = 0
        self.window_on_schedule = 0
        return info
