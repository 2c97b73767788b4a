"""Realtime pacing for decode threads (rebuild of ``src/throttle.rs``).

The port's copy of ``mixlab_tpu/io_host/throttle.py``.

``AudioThrottle`` sleeps so PCM flows at the configured sample rate;
``MediaThrottle`` sleeps until a target MediaTime.  Both anchor to the wall
clock at first use so pacing is drift-free.
"""

from __future__ import annotations

import time
from typing import Optional

from mixlab_tpu_torch.utils.mtime import MediaTime


class AudioThrottle:
    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self.started: Optional[float] = None
        self.samples_sent = 0

    def send_samples(self, sample_count: int):
        if self.started is None:
            self.started = time.monotonic()
        elapsed = self.samples_sent / self.sample_rate
        sleep_until = self.started + elapsed
        now = time.monotonic()
        if now < sleep_until:
            time.sleep(sleep_until - now)
        self.samples_sent += sample_count


class MediaThrottle:
    def __init__(self):
        self.started: Optional[float] = None

    def wait_until(self, t: MediaTime):
        if self.started is None:
            self.started = time.monotonic()
        elapsed = t.round_to_base(1_000_000) / 1e6
        sleep_until = self.started + elapsed
        now = time.monotonic()
        if now < sleep_until:
            time.sleep(sleep_until - now)
