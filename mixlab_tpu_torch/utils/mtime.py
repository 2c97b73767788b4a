"""Exact rational media time algebra (the port's copy of
``mixlab_tpu/utils/mtime.py``).

Rebuild of the reference's rational timestamp layer
(``util/src/time.rs:10-152`` in haileys/mixlab): ``MediaTime`` /
``MediaDuration`` are exact rational instants/durations, ``TimeBase`` scales
integer codec timestamps into rational time.  Host-side only — on device,
time is carried as integer sample counts.

Python's ``fractions.Fraction`` gives arbitrary precision, strictly more
exact than the reference's ``Rational64``.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Union


def _frac(numer: int, denom: int = 1) -> Fraction:
    return Fraction(numer, denom)


@dataclass(frozen=True, order=True)
class MediaDuration:
    """Exact rational duration in seconds (``util/src/time.rs:78-113``)."""

    frac: Fraction

    @staticmethod
    def new(numer: int, denom: int = 1) -> "MediaDuration":
        return MediaDuration(_frac(numer, denom))

    @staticmethod
    def zero() -> "MediaDuration":
        return MediaDuration(Fraction(0))

    def is_zero(self) -> bool:
        return self.frac == 0

    def round_to_base(self, base: int) -> int:
        """Scale to integer units of ``1/base`` seconds, truncating toward zero
        (matches Rational64::to_integer semantics: ``time.rs:86-88``)."""
        scaled = self.frac * base
        return int(scaled)  # Fraction.__int__ truncates toward zero, like Rust

    def as_fraction(self) -> Fraction:
        return self.frac

    def decimal(self) -> str:
        micros = self.round_to_base(1_000_000)
        return f"{micros / 1_000_000.0:.6f}"

    def __add__(self, other: "MediaDuration") -> "MediaDuration":
        return MediaDuration(self.frac + other.frac)

    def __sub__(self, other: "MediaDuration") -> "MediaDuration":
        return MediaDuration(self.frac - other.frac)

    def __neg__(self) -> "MediaDuration":
        return MediaDuration(-self.frac)


@dataclass(frozen=True, order=True)
class MediaTime:
    """Exact rational instant in seconds (``util/src/time.rs:10-76``)."""

    frac: Fraction

    @staticmethod
    def new(numer: int, denom: int = 1) -> "MediaTime":
        return MediaTime(_frac(numer, denom))

    @staticmethod
    def zero() -> "MediaTime":
        return MediaTime(Fraction(0))

    def is_zero(self) -> bool:
        return self.frac == 0

    def round_to_base(self, base: int) -> int:
        scaled = self.frac * base
        return int(scaled)

    def add_epoch(self, epoch: "MediaTime") -> "MediaTime":
        return MediaTime(self.frac + epoch.frac)

    def remove_epoch(self, epoch: "MediaTime") -> "MediaTime":
        return MediaTime(self.frac - epoch.frac)

    def as_fraction(self) -> Fraction:
        return self.frac

    def decimal(self) -> str:
        micros = self.round_to_base(1_000_000)
        return f"{micros / 1_000_000.0:.6f}"

    def __add__(self, other: MediaDuration) -> "MediaTime":
        if not isinstance(other, MediaDuration):
            return NotImplemented
        return MediaTime(self.frac + other.frac)

    def __sub__(
        self, other: Union["MediaTime", MediaDuration]
    ) -> Union["MediaTime", MediaDuration]:
        # time - time = duration; time - duration = time (time.rs:48-76)
        if isinstance(other, MediaTime):
            return MediaDuration(self.frac - other.frac)
        if isinstance(other, MediaDuration):
            return MediaTime(self.frac - other.frac)
        return NotImplemented


@dataclass(frozen=True, order=True)
class TimeBase:
    """Rational unit scale for integer codec timestamps
    (``util/src/time.rs:116-152``)."""

    frac: Fraction

    @staticmethod
    def new(numer: int, denom: int) -> "TimeBase":
        return TimeBase(_frac(numer, denom))

    def scale_timestamp(self, timestamp: int) -> MediaTime:
        return MediaTime(timestamp * self.frac)

    def unscale_timestamp(self, time: MediaTime) -> int:
        return int(time.frac / self.frac)

    def scale_duration(self, duration: int) -> MediaDuration:
        return MediaDuration(duration * self.frac)

    def as_fraction(self) -> Fraction:
        return self.frac
