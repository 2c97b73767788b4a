"""Engine configuration (the port's copy of ``mixlab_tpu/engine/config.py``).

The reference hard-codes 44.1 kHz / 60 ticks/s / 735 samples per tick
(``src/engine.rs:52-55``).  The sample rate is a runtime parameter (44_100
is the render CLI's default, 48_000 the benchmark configs' rate) and a block
size says how many ticks one call of the block program renders.
"""

from __future__ import annotations

from dataclasses import dataclass

CHANNELS = 2  # src/engine.rs:52
TICKS_PER_SECOND = 60  # src/engine.rs:54


@dataclass(frozen=True)
class EngineConfig:
    sample_rate: int = 44_100
    ticks_per_second: int = TICKS_PER_SECOND
    channels: int = CHANNELS
    # device math is f32 (the JAX package's field, kept for equal configs)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.sample_rate % self.ticks_per_second != 0:
            raise ValueError(
                f"sample_rate {self.sample_rate} not divisible by "
                f"ticks_per_second {self.ticks_per_second}"
            )

    @property
    def samples_per_tick(self) -> int:
        return self.sample_rate // self.ticks_per_second

    @property
    def tick_budget_us(self) -> int:
        # src/engine/timing.rs:9
        return 1_000_000 // self.ticks_per_second


@dataclass(frozen=True)
class BlockSpec:
    """Static shape of one block program call: ``n_ticks`` engine ticks."""

    n_ticks: int = 1

    def n_samples(self, cfg: EngineConfig) -> int:
        return self.n_ticks * cfg.samples_per_tick


DEFAULT_CONFIG = EngineConfig()
