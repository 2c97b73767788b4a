"""The plain reference's allowance for the FmSine's float32 phase: the
configuration states the phase's precision, not its order of rounding, so
the phase rounded in float32 in either of two orders (each step apart, or
the product and the sum fused) lies within the allowance at session times
far beyond a window's, while a bfloat16 output of the FmSine does not."""

import numpy as np
import pytest

from portbench import judge
from portbench.reference import audio as ref

SR, SPT = 48000, 800


def _fm32(t, x32, lo, hi, fused):
    """The FmSine with its phase in float32, in the port's order."""
    f32 = np.float32
    amp = (hi - lo) / 2.0
    mid = lo + amp
    tick = t // SPT
    i = (t - tick * SPT).astype(np.float32)
    tsamp = (tick * SPT).astype(np.float64)
    carrier = np.mod(tsamp * (mid / SR), 1.0).astype(np.float32) + i * f32(mid / SR)
    tsec = (tsamp / SR).astype(np.float32) + i * f32(1.0 / SR)
    fx = f32(amp) * x32
    if fused:
        n = (carrier.astype(np.float64) + fx.astype(np.float64) * tsec).astype(np.float32)
    else:
        n = carrier + fx * tsec
    return np.sin((n * f32(2.0 * np.pi)).astype(np.float64))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("seconds", [0.0, 20.0, 175.0, 700.0])
def test_a_float32_phase_in_any_order_lies_within_the_allowance(seconds, fused):
    rng = np.random.default_rng([int(seconds), int(fused)])
    t = np.arange(int(seconds * SR), int(seconds * SR) + 4 * 12800, dtype=np.int64)
    x32 = ref.envelope_open(t, SR, 25.0, 500.0, 0.8).astype(np.float32)
    for _ in range(3):
        lo, hi = 440.0 + 40.0 * rng.random(), 880.0 - 40.0 * rng.random()
        want, allow = ref.fm_sine(t, x32, lo, hi, SR, SPT)
        got = _fm32(t, x32, lo, hi, fused)
        assert judge.gap_beyond(got[:, None], want[:, None], allow) == 0.0


def test_a_bfloat16_fm_output_exceeds_the_allowance_early_in_a_session():
    t = np.arange(SR, SR + 12800, dtype=np.int64)
    x32 = ref.envelope_open(t, SR, 25.0, 500.0, 0.8).astype(np.float32)
    want, allow = ref.fm_sine(t, x32, 450.0, 870.0, SR, SPT)
    got = ref.bf16(want.astype(np.float32))
    assert judge.gap_beyond(got[:, None], want[:, None], allow, scale=1.0) * 32767 > 16


def test_session_monitor_refuses_an_unknown_precision():
    with pytest.raises(ValueError):
        ref.session_monitor({"env": (25.0, 500.0, 0.8, 200.0), "eq_db": (0, 0, 0)}, SR, SPT,
                            [(0, 8)], quant="fp8")


def test_the_side_gap_skips_samples_that_the_allowance_could_clip():
    """A signal common to both channels, off by its allowance in the
    program, clips the one channel and not the other near full scale: the
    side gap reads only the samples that no such shift can clip."""
    want = np.array([[0.995, 0.2], [0.5, -0.3]])
    allow = np.array([0.01, 0.01])
    got = np.clip(want + 0.01, -1.0, 1.0)
    assert judge.side_gap(got, want, clip=0.999) == pytest.approx(0.005)
    assert judge.side_gap(got, want, clip=0.999, allow=allow) == pytest.approx(0.0)
