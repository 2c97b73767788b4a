"""Plain NumPy reference of the flagship graph's Monitor audio, one session
at a time, with its DSP state carried from sample 0.

A frozen copy of ``tests/oracle.py`` (the reference Rust modules in float64)
composed as ``tests/test_whole_graph_oracle.py`` composes the flagship
16-module graph, made fast enough for a benchmark run: the Trigger is open
from sample 0, so the Envelope is a closed form of time; the oscillators are
closed forms of time; the EqThree's one-pole stages run as ``lfilter`` over
the whole history in chunks, their poles carried; and every session takes
its own continuous params (a dict, ``session_params``).

The configuration states the FmSine's modulation phase ``f_amp * x * t``
in float32 (``precision.fm_phase``), in no particular order of rounding.
The reference computes the phase in float64 and gives, a sample, the gap
that such a phase may open (``fm_sine``'s allowance): a float32 phase lies within
``PHASE_ULPS`` float32 ulps of each of its terms (the phase, the carrier,
the time, the envelope times ``f_amp``), and its sine moves by at most
``|cos| * d + d * d / 2`` for a phase off by ``d``.  The check takes that
allowance off each sample's gap; where the cosine is small it allows
little, so a gap downstream of the phase still shows.

``quant`` is a control: ``"bf16"`` rounds every module's output signal to
bfloat16 (round to nearest even), the step below the float32 the
configuration states; ``"bf16-after-env"`` rounds every output but the
envelope's, so the FmSine's phase keeps its float32 input and only the
signals downstream of the envelope lose their bits.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import lfilter

VSA = 1.0 / 4294967295.0  # eq_three.rs:11
EQ_LO_HZ, EQ_HI_HZ = 420.0, 2700.0  # eq_three.rs:8-9
CHUNK = 1 << 20  # samples of EQ history a pass


def bf16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


QUANTS = (None, "bf16", "bf16-after-env")


def _q(x, quant: Optional[str], envelope: bool = False) -> np.ndarray:
    """A module's output signal in its stated storage: float32, or the
    control's bfloat16."""
    x32 = np.asarray(x, dtype=np.float32)
    return bf16(x32) if quant == "bf16" or (quant and not envelope) else x32


def envelope_open(t: np.ndarray, sr: int, attack_ms: float, decay_ms: float,
                  sustain: float) -> np.ndarray:
    """oracle.envelope with the gate at 1.0 from sample 0: TriggerOn{on: 0}
    for every t (envelope.rs:37-51), float64."""
    ms_on = t.astype(np.float64) / sr * 1000.0
    attack_amp = ms_on / attack_ms
    decay_amp = 1.0 - np.clip((ms_on - attack_ms) / decay_ms, 0.0, 1.0)
    return np.where(ms_on < attack_ms, attack_amp, sustain + (1.0 - sustain) * decay_amp)


def oscillator_sine(t: np.ndarray, freq: float, sr: int) -> np.ndarray:
    """oracle.oscillator, sine: sin(2 pi t freq / sr), the phase wrapped to
    one cycle in float64 first."""
    ph = np.mod(t.astype(np.float64) * (freq / sr), 1.0)
    return np.sin(ph * 2.0 * np.pi)


PHASE_ULPS = 2.0  # float32 ulps a term of the FmSine's phase may be off


def ulp32(v: np.ndarray) -> np.ndarray:
    """The float32 ulp at each value of ``v``, as float64."""
    return np.spacing(np.abs(np.asarray(v, dtype=np.float64)).astype(np.float32)).astype(np.float64)


def fm_sine(t: np.ndarray, x: np.ndarray, freq_lo: float, freq_hi: float, sr: int,
            spt: int) -> Tuple[np.ndarray, np.ndarray]:
    """oracle.fm_sine in float64, sin(2 pi (t f_mid / sr + f_amp x t / sr))
    with the carrier's phase wrapped to one cycle first, and a sample's
    allowance for the configuration's float32 phase (module docstring);
    ``x`` the control input as the envelope's stored output.  A float32
    phase may carry the carrier unwrapped through a tick of ``spt``
    samples, so its ulps are taken at that many more cycles."""
    x = np.asarray(x, dtype=np.float64)
    freq_amp = (freq_hi - freq_lo) / 2.0
    freq_mid = freq_lo + freq_amp
    tf = t.astype(np.float64)
    carrier = np.mod(tf * (freq_mid / sr), 1.0)
    tsec = tf / sr
    mod = (freq_amp * x) * tsec
    n = carrier + mod
    theta = 2.0 * np.pi * n
    span = 1.0 + freq_mid * spt / sr
    d = 2.0 * np.pi * PHASE_ULPS * (ulp32(np.abs(n) + span) + ulp32(carrier + span) + ulp32(mod)
                                    + np.abs(freq_amp * x) * ulp32(tsec)
                                    + np.abs(freq_amp * tsec) * ulp32(x))
    return np.sin(theta), np.abs(np.cos(theta)) * d + d * d / 2.0


def _pole(u: np.ndarray, f: float, y_prev: float) -> np.ndarray:
    """y[n] = y[n-1] + f (u'[n] - y[n-1]) written as y[n] = (1-f) y[n-1] + u[n]
    (``u`` already holds the drive), from ``y_prev``."""
    y, _ = lfilter([1.0], [1.0, -(1.0 - f)], u, zi=[(1.0 - f) * y_prev])
    return y


class EqThree:
    """oracle.eq_three in float64 (EqThree::run_tick), its four poles per
    band and three samples of history carried across calls."""

    def __init__(self, sr: int, gains_db: Tuple[float, float, float]):
        self.f = (2.0 * math.sin(math.pi * EQ_LO_HZ / sr), 2.0 * math.sin(math.pi * EQ_HI_HZ / sr))
        self.g = tuple(10.0 ** (g / 20.0) for g in gains_db)
        self.poles = np.zeros((4, 2))  # [stage][band], band 0 = lo, 1 = hi
        self.hist = np.zeros(3)  # oldest first

    def run(self, x: np.ndarray, keep: bool = True) -> Optional[np.ndarray]:
        x = np.asarray(x, dtype=np.float64)
        ys = []
        for band, f in enumerate(self.f):
            y = _pole(f * x + VSA, f, self.poles[0, band])
            self.poles[0, band] = y[-1]
            for k in range(1, 4):
                y = _pole(f * y, f, self.poles[k, band])
                self.poles[k, band] = y[-1]
            ys.append(y)
        xd = np.concatenate([self.hist, x])[: len(x)]
        self.hist = np.concatenate([self.hist, x])[-3:]
        if not keep:
            return None
        lo, hi_lp = ys
        hi = xd - hi_lp
        mid = xd - (hi + lo)
        return lo * self.g[0] + mid * self.g[1] + hi * self.g[2]


def session_monitor(sp: Dict, sr: int, spt: int, ranges: Sequence[Tuple[int, int]],
                    quant: Optional[str] = None, t_start: int = 0,
                    t_state: Optional[int] = None):
    """The Monitor's stereo audio of one session over each sample range
    ``[lo, hi)`` of ``ranges`` (sorted, apart, none before ``t_start``) as
    float32 [hi - lo, 2], and its carried state at sample ``t_state`` (the
    last range's end by default): ``{"eq_poles": [4, 2], "eq_hist": [3]}``,
    with ``"fm_allow"``, each range's allowance for the FmSine's float32
    phase [hi - lo] (``fm_sine``); ``spt`` samples a tick.
    The session starts from its initial state at ``t_start``, where the open
    gate first reaches the envelope.

    ``sp``: ``osc_freq`` (4), ``amp_amplitude`` (4), ``amp_mod_depth`` (4),
    ``fm_lo``, ``fm_hi``, ``eq_db`` (3), ``env`` (attack_ms, decay_ms,
    sustain, release_ms).  The graph is the flagship's
    (``tests/test_whole_graph_oracle.py``): trigger (open) -> envelope ->
    four oscillator / amplifier chains and the FmSine; amplifier 0 -> splitter
    -> EqThree (left) -> panner (with amplifier 0's right); the 8-channel
    mixer at 0 dB, fader 1: amps 0-3, fm, pan, amps 1 and 2."""
    attack, decay, sustain, _release = sp["env"]
    eq = EqThree(sr, tuple(sp["eq_db"]))

    def chains(t, n_amps=4):
        env = _q(envelope_open(t - t_start, sr, attack, decay, sustain), quant, envelope=True)
        e64 = env.astype(np.float64)
        amps = []
        for j in range(n_amps):
            osc = _q(oscillator_sine(t, sp["osc_freq"][j], sr), quant).astype(np.float64)
            md, a = sp["amp_mod_depth"][j], sp["amp_amplitude"][j]
            amps.append(_q(osc * ((1.0 - md + md * e64) * a), quant).astype(np.float64))
        return env, amps

    def advance(lo, hi):
        """The EqThree's history over [lo, hi), chunk by chunk."""
        for c in range(lo, hi, CHUNK):
            t = np.arange(c, min(c + CHUNK, hi), dtype=np.int64)
            eq.run(chains(t, n_amps=1)[1][0], keep=False)

    if quant not in QUANTS:
        raise ValueError(f"quant {quant!r} is not one of {QUANTS}")
    out, allow = [], []
    at = t_start
    for lo, hi in ranges:
        if lo < at:
            raise ValueError(f"range [{lo}, {hi}) is not after sample {at}")
        advance(at, lo)
        t = np.arange(lo, hi, dtype=np.int64)
        env, amps = chains(t)
        fm, fm_allow = fm_sine(t, env, sp["fm_lo"], sp["fm_hi"], sr, spt)
        fm = _q(fm, quant).astype(np.float64)
        eq_l = _q(eq.run(amps[0]), quant).astype(np.float64)
        left = amps[0] + amps[1] + amps[2] + amps[3] + fm + eq_l + amps[1] + amps[2]
        right = amps[0] + amps[1] + amps[2] + amps[3] + fm + amps[0] + amps[1] + amps[2]
        out.append(np.stack([_q(left, quant), _q(right, quant)], axis=1))
        allow.append(fm_allow)
        at = hi
    if t_state is not None:
        advance(at, t_state)
    return out, {"eq_poles": eq.poles.copy(), "eq_hist": eq.hist.copy(), "fm_allow": allow}


def to_i16(x: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] to i16 PCM: clipped, scaled by 32767 in float32 and
    truncated toward zero (the reference's PCM wire format)."""
    x32 = np.clip(np.asarray(x, dtype=np.float32), np.float32(-1.0), np.float32(1.0))
    return (x32 * np.float32(32767.0)).astype(np.int16)
