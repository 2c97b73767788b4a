"""Elementwise audio modules (port of ``mixlab_tpu/dsp/audio.py``).

Semantics of the reference modules:
  * Oscillator      — src/module/oscillator.rs:25-89
  * FmSine          — src/module/fm_sine.rs:37-55
  * Amplifier       — src/module/amplifier.rs:38-73
  * Mixer           — src/module/mixer.rs:46-71
  * StereoPanner    — src/module/stereo_panner.rs:30-41
  * StereoSplitter  — src/module/stereo_splitter.rs:33-48
  * Trigger         — src/module/trigger.rs:36-49

Device math is f32, in the same operation order as the JAX package.  The
oscillators keep its precision scheme: the host computes the phase at each
tick start in float64 (numpy, ``host_prepare``) and the device only adds the
small in-tick ramp ``i * delta``, so precision does not degrade with
absolute time.  A fleet computes the same bases for all its instances at
once from per-instance frequency columns (``host_columns``,
``host_prepare_columns``).

Amplifier, Mixer, StereoPanner, StereoSplitter and Trigger also run inside
the region program (``mega_spec``, ``mixlab_tpu/dsp/audio.py:223-370``);
Oscillator and FmSine have no spec on purpose, as in the JAX package: their
phase math stays outside the region, whose operands they produce.
"""

from __future__ import annotations

import numpy as np
import torch

from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.protocol import (
    AmplifierParams,
    FmSineParams,
    GateState,
    LineType,
    MixerParams,
    OscillatorParams,
    Waveform,
)
from mixlab_tpu_torch.dsp.base import (
    OP_AMP,
    OP_AMP_MOD,
    OP_FILL,
    OP_MIX,
    MegaSpec,
    ModuleDef,
    expect_mono,
    expect_stereo,
)

_TWO_PI = 2.0 * np.pi


def _frac(x: np.ndarray) -> np.ndarray:
    """The fractional part of float64 phases, in [0, 1].  For finite ``x`` it
    is ``np.mod(x, 1.0)`` bit for bit (both round the one exact value once),
    without the cost of ``fmod``, which grows with the quotient."""
    return x - np.floor(x)


# instances a pass of ``_bases``: its float64 temporaries (128 KiB at 16
# ticks) are reused from the heap and stay in cache, where arrays of a whole
# fleet are mapped and faulted in anew each block
_ROWS = 1024


def _bases(row: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``_frac(row * scale[:, None])`` cast to float32, [N, T], from the
    tick starts ``row`` [1, T] and the instances' ``scale`` [N], ``_ROWS``
    instances at a time."""
    out = np.empty((len(scale), row.shape[-1]), np.float32)
    for i in range(0, len(scale), _ROWS):
        out[i:i + _ROWS] = _frac(row * scale[i:i + _ROWS, None])
    return out


def _fm_mid(params: FmSineParams) -> float:
    """The FmSine's carrier frequency, the middle of its range."""
    return params.freq_lo + (params.freq_hi - params.freq_lo) / 2.0


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _ramp(spt: int, device) -> torch.Tensor:
    return torch.arange(spt, dtype=torch.float32, device=device)


_sin_warm = False


def _sin(x: torch.Tensor) -> torch.Tensor:
    """``torch.sin``.  On the CPU, PyTorch's first sine call in a process that
    runs on several threads at once now and then returns one thread's share
    of the tensor with errors near 1e-4; one call on a single element first,
    on the calling thread alone, prevents it.  ``tools/first_sine.py`` counts
    both in fresh processes."""
    global _sin_warm
    if not _sin_warm and x.is_cpu:
        torch.sin(torch.zeros(1))
        _sin_warm = True
    return torch.sin(x)


# waveform primitives (oscillator.rs:15-37), period-1 functions of phase n


def _sine(n):
    return _sin(n * _TWO_PI)


def _square(n):
    # sign(sine(n)) with exact zero -> +1 (is_sign_positive semantics)
    return torch.where(_sine(n) >= 0.0, 1.0, -1.0)


def _saw(n):
    return 2.0 * (n - torch.floor(0.5 + n))


def _triangle(n):
    return 2.0 * torch.abs(_saw(n)) - 1.0


class OscillatorDef(ModuleDef):
    kind = "Oscillator"

    def terminals(self, params: OscillatorParams):
        return [], [LineType.MONO.labeled("Mono"), LineType.STEREO.labeled("Stereo")]

    def prepare(self, params: OscillatorParams, cfg: EngineConfig, device):
        return {"delta": _f32(params.freq / cfg.sample_rate, device)}

    def host_prepare(self, params: OscillatorParams, t0: int, block: BlockSpec, cfg):
        # phase n = t*freq/sr in f64 at each tick start, wrapped mod 1
        # (oscillator.rs:73-77); the device adds i*delta for i < spt
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        base = _frac(ticks * spt * (params.freq / cfg.sample_rate))
        return {"base": base.astype(np.float32)}

    def host_columns(self, params_list):
        return {"freq": np.array([p.freq for p in params_list], dtype=np.float64)}

    def host_prepare_columns(self, columns, t0: int, block: BlockSpec, cfg):
        """``host_prepare`` of N instances at once, [N, T]."""
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        return {"base": _bases(ticks[None, :] * spt, columns["freq"] / cfg.sample_rate)}

    def structural_key(self, params: OscillatorParams):
        return params.waveform

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        i = _ramp(cfg.samples_per_tick, device)
        n = (host_aux["base"][:, None] + i[None, :] * aux["delta"]).reshape(-1)
        waveform = params.waveform
        if waveform == Waveform.SINE:
            s = _sine(n)
        elif waveform == Waveform.SQUARE:
            s = _square(n)
        elif waveform == Waveform.SAW:
            s = _saw(n)
        elif waveform == Waveform.TRIANGLE:
            s = _triangle(n)
        elif waveform == Waveform.ON:
            s = torch.ones_like(n)
        else:  # OFF
            s = torch.zeros_like(n)
        # stereo = the SAME tensor on both channels: no device work
        return state, [s, (s, s)], {}


class FmSineDef(ModuleDef):
    kind = "FmSine"

    def terminals(self, params: FmSineParams):
        return [LineType.MONO.unlabeled()], [LineType.STEREO.unlabeled()]

    def prepare(self, params: FmSineParams, cfg: EngineConfig, device):
        return {
            "freq_amp": _f32((params.freq_hi - params.freq_lo) / 2.0, device),
            "mid_delta": _f32(_fm_mid(params) / cfg.sample_rate, device),
        }

    def host_prepare(self, params: FmSineParams, t0: int, block: BlockSpec, cfg):
        # n = (f_mid + f_amp*x) * t (fm_sine.rs:42-50): the carrier f_mid*t
        # is an exact f64 per-tick base; the modulation term f_amp*x*t is
        # f32 on the device (the JAX package's documented precision limit)
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        tsamp = ticks * spt
        base_mid = _frac(tsamp * (_fm_mid(params) / cfg.sample_rate))
        tsec = tsamp / cfg.sample_rate
        return {
            "base_mid": base_mid.astype(np.float32),
            "tsec": tsec.astype(np.float32),
        }

    def host_columns(self, params_list):
        return {"freq_mid": np.array([_fm_mid(p) for p in params_list], dtype=np.float64)}

    def host_prepare_columns(self, columns, t0: int, block: BlockSpec, cfg):
        """``host_prepare`` of N instances at once, [N, T]."""
        spt = cfg.samples_per_tick
        ticks = t0 // spt + np.arange(block.n_ticks, dtype=np.float64)
        tsamp = ticks * spt
        mids = columns["freq_mid"]
        tsec = np.broadcast_to(tsamp / cfg.sample_rate, (len(mids), block.n_ticks))
        return {
            "base_mid": _bases(tsamp[None, :], mids / cfg.sample_rate),
            "tsec": tsec.astype(np.float32),
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        spt = cfg.samples_per_tick
        S = block.n_samples(cfg)
        x = expect_mono(inputs[0], S, device).reshape(block.n_ticks, spt)
        i = _ramp(spt, device)
        carrier = host_aux["base_mid"][:, None] + i[None, :] * aux["mid_delta"]
        # 1/sr rounded to f32 first, as jnp.float32(1/sr) is
        inv_sr = float(np.float32(1.0 / cfg.sample_rate))
        tsec = host_aux["tsec"][:, None] + i[None, :] * inv_sr
        n = carrier + aux["freq_amp"] * x * tsec
        s = _sin(n * _TWO_PI).reshape(-1)
        return state, [(s, s)], {}


class AmplifierDef(ModuleDef):
    kind = "Amplifier"

    def terminals(self, params: AmplifierParams):
        return (
            [LineType.STEREO.labeled("Input"), LineType.MONO.labeled("Control")],
            [LineType.STEREO.unlabeled()],
        )

    def prepare(self, params: AmplifierParams, cfg: EngineConfig, device):
        return {
            "amplitude": _f32(params.amplitude, device),
            "mod_depth": _f32(params.mod_depth, device),
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        S = block.n_samples(cfg)
        l, r = expect_stereo(inputs[0], S, device)
        if inputs[1] is None:
            # unconnected control -> depth() == 1 exactly (amplifier.rs:43-56)
            scale = aux["amplitude"]
        else:
            md = aux["mod_depth"]
            scale = (1.0 - md + md * inputs[1]) * aux["amplitude"]
        return state, [(l * scale, r * scale)], {}

    def mega_spec(self, params, cfg, block, connected):
        def emit(ctx, ins):
            l, r = ctx.expect_stereo(ins[0])
            amp, md = ctx.pf

            def scaled(src):
                if ins[1] is None:
                    return ctx.op(OP_AMP, src, amp)
                return ctx.op(OP_AMP_MOD, src, ins[1], amp, md)

            lo = scaled(l)
            return [(lo, lo if r == l else scaled(r))], {}

        return MegaSpec(
            emit=emit,
            param_scalars=lambda aux, h: ([aux["amplitude"], aux["mod_depth"]], []),
        )


class MixerDef(ModuleDef):
    kind = "Mixer"

    def structural_key(self, params: MixerParams):
        return len(params.channels)

    def terminals(self, params: MixerParams):
        ins = [LineType.STEREO.labeled(str(i + 1)) for i in range(len(params.channels))]
        outs = [LineType.STEREO.labeled("Master"), LineType.STEREO.labeled("Cue")]
        return ins, outs

    def prepare(self, params: MixerParams, cfg: EngineConfig, device):
        # channel_gain = fader * gain.to_linear() in f64 on the host
        # (mixer.rs:60); cue is a 0/1 mask
        gains = np.array(
            [c.fader * c.gain.to_linear() for c in params.channels], dtype=np.float32
        )
        cues = np.array([1.0 if c.cue else 0.0 for c in params.channels], dtype=np.float32)
        return {
            "gains": torch.from_numpy(gains).to(device),
            "cues": torch.from_numpy(cues).to(device),
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        S = block.n_samples(cfg)
        if len(inputs) == 0:
            z = torch.zeros((S,), dtype=torch.float32, device=device)
            return state, [(z, z), (z, z)], {}
        chans = [expect_stereo(x, S, device) for x in inputs]

        # weighted per-channel sums, in the JAX package's order
        def mix(w):
            lo = sum(w[k] * ch[0] for k, ch in enumerate(chans))
            ro = sum(w[k] * ch[1] for k, ch in enumerate(chans))
            return (lo, ro)

        return state, [mix(aux["gains"]), mix(aux["cues"])], {}

    def mega_spec(self, params, cfg, block, connected):
        n = len(params.channels)

        def emit(ctx, ins):
            if n == 0:
                z = ctx.zeros()
                return [(z, z), (z, z)], {}
            chans = [ctx.expect_stereo(x) for x in ins]
            lefts = [ch[0] for ch in chans]
            rights = [ch[1] for ch in chans]

            def mix(w):
                lo = ctx.op(OP_MIX, n, *lefts, *w)
                return (lo, lo if rights == lefts else ctx.op(OP_MIX, n, *rights, *w))

            # an output nothing reads is not computed (the JAX emit's zeros)
            return [mix(ctx.pf[:n]) if ctx.used[0] else None,
                    mix(ctx.pf[n:]) if ctx.used[1] else None], {}

        return MegaSpec(
            emit=emit,
            param_scalars=lambda aux, h: ([aux["gains"], aux["cues"]], []),
        )


class StereoPannerDef(ModuleDef):
    kind = "StereoPanner"

    def terminals(self, params):
        return (
            [LineType.MONO.labeled("L"), LineType.MONO.labeled("R")],
            [LineType.STEREO.unlabeled()],
        )

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        S = block.n_samples(cfg)
        left = expect_mono(inputs[0], S, device)
        right = expect_mono(inputs[1], S, device)
        return state, [(left, right)], {}  # channel routing = tuple plumbing

    def mega_spec(self, params, cfg, block, connected):
        return MegaSpec(emit=lambda ctx, ins: (
            [(ctx.expect_mono(ins[0]), ctx.expect_mono(ins[1]))], {}))


class StereoSplitterDef(ModuleDef):
    kind = "StereoSplitter"

    def terminals(self, params):
        return (
            [LineType.STEREO.unlabeled()],
            [LineType.MONO.labeled("L"), LineType.MONO.labeled("R")],
        )

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        l, r = expect_stereo(inputs[0], block.n_samples(cfg), device)
        return state, [l, r], {}  # no device work

    def mega_spec(self, params, cfg, block, connected):
        return MegaSpec(emit=lambda ctx, ins: (list(ctx.expect_stereo(ins[0])), {}))


class TriggerDef(ModuleDef):
    kind = "Trigger"

    def terminals(self, params: GateState):
        return [], [LineType.MONO.unlabeled()]

    def prepare(self, params: GateState, cfg: EngineConfig, device):
        return {"value": _f32(1.0 if params == GateState.OPEN else 0.0, device)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        # materialized (not a stride-0 view): the envelope kernel takes only
        # contiguous input
        S = block.n_samples(cfg)
        return state, [aux["value"].expand(S).contiguous()], {}

    def mega_spec(self, params, cfg, block, connected):
        return MegaSpec(
            emit=lambda ctx, ins: ([ctx.op(OP_FILL, ctx.pf[0])], {}),
            param_scalars=lambda aux, h: ([aux["value"]], []),
        )
