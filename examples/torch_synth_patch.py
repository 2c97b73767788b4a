"""Build a synth patch with the library API of the PyTorch port and render it
offline on an NVIDIA GPU (``--device cpu`` renders on the CPU).

The same graph a user would click together in the browser -- trigger ->
envelope -> oscillators -> amplifier -> eq -> monitor -- constructed
programmatically and rendered block by block by
``mixlab_tpu_torch.engine.render.render``; the graph and the command line are
those of ``examples/synth_patch.py``.

    python examples/torch_synth_patch.py out.wav --seconds 5
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# runnable as a script from anywhere: put the repo root on the path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from mixlab_tpu_torch import protocol as p  # noqa: E402
from mixlab_tpu_torch.device import resolve_device  # noqa: E402
from mixlab_tpu_torch.engine.config import EngineConfig  # noqa: E402
from mixlab_tpu_torch.engine.graph import Workspace  # noqa: E402
from mixlab_tpu_torch.engine.render import render  # noqa: E402
from mixlab_tpu_torch.io_host.wav import write_wav  # noqa: E402


def build_patch():
    ws = Workspace()

    def add(kind, params):
        return ws.create_module(p.ModuleParams(kind, params))

    trig = add("Trigger", p.GateState.OPEN)
    env = add("Envelope", p.EnvelopeParams(
        attack_ms=40.0, decay_ms=120.0, sustain_amplitude=0.6,
        release_ms=300.0))
    osc1 = add("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW))
    osc2 = add("Oscillator", p.OscillatorParams(220.5, p.Waveform.SAW))
    amp1 = add("Amplifier", p.AmplifierParams(amplitude=0.7, mod_depth=1.0))
    amp2 = add("Amplifier", p.AmplifierParams(amplitude=0.7, mod_depth=1.0))
    mix = add("Mixer", p.MixerParams.with_channels(4))
    split = add("StereoSplitter", None)
    eq = add("EqThree", p.EqThreeParams(
        p.Decibel(3.0), p.Decibel(-1.0), p.Decibel(2.0)))
    pan = add("StereoPanner", None)
    mon = add("Monitor", None)

    ws.connect(p.InputId(env, 0), p.OutputId(trig, 0))     # gate
    # oscillator stereo outs (index 1) through envelope-modulated amps
    ws.connect(p.InputId(amp1, 0), p.OutputId(osc1, 1))
    ws.connect(p.InputId(amp1, 1), p.OutputId(env, 0))
    ws.connect(p.InputId(amp2, 0), p.OutputId(osc2, 1))
    ws.connect(p.InputId(amp2, 1), p.OutputId(env, 0))
    ws.connect(p.InputId(mix, 0), p.OutputId(amp1, 0))
    ws.connect(p.InputId(mix, 1), p.OutputId(amp2, 0))
    # mixer -> split; left leg through the eq, re-paired in the panner
    ws.connect(p.InputId(split, 0), p.OutputId(mix, 0))
    ws.connect(p.InputId(eq, 0), p.OutputId(split, 0))
    ws.connect(p.InputId(pan, 0), p.OutputId(eq, 0))
    ws.connect(p.InputId(pan, 1), p.OutputId(split, 1))
    ws.connect(p.InputId(mon, 1), p.OutputId(pan, 0))      # monitor audio
    return ws, mon


def main(argv=None) -> np.ndarray:
    """Render, write the WAV and return its int16 ``[frames, 2]`` PCM."""
    parser = argparse.ArgumentParser()
    parser.add_argument("output", help="output WAV path")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--sample-rate", type=int, default=48_000)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    cfg = EngineConfig(sample_rate=args.sample_rate)
    ws, mon = build_patch()
    n_ticks = int(args.seconds * cfg.ticks_per_second)
    res = render(ws, n_ticks, cfg, device=resolve_device(args.device))
    audio = np.asarray(res.monitor_audio(mon))
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    write_wav(args.output, cfg.sample_rate, pcm)
    rms = float(np.sqrt((audio.astype(np.float64) ** 2).mean()))
    print(f"wrote {args.output}: {len(pcm)} samples @ {cfg.sample_rate} Hz, "
          f"rms {rms:.3f}")
    assert rms > 0.01, "patch rendered silence"
    return pcm


if __name__ == "__main__":
    main()
