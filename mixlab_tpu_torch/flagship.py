"""The flagship 16-module graph, built with the port's ``Workspace``.

Same modules, ids and connections as ``bench.py:build_16_module_graph``
(which needs the JAX package): trigger -> envelope -> four
oscillator/amplifier chains + fm_sine -> splitter -> eq_three -> panner ->
8-channel mixer -> monitor.
"""

from __future__ import annotations

from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.protocol import InputId, OutputId
from mixlab_tpu_torch.engine.graph import Workspace


def build_16_module_graph():
    """Returns ``(workspace, monitor module id)``."""
    ws = Workspace()

    def add(kind, params):
        return ws.create_module(p.ModuleParams(kind, params))

    trig = add("Trigger", p.GateState.OPEN)
    env = add("Envelope", p.EnvelopeParams())
    oscs = [
        add("Oscillator", p.OscillatorParams(110.0 * (i + 1), p.Waveform.SINE))
        for i in range(4)
    ]
    fm = add("FmSine", p.FmSineParams(440.0, 880.0))
    amps = [
        add("Amplifier", p.AmplifierParams(amplitude=0.5, mod_depth=0.3))
        for _ in range(4)
    ]
    eq = add("EqThree", p.EqThreeParams(p.Decibel(4.0), p.Decibel(0.0), p.Decibel(4.0)))
    split = add("StereoSplitter", None)
    pan = add("StereoPanner", None)
    mixer = add("Mixer", p.MixerParams.with_channels(8))
    mon = add("Monitor", None)

    ws.connect(InputId(env, 0), OutputId(trig, 0))
    for i, (o, a) in enumerate(zip(oscs, amps)):
        ws.connect(InputId(a, 0), OutputId(o, 1))
        ws.connect(InputId(a, 1), OutputId(env, 0))
        ws.connect(InputId(mixer, i), OutputId(a, 0))
    ws.connect(InputId(fm, 0), OutputId(env, 0))
    ws.connect(InputId(mixer, 4), OutputId(fm, 0))
    ws.connect(InputId(split, 0), OutputId(amps[0], 0))
    ws.connect(InputId(eq, 0), OutputId(split, 0))
    ws.connect(InputId(pan, 0), OutputId(eq, 0))
    ws.connect(InputId(pan, 1), OutputId(split, 1))
    ws.connect(InputId(mixer, 5), OutputId(pan, 0))
    ws.connect(InputId(mixer, 6), OutputId(amps[1], 0))
    ws.connect(InputId(mixer, 7), OutputId(amps[2], 0))
    ws.connect(InputId(mon, 1), OutputId(mixer, 0))
    if len(ws.modules) != 16:
        raise AssertionError(len(ws.modules))
    return ws, mon
