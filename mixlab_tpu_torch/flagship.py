"""The flagship 16-module graph, built with the port's ``Workspace``, and the
realtime workspace that adds live video to it.

Same modules, ids and connections as ``bench.py:build_16_module_graph``
(which needs the JAX package): trigger -> envelope -> four
oscillator/amplifier chains + fm_sine -> splitter -> eq_three -> panner ->
8-channel mixer -> monitor.
"""

from __future__ import annotations

from mixlab_tpu_torch import protocol as port_protocol
from mixlab_tpu_torch.engine.graph import Workspace

# module ids in creation order (a fresh workspace numbers modules from 1)
TRIG, ENV, OSC0, FM, AMP0, EQ, SPLIT, PAN, MIXER, MON = 1, 2, 3, 7, 8, 12, 13, 14, 15, 16


def _flagship_modules(p):
    """(kind, params) of the 16 modules, in creation order."""
    return ([("Trigger", p.GateState.OPEN), ("Envelope", p.EnvelopeParams())]
            + [("Oscillator", p.OscillatorParams(110.0 * (i + 1), p.Waveform.SINE))
               for i in range(4)]
            + [("FmSine", p.FmSineParams(440.0, 880.0))]
            + [("Amplifier", p.AmplifierParams(amplitude=0.5, mod_depth=0.3))] * 4
            + [("EqThree", p.EqThreeParams(p.Decibel(4.0), p.Decibel(0.0), p.Decibel(4.0))),
               ("StereoSplitter", None), ("StereoPanner", None),
               ("Mixer", p.MixerParams.with_channels(8)), ("Monitor", None)])


# (input module, input index, output module, output index), in connect order
_FLAGSHIP_LINKS = (
    [(ENV, 0, TRIG, 0)]
    + [link for i in range(4) for link in (
        (AMP0 + i, 0, OSC0 + i, 1), (AMP0 + i, 1, ENV, 0), (MIXER, i, AMP0 + i, 0))]
    + [(FM, 0, ENV, 0), (MIXER, 4, FM, 0), (SPLIT, 0, AMP0, 0), (EQ, 0, SPLIT, 0),
       (PAN, 0, EQ, 0), (PAN, 1, SPLIT, 1), (MIXER, 5, PAN, 0), (MIXER, 6, AMP0 + 1, 0),
       (MIXER, 7, AMP0 + 2, 0), (MON, 1, MIXER, 0)]
)


def build_16_module_graph():
    """Returns ``(workspace, monitor module id)``."""
    p = port_protocol
    ws = Workspace()
    for kind, params in _flagship_modules(p):
        ws.create_module(p.ModuleParams(kind, params))
    for im, ii, om, oi in _FLAGSHIP_LINKS:
        ws.connect(p.InputId(p.ModuleId(im), ii), p.OutputId(p.ModuleId(om), oi))
    if len(ws.modules) != 16:
        raise AssertionError(len(ws.modules))
    return ws, p.ModuleId(MON)


def realtime_video_ops(p, cams=("cam1", "cam2"), fader: float = 0.6):
    """The client ops that build the realtime workspace, as a browser
    session builds it: the flagship graph, two ``StreamInput`` modules
    listening on the RTMP mountpoints ``cams``, and a ``VideoMixer(a=0,
    b=1, fader)`` whose composite feeds the Monitor's video input.

    ``p`` is a protocol module: the port's, or the JAX package's (the
    classes and their encodings are the same), so one script drives either
    engine.  With ``cams=()`` the ops build the flagship graph alone, with
    no video chain.  Returns ``(ops, ids)`` with ``ids`` the ModuleIds of
    ``"monitor"``, ``"cams"`` and ``"mixer"`` (None without cams)."""
    geo = p.WindowGeometry()
    modules = _flagship_modules(p)
    links = list(_FLAGSHIP_LINKS)
    cam_ids = [MON + 1 + i for i in range(len(cams))]
    vm = MON + 1 + len(cams) if cams else None
    if cams:
        modules += [("StreamInput", p.StreamInputParams(p.StreamProtocol.RTMP, cam))
                    for cam in cams]
        modules.append(("VideoMixer", p.VideoMixerParams(a=0, b=1, fader=fader)))
        links += [(vm, i, cam, 0) for i, cam in enumerate(cam_ids)] + [(MON, 0, vm, 0)]
    ops = [p.CreateModule(p.ModuleParams(kind, params), geo) for kind, params in modules]
    ops += [p.CreateConnection(p.InputId(p.ModuleId(im), ii), p.OutputId(p.ModuleId(om), oi))
            for im, ii, om, oi in links]
    ids = {"monitor": p.ModuleId(MON), "cams": [p.ModuleId(c) for c in cam_ids],
           "mixer": None if vm is None else p.ModuleId(vm)}
    return ops, ids
