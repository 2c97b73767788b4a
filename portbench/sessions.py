"""Per-session params drawn from the seed in bulk, and the port's workspace
for one session.

A configuration's ``session_params`` gives each continuous param's range;
``draw`` takes every session's values in one pass of one generator, so a
seed gives the same sessions whatever the traffic does with them, and every
seed gives the same graph, sizes and work.  The plain reference reads the
same dicts (``reference/audio.py``); only ``workspace`` touches the
program."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# the flagship's module ids (a fresh workspace numbers modules from 1)
ENV, OSC0, FM, AMP0, EQ = 2, 3, 7, 8, 12


def draw(config: dict, seed: int, n: int, stream: int = 0) -> List[Dict]:
    """``n`` sessions' params for ``config`` (``stream`` keeps separate
    draws of one seed apart)."""
    sp = config["session_params"]
    rng = np.random.default_rng([stream, seed])

    def u(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * rng.random((n, *shape))

    base = np.asarray(sp["osc_freq"], dtype=np.float64)
    osc = base[None, :] * (1.0 + u(sp["osc_detune"], 4))
    amp = u(sp["amp_amplitude"], 4)
    shift = u(sp["fm_shift"])
    eq = np.stack([u(sp["eq_lo_db"]), u(sp["eq_mid_db"]), u(sp["eq_hi_db"])], axis=1)
    env = tuple(float(v) for v in sp["envelope"])
    md = float(sp["amp_mod_depth"])
    return [{"osc_freq": osc[i].tolist(), "amp_amplitude": amp[i].tolist(),
             "amp_mod_depth": [md] * 4, "fm_lo": sp["fm_lo"] + float(shift[i]),
             "fm_hi": sp["fm_hi"] - float(shift[i]), "eq_db": eq[i].tolist(), "env": env}
            for i in range(n)]


def apply(ws, sp: Dict) -> None:
    """Write one session's params into the port's flagship workspace
    ``ws`` (the module ids of ``mixlab_tpu_torch.flagship``)."""
    from mixlab_tpu_torch import protocol as p

    attack, decay, sustain, release = sp["env"]
    ws.update_params(p.ModuleId(ENV), p.ModuleParams("Envelope", p.EnvelopeParams(
        attack_ms=attack, decay_ms=decay, sustain_amplitude=sustain, release_ms=release)))
    for j in range(4):
        ws.update_params(p.ModuleId(OSC0 + j), p.ModuleParams(
            "Oscillator", p.OscillatorParams(sp["osc_freq"][j], p.Waveform.SINE)))
        ws.update_params(p.ModuleId(AMP0 + j), p.ModuleParams(
            "Amplifier", p.AmplifierParams(amplitude=sp["amp_amplitude"][j],
                                           mod_depth=sp["amp_mod_depth"][j])))
    ws.update_params(p.ModuleId(FM), p.ModuleParams(
        "FmSine", p.FmSineParams(sp["fm_lo"], sp["fm_hi"])))
    ws.update_params(p.ModuleId(EQ), p.ModuleParams(
        "EqThree", p.EqThreeParams(*(p.Decibel(g) for g in sp["eq_db"]))))


def workspaces(sps: List[Dict]):
    """The port's flagship workspace for each session, and the Monitor's id."""
    from mixlab_tpu_torch.flagship import build_16_module_graph

    base, mon = build_16_module_graph()
    out = []
    for sp in sps:
        ws = base.snapshot()
        apply(ws, sp)
        out.append(ws)
    return out, mon
