"""Module registry: kind tag -> ModuleDef singleton
(port of ``mixlab_tpu/dsp/registry.py``).

Holds every audio kind of the JAX package.  ``VideoMixer``, the one kind
not ported yet, raises ``NotImplementedError`` naming the ROADMAP.md item
that ports it.
"""

from __future__ import annotations

from typing import Dict

from mixlab_tpu_torch.dsp.audio import (
    AmplifierDef,
    FmSineDef,
    MixerDef,
    OscillatorDef,
    StereoPannerDef,
    StereoSplitterDef,
    TriggerDef,
)
from mixlab_tpu_torch.dsp.base import ModuleDef
from mixlab_tpu_torch.dsp.envelope import EnvelopeDef
from mixlab_tpu_torch.dsp.eq_three import EqThreeDef
from mixlab_tpu_torch.dsp.sinks import (
    MediaSourceDef,
    MonitorDef,
    OutputDeviceDef,
    PlotterDef,
    StreamInputDef,
    StreamOutputDef,
)

_REGISTRY: Dict[str, ModuleDef] = {
    d.kind: d
    for d in (
        AmplifierDef(),
        EnvelopeDef(),
        EqThreeDef(),
        FmSineDef(),
        MediaSourceDef(),
        MixerDef(),
        MonitorDef(),
        OscillatorDef(),
        OutputDeviceDef(),
        PlotterDef(),
        StereoPannerDef(),
        StereoSplitterDef(),
        StreamInputDef(),
        StreamOutputDef(),
        TriggerDef(),
    )
}

# kinds of the JAX package not ported yet -> the ROADMAP.md item that ports them
NOT_PORTED = {
    "VideoMixer": "queue 1 item 9 (video path)",
}


def get_def(kind: str) -> ModuleDef:
    d = _REGISTRY.get(kind)
    if d is not None:
        return d
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"module kind {kind!r} is not ported to mixlab_tpu_torch yet: "
            f"ROADMAP.md {NOT_PORTED[kind]}"
        )
    raise KeyError(kind)


def all_kinds():
    return sorted(_REGISTRY)
