"""Module registry: kind tag -> ModuleDef singleton
(port of ``mixlab_tpu/dsp/registry.py``).

Holds every kind of the JAX package.  A kind listed in ``NOT_PORTED``
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it
(none is left since the video mixer came with the realtime engine).

``registered`` adds a kind for the length of a ``with`` block only (the
profiling tool's ``EqDummy``), where the JAX package's ``register`` adds it
for the rest of the process.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

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
from mixlab_tpu_torch.dsp.video_mixer import VideoMixerDef
from mixlab_tpu_torch.protocol import ModuleParams

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
        VideoMixerDef(),
    )
}

# kinds of the JAX package not ported yet -> the ROADMAP.md item that ports them
NOT_PORTED: Dict[str, str] = {}


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


@contextlib.contextmanager
def registered(defn: ModuleDef, params_cls: type = type(None)) -> Iterator[ModuleDef]:
    """Inside the block, ``defn``'s kind is in the registry and in
    ``ModuleParams.KINDS`` (with ``params_cls``); on exit it leaves both.
    A kind that is already known raises ``ValueError``."""
    kind = defn.kind
    if kind in _REGISTRY or kind in ModuleParams.KINDS:
        raise ValueError(f"module kind {kind!r} is already registered")
    kinds = ModuleParams.KINDS
    _REGISTRY[kind] = defn
    ModuleParams.KINDS = {**kinds, kind: params_cls}
    try:
        yield defn
    finally:
        del _REGISTRY[kind]
        ModuleParams.KINDS = kinds
