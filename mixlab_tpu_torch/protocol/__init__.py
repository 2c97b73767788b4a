"""Shared wire/protocol types (the port's copy of ``mixlab_tpu/protocol``).

Rebuild of the reference protocol crate (``protocol/src/lib.rs:13-478`` in
haileys/mixlab): module ids, terminals, line types, per-module
params/indications, workspace ops, server updates and performance info.
The port keeps its own copy so that it imports nothing of ``mixlab_tpu``;
the types, field names and class names are the JAX package's, so the wire
encoding (and with it every ``.mixlab`` file) is byte-identical between the
two packages (``tests/test_torch_protocol.py``).

Serialization lives in :mod:`mixlab_tpu_torch.protocol.wire` (a versioned
JSON-per-message format replacing the reference's bincode framing).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# ids and terminals (protocol/src/lib.rs:118-196)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class ModuleId:
    value: int  # NonZeroUsize in the reference

    def __post_init__(self):
        if self.value <= 0:
            raise ValueError("ModuleId must be positive")


@dataclass(frozen=True, order=True)
class InputId:
    module_id: ModuleId
    index: int


@dataclass(frozen=True, order=True)
class OutputId:
    module_id: ModuleId
    index: int


class LineType(Enum):
    """Terminal line types (protocol/src/lib.rs:173-179)."""

    MONO = "mono"
    STEREO = "stereo"
    VIDEO = "video"

    def labeled(self, label: str) -> "Terminal":
        return Terminal(label, self)

    def unlabeled(self) -> "Terminal":
        return Terminal(None, self)


@dataclass(frozen=True)
class Terminal:
    """A labelled input/output port (protocol/src/lib.rs:157-171)."""

    label: Optional[str]
    line_type: LineType


# ---------------------------------------------------------------------------
# decibels (protocol/src/lib.rs:455-478)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Decibel:
    db: float = 0.0

    @staticmethod
    def from_linear(linear: float) -> "Decibel":
        return Decibel(math.log10(linear) * 20.0)

    def to_linear(self) -> float:
        return 10.0 ** (self.db / 20.0)

    def __str__(self) -> str:
        return f"{self.db:.2f} dB"


# ---------------------------------------------------------------------------
# module params (protocol/src/lib.rs:233-445)
# ---------------------------------------------------------------------------


class Waveform(Enum):
    ON = "on"
    OFF = "off"
    SINE = "sine"
    SQUARE = "square"
    TRIANGLE = "triangle"
    SAW = "saw"


@dataclass(frozen=True)
class OscillatorParams:
    freq: float = 220.0
    waveform: Waveform = Waveform.SINE


@dataclass(frozen=True)
class AmplifierParams:
    amplitude: float = 1.0
    mod_depth: float = 0.0


@dataclass(frozen=True)
class EnvelopeParams:
    # defaults match protocol/src/lib.rs:316-325
    attack_ms: float = 25.0
    decay_ms: float = 500.0
    sustain_amplitude: float = 0.8
    release_ms: float = 200.0


@dataclass(frozen=True)
class EqThreeParams:
    gain_lo: Decibel = field(default_factory=Decibel)
    gain_mid: Decibel = field(default_factory=Decibel)
    gain_hi: Decibel = field(default_factory=Decibel)


@dataclass(frozen=True)
class FmSineParams:
    freq_lo: float = 90.0
    freq_hi: float = 110.0


@dataclass(frozen=True)
class MixerChannelParams:
    gain: Decibel = field(default_factory=Decibel)
    fader: float = 1.0
    cue: bool = False


@dataclass(frozen=True)
class MixerParams:
    channels: Tuple[MixerChannelParams, ...] = ()

    @staticmethod
    def with_channels(n: int) -> "MixerParams":
        return MixerParams(tuple(MixerChannelParams() for _ in range(n)))


class GateState(Enum):
    OPEN = "open"
    CLOSED = "closed"


class StreamProtocol(Enum):
    ICECAST = "icecast"
    RTMP = "rtmp"


@dataclass(frozen=True)
class StreamInputParams:
    protocol: Optional[StreamProtocol] = None
    mountpoint: Optional[str] = None


@dataclass(frozen=True)
class StreamOutputParams:
    # impulse-in-params hack reproduced deliberately (protocol/src/lib.rs:361-370):
    # the client bumps seq and sets connect_seq/disconnect_seq = seq to request
    # a one-time connect/disconnect action.
    seq: int = 1
    connect_seq: int = 0
    disconnect_seq: int = 0
    rtmp_url: str = ""
    rtmp_stream_key: str = ""


@dataclass(frozen=True)
class OutputDeviceParams:
    device: Optional[str] = None
    left: Optional[int] = None
    right: Optional[int] = None


VIDEO_MIXER_CHANNELS = 4  # protocol/src/lib.rs:403


@dataclass(frozen=True)
class VideoMixerParams:
    a: Optional[int] = None
    b: Optional[int] = None
    fader: float = 1.0  # start at A (protocol/src/lib.rs:412-419)


@dataclass(frozen=True)
class MediaId:
    value: int


@dataclass(frozen=True)
class MediaSourceParams:
    media_id: Optional[MediaId] = None


@dataclass(frozen=True)
class ModuleParams:
    """Tagged union over per-module params (protocol/src/lib.rs:198-215)."""

    kind: str
    params: object

    # registry of kind tag -> param dataclass (None = unit params)
    KINDS = {
        "Amplifier": AmplifierParams,
        "Envelope": EnvelopeParams,
        "EqThree": EqThreeParams,
        "FmSine": FmSineParams,
        "MediaSource": MediaSourceParams,
        "Mixer": MixerParams,
        "Monitor": type(None),
        "Oscillator": OscillatorParams,
        "OutputDevice": OutputDeviceParams,
        "Plotter": type(None),
        "StereoPanner": type(None),
        "StereoSplitter": type(None),
        "StreamInput": StreamInputParams,
        "StreamOutput": StreamOutputParams,
        "Trigger": GateState,
        "VideoMixer": VideoMixerParams,
    }

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown module kind {self.kind!r}")


# ---------------------------------------------------------------------------
# indications (protocol/src/lib.rs:217-231, 248-313)
# ---------------------------------------------------------------------------


class TemporalWarningStatus(Enum):
    ACTIVE = "active"
    RECENT = "recent"


@dataclass(frozen=True)
class MonitorIndication:
    socket_id: str  # uuid


@dataclass(frozen=True)
class PlotterIndication:
    inputs: Tuple[Tuple[float, ...], ...]


class StreamOutputLiveStatus(Enum):
    OFFLINE = "offline"
    CONNECTING = "connecting"
    LIVE = "live"


@dataclass(frozen=True)
class StreamOutputIndication:
    live: StreamOutputLiveStatus = StreamOutputLiveStatus.OFFLINE
    error: bool = False


@dataclass(frozen=True)
class OutputDeviceIndication:
    clip: Optional[TemporalWarningStatus] = None
    lag: Optional[TemporalWarningStatus] = None
    default_device: Optional[str] = None
    devices: Optional[Tuple[Tuple[str, int], ...]] = None


@dataclass(frozen=True)
class Indication:
    kind: str
    value: object = None


# ---------------------------------------------------------------------------
# workspace state / ops (protocol/src/lib.rs:22-116)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Coords:
    x: int = 0
    y: int = 0

    def add(self, other: "Coords") -> "Coords":
        return Coords(self.x + other.x, self.y + other.y)

    def sub(self, other: "Coords") -> "Coords":
        return Coords(self.x - other.x, self.y - other.y)


@dataclass(frozen=True)
class WindowGeometry:
    position: Coords = field(default_factory=Coords)
    z_index: int = 0


@dataclass
class WorkspaceState:
    modules: List[Tuple[ModuleId, ModuleParams]] = field(default_factory=list)
    geometry: List[Tuple[ModuleId, WindowGeometry]] = field(default_factory=list)
    indications: List[Tuple[ModuleId, Indication]] = field(default_factory=list)
    connections: List[Tuple[InputId, OutputId]] = field(default_factory=list)
    inputs: List[Tuple[ModuleId, List[Terminal]]] = field(default_factory=list)
    outputs: List[Tuple[ModuleId, List[Terminal]]] = field(default_factory=list)


# workspace ops (client -> engine)


@dataclass(frozen=True)
class CreateModule:
    params: ModuleParams
    geometry: WindowGeometry


@dataclass(frozen=True)
class UpdateModuleParams:
    module_id: ModuleId
    params: ModuleParams


@dataclass(frozen=True)
class UpdateWindowGeometry:
    module_id: ModuleId
    geometry: WindowGeometry


@dataclass(frozen=True)
class DeleteModule:
    module_id: ModuleId


@dataclass(frozen=True)
class CreateConnection:
    input_id: InputId
    output_id: OutputId


@dataclass(frozen=True)
class DeleteConnection:
    input_id: InputId


WorkspaceOp = (
    CreateModule
    | UpdateModuleParams
    | UpdateWindowGeometry
    | DeleteModule
    | CreateConnection
    | DeleteConnection
)


@dataclass(frozen=True)
class WorkspaceMessage:
    sequence: int  # ClientSequence (non-zero)
    op: WorkspaceOp


# server updates (engine -> clients), protocol/src/lib.rs:100-116


@dataclass(frozen=True)
class SUCreateModule:
    id: ModuleId
    params: ModuleParams
    geometry: WindowGeometry
    indication: Indication
    inputs: Tuple[Terminal, ...]
    outputs: Tuple[Terminal, ...]


@dataclass(frozen=True)
class SUUpdateModuleParams:
    module_id: ModuleId
    params: ModuleParams


@dataclass(frozen=True)
class SUUpdateWindowGeometry:
    module_id: ModuleId
    geometry: WindowGeometry


@dataclass(frozen=True)
class SUUpdateModuleIndication:
    module_id: ModuleId
    indication: Indication


@dataclass(frozen=True)
class SUDeleteModule:
    module_id: ModuleId


@dataclass(frozen=True)
class SUCreateConnection:
    input_id: InputId
    output_id: OutputId


@dataclass(frozen=True)
class SUDeleteConnection:
    input_id: InputId


ServerUpdate = (
    SUCreateModule
    | SUUpdateModuleParams
    | SUUpdateWindowGeometry
    | SUUpdateModuleIndication
    | SUDeleteModule
    | SUCreateConnection
    | SUDeleteConnection
)


# ---------------------------------------------------------------------------
# performance info (protocol/src/lib.rs:34-60)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Microseconds:
    us: int


@dataclass(frozen=True)
class PerformanceMetric:
    last: Microseconds


@dataclass(frozen=True)
class PerformanceAccount:
    """'engine' account or a module account (protocol/src/lib.rs:52-56)."""

    kind: str  # "engine" | "module"
    module_id: Optional[ModuleId] = None


@dataclass
class PerformanceInfo:
    realtime: bool
    lag: Optional[TemporalWarningStatus]
    tick_rate: int
    tick_budget: Microseconds
    accounts: List[Tuple[PerformanceAccount, PerformanceMetric]] = field(
        default_factory=list
    )
    # fraction of ticks in the report window that finished on schedule
    # (extension beyond the reference wire shape; ``realtime`` is true only
    # when this is 1.0 — see engine/timing.py)
    realtime_fraction: Optional[float] = None


# ---------------------------------------------------------------------------
# media library (protocol/src/lib.rs:62-77)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MediaItem:
    id: MediaId
    name: str
    kind: str
    size: int


@dataclass
class MediaLibrary:
    items: List[MediaItem] = field(default_factory=list)
