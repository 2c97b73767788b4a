"""Wire serialization for protocol types (the port's copy of
``mixlab_tpu/protocol/wire.py``; the encoding must stay byte-identical).

Replaces the reference's bincode-over-WebSocket framing
(``src/server.rs:240,354``; ``frontend/src/session.rs:62,215``) with a
versioned, self-describing JSON encoding.  bincode is a Rust-specific
non-self-describing format; a versioned JSON protocol is the deliberate
TPU-build replacement (documented deviation — the client is rebuilt too, so
both ends of the wire are ours).

Every dataclass/enum in :mod:`mixlab_tpu_torch.protocol` round-trips through
``dumps``/``loads``.  Union types (WorkspaceOp, ServerUpdate, messages) are
encoded as ``{"t": <class name>, ...fields}``.
"""

from __future__ import annotations

import dataclasses
import json
from enum import Enum
from typing import Any, get_args, get_origin, get_type_hints

from mixlab_tpu_torch import protocol as p

WIRE_VERSION = 1

# classes addressable by tag in tagged-union encodings
_TAGGED: dict[str, type] = {}


def _register(*classes):
    for c in classes:
        _TAGGED[c.__name__] = c


_register(
    p.CreateModule,
    p.UpdateModuleParams,
    p.UpdateWindowGeometry,
    p.DeleteModule,
    p.CreateConnection,
    p.DeleteConnection,
    p.SUCreateModule,
    p.SUUpdateModuleParams,
    p.SUUpdateWindowGeometry,
    p.SUUpdateModuleIndication,
    p.SUDeleteModule,
    p.SUCreateConnection,
    p.SUDeleteConnection,
    p.WorkspaceMessage,
    p.WorkspaceState,
    p.PerformanceInfo,
    p.MediaLibrary,
    p.MediaItem,
    p.PlotterIndication,
    p.MonitorIndication,
    p.StreamOutputIndication,
    p.OutputDeviceIndication,
)


def encode(obj: Any) -> Any:
    """Encode a protocol value into JSON-serializable data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Enum):
        return obj.value
    if isinstance(obj, p.ModuleId):
        return obj.value
    if isinstance(obj, p.MediaId):
        return obj.value
    if isinstance(obj, p.InputId):
        return [obj.module_id.value, obj.index]
    if isinstance(obj, p.OutputId):
        return [obj.module_id.value, obj.index]
    if isinstance(obj, p.Decibel):
        return obj.db
    if isinstance(obj, p.Microseconds):
        return obj.us
    if isinstance(obj, p.Terminal):
        return [obj.label, obj.line_type.value]
    if isinstance(obj, p.ModuleParams):
        return {"kind": obj.kind, "params": encode(obj.params)}
    if isinstance(obj, p.Indication):
        return {"kind": obj.kind, "value": encode(obj.value)}
    if isinstance(obj, p.PerformanceAccount):
        if obj.kind == "engine":
            return "engine"
        return {"module": obj.module_id.value}
    if dataclasses.is_dataclass(obj):
        out = {"t": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = encode(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [encode(x) for x in obj]
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    raise TypeError(f"cannot encode {type(obj)!r}")


class WireDecodeError(ValueError):
    """A wire payload did not decode as the expected protocol type.

    Raised for EVERY shape or leaf-type violation in untrusted inbound
    data.  The reference gets this guarantee from bincode + Rust's type
    system (a `f32` field can never hold a string — src/server.rs:240);
    a self-describing JSON wire has to enforce it explicitly, otherwise
    type-confused values flow into the engine thread and detonate there
    (jnp tracing a str kills the tick loop for every session).
    """


#: inbound container cap: the only client-editable lists (mixer channels,
#: workspace ops) are human-scale; a million-element list in a decoded
#: param would drive graph compilation, not just memory
_MAX_LIST = 4096


def decode(data: Any, ty: Any) -> Any:
    """Strictly decode untrusted wire ``data`` as protocol type ``ty``.

    The single safe entry point for inbound payloads: any violation —
    wrong leaf type, missing field, unknown tag/kind, bad enum value,
    overlong container, non-finite conversion — raises
    :class:`WireDecodeError` and nothing else.
    """
    try:
        return _decode_typed(data, ty)
    except WireDecodeError:
        raise
    except (KeyError, IndexError, TypeError, ValueError, OverflowError,
            AttributeError, RecursionError) as e:
        raise WireDecodeError(
            f"malformed wire payload ({type(e).__name__}: {e})"
        ) from None


def _expect(cond: bool, what: str, data: Any) -> None:
    if not cond:
        raise WireDecodeError(
            f"expected {what}, got {type(data).__name__}"
        )


def _decode_int(data: Any) -> int:
    if isinstance(data, bool) or not isinstance(data, int):
        # tolerate integral floats: a JS client has one number type
        if isinstance(data, float) and data.is_integer():
            return int(data)
        raise WireDecodeError(f"expected int, got {type(data).__name__}")
    return data


def _decode_float(data: Any) -> float:
    if isinstance(data, bool) or not isinstance(data, (int, float)):
        raise WireDecodeError(f"expected number, got {type(data).__name__}")
    return float(data)  # OverflowError on huge ints → wrapped by decode()


def _decode_typed(data: Any, ty: Any) -> Any:
    """Decode ``data`` as type ``ty`` (a protocol class or typing construct)."""
    if ty is type(None):
        return None
    if ty is int:
        return _decode_int(data)
    if ty is float:
        return _decode_float(data)
    if ty is str:
        _expect(isinstance(data, str), "str", data)
        return data
    if ty is bool:
        _expect(isinstance(data, bool), "bool", data)
        return data
    if ty in (object, Any):
        return data
    origin = get_origin(ty)
    if origin in (list, tuple):
        _expect(isinstance(data, (list, tuple)), "array", data)
        if len(data) > _MAX_LIST:
            raise WireDecodeError(f"array too long ({len(data)})")
        args = get_args(ty)
        if origin is tuple and len(args) == 2 and args[1] is Ellipsis:
            return tuple(_decode_typed(x, args[0]) for x in data)
        if origin is tuple:
            _expect(len(data) == len(args), f"array[{len(args)}]", data)
            return tuple(_decode_typed(x, a) for x, a in zip(data, args))
        return [_decode_typed(x, args[0]) for x in data]
    import types
    import typing

    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in get_args(ty)]
        if type(None) in args and data is None:
            return None
        args = [a for a in args if a is not type(None)]
        if len(args) == 1:
            return _decode_typed(data, args[0])
        # tagged union of dataclasses
        return decode_tagged(data)
    # UnionType via | on py3.12 shows up as types.UnionType handled above;
    # direct classes:
    if isinstance(ty, type):
        if issubclass(ty, Enum):
            try:
                return ty(data)
            except (ValueError, TypeError, KeyError):
                raise WireDecodeError(
                    f"bad {ty.__name__} value {data!r}"
                ) from None
        if ty is p.ModuleId:
            return p.ModuleId(_decode_int(data))
        if ty is p.MediaId:
            return p.MediaId(_decode_int(data))
        if ty is p.InputId:
            _expect(isinstance(data, (list, tuple)) and len(data) == 2,
                    "terminal id pair", data)
            return p.InputId(p.ModuleId(_decode_int(data[0])),
                             _decode_int(data[1]))
        if ty is p.OutputId:
            _expect(isinstance(data, (list, tuple)) and len(data) == 2,
                    "terminal id pair", data)
            return p.OutputId(p.ModuleId(_decode_int(data[0])),
                              _decode_int(data[1]))
        if ty is p.Decibel:
            return p.Decibel(_decode_float(data))
        if ty is p.Microseconds:
            return p.Microseconds(_decode_int(data))
        if ty is p.Terminal:
            _expect(isinstance(data, (list, tuple)) and len(data) == 2,
                    "terminal pair", data)
            return p.Terminal(_decode_typed(data[0], str),
                              _decode_typed(data[1], p.LineType))
        if ty is p.ModuleParams:
            return decode_module_params(data)
        if ty is p.Indication:
            _expect(isinstance(data, dict), "indication object", data)
            return p.Indication(_decode_typed(data.get("kind"), str),
                                decode_indication_value(data))
        if ty is p.PerformanceAccount:
            if data == "engine":
                return p.PerformanceAccount("engine")
            _expect(isinstance(data, dict), "performance account", data)
            return p.PerformanceAccount(
                "module", p.ModuleId(_decode_int(data.get("module")))
            )
        if dataclasses.is_dataclass(ty):
            return _decode_dataclass(data, ty)
    raise WireDecodeError(f"cannot decode as {ty!r}")


def _decode_dataclass(data: dict, cls: type) -> Any:
    _expect(isinstance(data, dict), f"{cls.__name__} object", data)
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _decode_typed(data[f.name], hints[f.name])
    try:
        return cls(**kwargs)
    except TypeError as e:  # missing required field
        raise WireDecodeError(f"bad {cls.__name__}: {e}") from None


def decode_tagged(data: Any) -> Any:
    _expect(isinstance(data, dict), "tagged object", data)
    cls = _TAGGED.get(data.get("t"))
    if cls is None:
        raise WireDecodeError(f"unknown wire tag {data.get('t')!r}")
    return _decode_dataclass(data, cls)


def decode_module_params(data: Any) -> p.ModuleParams:
    _expect(isinstance(data, dict), "module params object", data)
    kind = data.get("kind")
    if not isinstance(kind, str) or kind not in p.ModuleParams.KINDS:
        raise WireDecodeError(f"unknown module kind {kind!r}")
    cls = p.ModuleParams.KINDS[kind]
    if cls is type(None):
        return p.ModuleParams(kind, None)
    if issubclass(cls, Enum):
        return p.ModuleParams(kind, _decode_typed(data.get("params"), cls))
    return p.ModuleParams(kind, _decode_dataclass(data.get("params"), cls))


_INDICATION_VALUES = {
    "Monitor": p.MonitorIndication,
    "Plotter": p.PlotterIndication,
    "StreamOutput": p.StreamOutputIndication,
    "OutputDevice": p.OutputDeviceIndication,
}


def decode_indication_value(data: dict) -> Any:
    cls = _INDICATION_VALUES.get(data["kind"])
    if cls is None or data.get("value") is None:
        return None
    return _decode_dataclass(data["value"], cls)


# ---------------------------------------------------------------------------
# top-level message framing
# ---------------------------------------------------------------------------


def dumps(msg: Any) -> str:
    """Serialize one protocol message (with version header)."""
    return json.dumps({"v": WIRE_VERSION, "m": encode(msg)}, separators=(",", ":"))


def _json_loads(text: str | bytes) -> Any:
    # deeply-nested input drives CPython's recursive json decoder into
    # RecursionError — keep the malformed-input error class uniform
    try:
        return json.loads(text)
    except RecursionError:
        raise ValueError("wire payload nested too deeply") from None


def loads(text: str | bytes) -> Any:
    data = _json_loads(text)
    if not isinstance(data, dict):
        raise ValueError("wire message is not an object")
    if data.get("v") != WIRE_VERSION:
        raise ValueError(f"unsupported wire version {data.get('v')!r}")
    try:
        return decode_tagged(data.get("m"))
    except WireDecodeError:
        raise
    except (KeyError, IndexError, TypeError, ValueError, OverflowError,
            AttributeError, RecursionError) as e:
        raise WireDecodeError(
            f"malformed wire payload ({type(e).__name__}: {e})"
        ) from None


# client<->server envelope helpers (ServerMessage / ClientMessage analogues,
# protocol/src/lib.rs:14-20,80-82)


def server_message(kind: str, payload: Any) -> str:
    return json.dumps(
        {"v": WIRE_VERSION, "kind": kind, "m": encode(payload)},
        separators=(",", ":"),
    )


def parse_envelope(text: str | bytes) -> tuple[str, Any]:
    data = _json_loads(text)
    # raise ValueError (the server's skip-malformed-message class,
    # server/app.py) on any shape violation — a top-level non-dict or a
    # missing key must not leak KeyError/AttributeError into the session
    if not isinstance(data, dict):
        raise ValueError("wire envelope is not an object")
    if data.get("v") != WIRE_VERSION:
        raise ValueError(f"unsupported wire version {data.get('v')!r}")
    try:
        return data["kind"], data["m"]
    except KeyError as e:
        raise ValueError(f"wire envelope missing {e}") from None
