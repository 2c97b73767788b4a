"""Named spans inside the program, on the ``torch.profiler`` clock.

``span(name)`` is off until ``enable()``: while off it tests one flag and
returns a shared no-op context, so it makes no object and calls nothing of
torch.  Once on, each span is ``torch.profiler.record_function(prefix +
name)``: in a profile it lies beside the device's kernels and nests inside
its callers' spans; with no profile running it records nothing.  A dynamic
part of a name (a module's kind) is passed apart, ``span("module.", kind)``,
so the off path joins no string.
"""

from __future__ import annotations

import contextlib

from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_prefix = None  # None: off


def span(name: str, part: str = ""):
    """A context around one phase: ``<prefix><name><part>`` when on."""
    if _prefix is None:
        return _OFF
    return record_function(_prefix + name + part)


def enable(prefix: str = "") -> None:
    """Turn every span on, each name after ``prefix``."""
    global _prefix
    _prefix = prefix


def disable() -> None:
    global _prefix
    _prefix = None


def enabled() -> bool:
    return _prefix is not None
