"""The traced run's records: one ``torch.profiler`` profile over the window,
the benchmark's own spans (``torch.profiler.record_function`` around the
calls into a layer, so they share the profile's clock), and what the
per-layer metrics read from them.

A profile whose trace holds no device record is taken once more over a
second window, then the run fails: it is never read as 0.

Each device record keeps its card, by the trace's device index.  The busy
and idle readings are each card's own and then their mean over the cell's
cards; a card that recorded nothing in the window is idle all of it.
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "pb:"
WINDOW = SPAN_PREFIX + "window"


class Tracer:
    """Spans and the one profile of a traced run; every method is a no-op
    in a run with ``--trace 0`` (``on`` False)."""

    def __init__(self, on: bool):
        self.on = on
        self._patched: List[Tuple[object, str, object]] = []

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Put a span named ``name`` around every call of ``owner.attr``
        (undone by ``unwrap``)."""
        if not self.on:
            return
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        self.replace(owner, attr, spanned)

    def replace(self, owner, attr: str, fn) -> None:
        """Set ``owner.attr`` to ``fn`` until ``unwrap``."""
        had = attr in vars(owner)
        self._patched.append((owner, attr, getattr(owner, attr) if had else None))
        setattr(owner, attr, fn)

    def count_launches(self, family: str, module: str, attr: str, facts: Dict[str, float]) -> None:
        """Count each call of the launch wrapper ``module.attr`` in
        ``facts["<family>.launches"]``, and the bytes of the tensors it
        takes and returns, each distinct tensor once, in
        ``facts["<family>.bytes"]``: what one launch reads and writes at the
        least (undone by ``unwrap``)."""
        if not self.on:
            return
        import importlib

        owner = importlib.import_module(module)
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen = {t.data_ptr(): t.numel() * t.element_size()
                    for t in _tensors((args, kwargs, out))}
            facts[f"{family}.launches"] = facts.get(f"{family}.launches", 0) + 1
            facts[f"{family}.bytes"] = facts.get(f"{family}.bytes", 0.0) + sum(seen.values())
            return out

        self.replace(owner, attr, counted)

    def unwrap(self) -> None:
        for owner, attr, fn in reversed(self._patched):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._patched.clear()

    @contextlib.contextmanager
    def profile(self):
        """The window's profile (CPU and CUDA activities); yields a list that
        holds the ``Records`` once the block has ended."""
        out: List[Records] = []
        if not self.on:
            yield out
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with self.span("window"):
                yield out
        out.append(Records.from_kineto(prof.profiler.kineto_results.events()))


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals ``(start, end)``, sorted."""
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _tensors(x):
    """The tensors in ``x``, through tuples, lists and dicts."""
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@dataclass
class Records:
    """What one traced window recorded, in nanoseconds on the profile's
    clock: device kernels and copies, the benchmark's spans, the window,
    the driver's shapes and the launches counted at the program's wrappers.

    ``kernel_cards`` and ``copy_cards`` hold the trace's device index of
    each kernel and copy, in their order; left empty, every record is on
    one card.  ``cards`` is the number of cards the cell asked for."""

    kernels: List[Tuple[str, int, int]] = field(default_factory=list)  # name, start, dur
    copies: List[Tuple[str, int, int]] = field(default_factory=list)  # memcpy and memset
    kernel_cards: List[int] = field(default_factory=list)
    copy_cards: List[int] = field(default_factory=list)
    cards: int = 1
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=lambda: defaultdict(list))
    window: Tuple[int, int] = (0, 0)
    units: int = 0  # blocks, ticks or renders the window completed
    facts: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_kineto(cls, events) -> "Records":
        from torch.autograd import DeviceType

        rec = cls()
        for e in events:
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                # the device's own activities; a span's shadow on the device
                # timeline and the runtime's synchronizations are neither
                if e.is_user_annotation() or name.startswith((SPAN_PREFIX, "cuda")):
                    continue
                if name.startswith(("Memcpy", "Memset")):
                    rec.copies.append((name, start, dur))
                    rec.copy_cards.append(e.device_index())
                else:
                    rec.kernels.append((name, start, dur))
                    rec.kernel_cards.append(e.device_index())
            elif e.is_user_annotation() and name.startswith(SPAN_PREFIX):
                if name == WINDOW:
                    rec.window = (start, start + dur)
                else:
                    rec.spans[name[len(SPAN_PREFIX):]].append((start, dur))
        return rec

    # -- what the metrics read ----------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def card_intervals(self) -> List[List[Tuple[int, int]]]:
        """Each card's union of kernel and copy intervals inside the window,
        sorted: the cards that recorded, in the order of the trace's device
        index, then an empty list for each other card of the cell."""
        lo, hi = self.window
        by_card: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for recs, cards in ((self.kernels, self.kernel_cards), (self.copies, self.copy_cards)):
            if cards and len(cards) != len(recs):
                raise ValueError(f"{len(recs)} device records and {len(cards)} cards")
            for (_, s, d), c in zip(recs, cards or [0] * len(recs)):
                if s + d > lo and s < hi:
                    by_card[c].append((max(s, lo), min(s + d, hi)))
        out = [_union(by_card[c]) for c in sorted(by_card)]
        return out + [[] for _ in range(self.cards - len(out))]

    def device_intervals(self, card: int = 0) -> List[Tuple[int, int]]:
        """The ``card``-th card's union of intervals (``card_intervals``)."""
        return self.card_intervals()[card]

    def card_busy_s(self) -> List[float]:
        """Each card's busy seconds in the window, one entry a card."""
        return [sum(e - s for s, e in iv) / 1e9 for iv in self.card_intervals()]

    def busy_s(self) -> float:
        """The busy seconds of the cell's cards, their mean."""
        busy = self.card_busy_s()
        return sum(busy) / len(busy)

    def kernel_s(self, match: Optional[Tuple[str, ...]] = None) -> float:
        """Seconds of device kernels (those whose name holds one of
        ``match``), summed."""
        return sum(d for n, _, d in self.kernels
                   if match is None or any(m in n for m in match)) / 1e9

    def kernel_count(self, match: Optional[Tuple[str, ...]] = None) -> int:
        return sum(1 for n, _, _ in self.kernels if match is None or any(m in n for m in match))

    def copy_s(self, match: Tuple[str, ...]) -> float:
        return sum(d for n, _, d in self.copies if any(m in n for m in match)) / 1e9

    def span_s(self, name: str) -> Optional[float]:
        got = self.spans.get(name)
        return None if not got else sum(d for _, d in got) / 1e9

    def breakdown(self, n: int = 10) -> Dict[str, List[List]]:
        """The ``n`` device operations that took most time, summed over the
        cards, and the ``n`` longest idle gaps of any card, each named by
        the innermost span open on the host at its middle."""
        by_name: Dict[str, int] = defaultdict(int)
        for name, _, d in self.kernels + self.copies:
            by_name[name] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        for iv in self.card_intervals():
            edges = [self.window[0]] + [x for s, e in iv for x in (s, e)] + [self.window[1]]
            gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                     if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        spans = [(s, s + d, name) for name, v in self.spans.items() for s, d in v]

        def label(mid: int) -> str:
            open_ = [(e - s, name) for s, e, name in spans if s <= mid < e]
            return min(open_)[1] if open_ else "outside every span"

        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": [[label((s + e) // 2), (e - s) / 1e9] for s, e in gaps]}
