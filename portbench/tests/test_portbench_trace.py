"""``Records`` read on hand-built traces of one card and of several: each
card's busy time and idle gaps are its own, the busy time is their mean over
the cell's cards, and a card that recorded nothing is idle all the window.
On one card every reading is the union's, as it was before the cards were
kept apart."""

import random

import pytest

from portbench import harness
from portbench.program_spans import PREFIX
from portbench.trace import Records

BENCH = harness.benchmark()


def _records(**cards):
    """The records of ``test_records_read_as_the_metrics_expect``, with
    ``cards`` (the card lists and count) added."""
    rec = Records(kernels=[("region_rows_kernel", 100, 50), ("eq_rows_kernel", 120, 60)],
                  copies=[("Memcpy HtoD (Pageable -> Device)", 300, 100)],
                  window=(0, 1000), units=2,
                  facts={"region.launches": 2, "region.bytes": 3.35e3, "eq.launches": 2,
                         "eq.bytes": 1.0, "sessions": 1, "samples_per_block": 1,
                         "state_bytes": 0, "param_bytes": 0}, **cards)
    rec.spans["fleet.host_aux"] = [(0, 90), (500, 10)]
    rec.spans["fleet.block"] = [(0, 1000)]
    return rec


def _union_readings(rec):
    """The busy seconds and idle gaps of the union of every kernel and copy
    interval, as ``Records`` read them before it kept the cards apart."""
    lo, hi = rec.window
    iv = sorted((max(s, lo), min(s + d, hi)) for _, s, d in rec.kernels + rec.copies
                if s + d > lo and s < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    edges = [lo] + [x for s, e in out for x in (s, e)] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    return sum(e - s for s, e in out) / 1e9, sorted(gaps, key=lambda g: g[0] - g[1])[:10]


def test_one_card_reads_every_metric_as_the_union():
    """The same records on one card whose trace index is not 0 read, metric
    by metric, what they read without card lists."""
    plain, on_card = _records(), _records(kernel_cards=[3, 3], copy_cards=[3])
    assert on_card.device_intervals() == plain.device_intervals() == [(100, 180), (300, 400)]
    assert on_card.card_busy_s() == [plain.busy_s()] and on_card.busy_s() == plain.busy_s()
    assert on_card.breakdown() == plain.breakdown()
    for m in BENCH["per_layer"]:
        reader = harness.metric(m["name"])
        assert reader.read(on_card) == reader.read(plain), m["name"]


@pytest.mark.parametrize("seed", range(4))
def test_one_card_busy_and_gaps_are_the_union_bit_for_bit(seed):
    rng = random.Random(seed)
    kernels = [(f"k{rng.randrange(5)}", rng.randrange(-50, 1000), rng.randrange(1, 60))
               for _ in range(200)]
    copies = [("Memcpy", rng.randrange(0, 1000), rng.randrange(1, 30)) for _ in range(30)]
    rec = Records(kernels=kernels, copies=copies, kernel_cards=[7] * 200, copy_cards=[7] * 30,
                  window=(0, 990), units=1)
    rec.spans["a"] = [(0, 400)]
    busy, gaps = _union_readings(rec)
    assert rec.busy_s() == busy
    assert rec.breakdown()["idle_gaps"] == [["a" if (s + e) // 2 < 400 else "outside every span",
                                             (e - s) / 1e9] for s, e in gaps]


def test_two_cards_read_each_card_and_their_mean():
    """Cards 5 and 2 of the trace take turns: each card's busy time is its
    own, the mean is not the union (350 ns), and each card's gaps are its
    own (the union's gaps would be 200-300 and 450-1000)."""
    rec = Records(kernels=[("a", 0, 100), ("b", 100, 100), ("a", 300, 100)],
                  copies=[("Memcpy DtoH", 400, 50)], kernel_cards=[5, 2, 5], copy_cards=[2],
                  window=(0, 1000), units=1, cards=2)
    rec.spans["block"] = [(0, 1000)]
    rec.spans["upload"] = [(690, 20)]
    assert rec.card_intervals() == [[(100, 200), (400, 450)], [(0, 100), (300, 400)]]
    assert rec.card_busy_s() == [150e-9, 200e-9]
    assert rec.busy_s() == pytest.approx(175e-9)
    assert harness.metric("device_idle_pct.fleet").read(rec) == pytest.approx(82.5)
    b = rec.breakdown()
    assert b["idle_gaps"] == [["upload", 600e-9], ["block", 550e-9], ["block", 200e-9],
                              ["block", 200e-9], ["block", 100e-9]]
    assert b["device_ops"] == [["a", 200e-9], ["b", 100e-9], ["Memcpy DtoH", 50e-9]]


def test_a_card_that_recorded_nothing_is_idle_all_the_window():
    rec = Records(kernels=[("k", 100 * c, 100) for c in (0, 1, 3)], kernel_cards=[0, 1, 3],
                  window=(0, 1000), units=1, cards=4)
    assert rec.card_busy_s() == [100e-9, 100e-9, 100e-9, 0.0]
    assert rec.busy_s() == pytest.approx(75e-9)
    assert harness.metric("device_idle_pct.fleet").read(rec) == pytest.approx(92.5)
    assert rec.breakdown()["idle_gaps"][0] == ["outside every span", 1000e-9]


# the facts that count the fleet's work, which n identical cards do n times
PER_CARD_FACTS = ("sessions", "state_bytes", "param_bytes")
# the fleet cells' readers, each of which finds something in these records
FLEET_READERS = {"fleet.host_aux_ms", "fleet.device_ms", "fleet_block_roofline", "region_roofline",
                 "eq_roofline", "device_idle_pct.fleet", "fleet.host_arrays_ms", "fleet.upload_ms",
                 "fleet.dispatch_ms", "fleet.fetch_wait_ms"}


def _on_identical_cards(rec, n):
    """``rec``'s twin on ``n`` identical cards: every kernel and copy
    repeated on trace indices 0 to n-1, and the facts that count work
    (``PER_CARD_FACTS``, each ``<family>.launches`` and ``<family>.bytes``)
    times n; the spans, the window and the units as they are."""
    facts = {k: v * n if k in PER_CARD_FACTS or k.endswith((".launches", ".bytes")) else v
             for k, v in rec.facts.items()}
    twin = Records(kernels=rec.kernels * n, copies=rec.copies * n,
                   kernel_cards=[c for c in range(n) for _ in rec.kernels],
                   copy_cards=[c for c in range(n) for _ in rec.copies], cards=n,
                   window=rec.window, units=rec.units, facts=facts)
    twin.spans.update(rec.spans)
    return twin


@pytest.mark.parametrize("n", [2, 4])
def test_n_identical_cards_read_as_one(n):
    """Every per-layer reader that BENCHMARK.json names reads the same on
    n identical cards as on one (nothing where it finds nothing on one):
    each reading is per card, so a card's work repeated on others moves
    none of them."""
    one = _records()
    for name, spans in {"fleet.host.Oscillator": [(0, 30)], "fleet.host.FmSine": [(30, 20)],
                        "fleet.upload": [(60, 40)], "fleet.dispatch": [(100, 80)],
                        "fleet.fetch_wait": [(420, 5)]}.items():
        one.spans[PREFIX + name] = spans
    twin = _on_identical_cards(one, n)
    assert twin.card_busy_s() == [one.busy_s()] * n
    read = set()
    for m in BENCH["per_layer"]:
        reader = harness.metric(m["name"])
        got = reader.read(one)
        want = None if got is None else pytest.approx(got, rel=1e-12, abs=0)
        assert reader.read(twin) == want, m["name"]
        if got is not None:
            read.add(m["name"])
    assert FLEET_READERS <= read


def test_device_time_a_block_counts_a_silent_card_as_nothing():
    """The device time a block is the mean card's: kernels on one card of
    four read a quarter of what they read on one card alone."""
    alone = Records(kernels=[("k", 0, 400)], kernel_cards=[2], window=(0, 1000), units=2)
    of_four = Records(kernels=[("k", 0, 400)], kernel_cards=[2], window=(0, 1000), units=2,
                      cards=4)
    reader = harness.metric("fleet.device_ms")
    assert reader.read(alone) == 1e3 * 400e-9 / 2
    assert reader.read(of_four) == pytest.approx(reader.read(alone) / 4, rel=1e-15, abs=0)


def test_card_lists_of_another_length_than_the_records_are_refused():
    with pytest.raises(ValueError):
        Records(kernels=[("k", 0, 1), ("k", 2, 1)], kernel_cards=[0], window=(0, 5)).busy_s()
