"""The batched eq's rows form (``csrc/eq_cascade.cu`` over ``csrc/rows.cuh``)
and the look-back's launch number, modelled on the CPU.

Past the cooperative grid, one CTA walks each block of the batch (a row) in
tiles of T threads of L samples, carrying the entry state in registers
(carry' = A^n carry + the tile's aggregate, every thread alike).  The
region's EQ op carries the same state across its tiles with a decoupled
look-back (``csrc/region.cu`` ``eq_op_rows``): its rows' tiles are dealt out
by ticket, and each tile folds the aggregates of the tiles before it onto
the nearest published inclusive state.  Here:

  * ``eq_cuda.batch_plan`` / ``rows_plan`` at their edges: which form each
    B x S takes, the tiles a row, the CTAs against the card and the
    refusals past the limits; the tile against the kernel's source;
  * the kernels' arithmetic in their order, in numpy (f32, a separate
    multiply and add): each tile's scan (pass 1, the warp scan, every warp's
    own scan of the warp totals), the carry folded by one CTA or by the
    look-back with tiles finishing in a random order (the same bits either
    way), pass 2 from each thread's entry: within 2e-5 of
    ``eq_cascade_torch_batched`` and of ``jax.vmap(eq_cascade_pallas)`` in
    interpret mode at S = tile - 1, tile, tile + 1, a last tile of one chunk
    of 128, 12,000 and 96,000;
  * the launch number of ``csrc/rows.cuh`` (the status scratch's header on
    the device): a recorded sequence of launches with late CTAs, a refused
    launch, a regrown scratch, captured launches replayed and two host
    threads never reads a stale status word as ready, where a number held on
    the host and frozen into a replayed graph does;
  * ``kernels.status_scratch`` under two threads and while a stream
    captures.

The kernels themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s batched paths and look-back phase).
"""

import re
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu.dsp import eq_pallas as jax_eq_pallas
from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.dsp import envelope_cuda, eq_cuda
from mixlab_tpu_torch.dsp.eq_three import VSA
from tests.test_torch_eq_scan import (F32, _absorb, _apply_bits, _coeffs, _mv, _shift, _step,
                                      _warp_scan)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mixlab_tpu_torch" / "csrc"
EQ_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_eq_pallas.py:110
# what an H100 holds at once (132 SMs; the occupancy queries of the rows
# sweeps in PERF.md §6): the cooperative grid's CTAs and one CTA a row's at
# 128 x 16 (the model needs only numbers; the kernels ask the
# occupancy query)
N_SM = 132
EQ_GRID, EQ_ROWS = 6 * N_SM, 4 * N_SM
GRID, ROWS = eq_cuda.FORM_GRID, eq_cuda.FORM_ROWS
LOOK = "look-back"  # the model's fold of the region EQ op's look-back
T0, L0 = eq_cuda.ROWS_THREADS, eq_cuda.ROWS_RUN
TILE = T0 * L0


# --- the plans at their edges ----------------------------------------------


def _grid(S, B, run, tiles):
    return (GRID, run, tiles, tiles * B, eq_cuda.THREADS)


def _rows(S, B):
    return (ROWS, L0, -(-S // TILE), min(B, EQ_ROWS), T0)


@pytest.mark.parametrize("S,B,want", [
    # the cooperative grid while B x its CTAs fit the card (run doubled up to 32)
    (12_000, 2, _grid(12_000, 2, 4, 24)),
    (12_000, 33, _grid(12_000, 33, 4, 24)),
    (12_000, 34, _grid(12_000, 34, 8, 12)),
    (12_000, 264, _grid(12_000, 264, 32, 3)),
    (96_000, 32, _grid(96_000, 32, 32, 24)),
    (96_000, 8, _grid(96_000, 8, 8, 94)),
    (44_100, 1, _grid(44_100, 1, 4, 87)),
    # past it, one CTA a row where the rows fill the card
    (12_000, 265, _rows(12_000, 265)),
    (12_000, 660, _rows(12_000, 660)),  # two waves of rows against five of tiles
    (12_000, 1024, _rows(12_000, 1024)),
    (12_000, 8192, _rows(12_000, 8192)),
    (TILE, 800, _rows(TILE, 800)),  # one tile a row: no carry to pass
    # a few long rows past the grid: one CTA a row still (no path sends
    # them; the look-back measured slower than the grid at the stems')
    (384_000, 16, _rows(384_000, 16)),
    (96_000, 34, _rows(96_000, 34)),
    (96_000, 64, _rows(96_000, 64)),
])
def test_eq_batch_plan_takes_each_form_at_its_edges(S, B, want):
    assert eq_cuda.batch_plan(S, B, EQ_GRID, EQ_ROWS) == want


@pytest.mark.parametrize("S", [TILE - 1, TILE + 1, 12_000, 38_400, 96_000])
@pytest.mark.parametrize("B", [1, 8, 32, 256, 527, 528, 1024, 8192])
def test_eq_rows_plan_fills_the_card(S, B):
    """Every rows plan: one CTA a row in tiles of ``ROWS_THREADS`` x
    ``ROWS_RUN``, the last tile holding sample S-1, over the card's CTAs or
    one a row."""
    plan = eq_cuda.rows_plan(S, B, EQ_ROWS)
    assert plan == _rows(S, B)
    assert (plan.tiles - 1) * TILE < S <= plan.tiles * TILE
    assert plan.ctas == (B if B <= EQ_ROWS else EQ_ROWS)


def test_eq_rows_plan_refuses_past_its_limits():
    for S, B, res in ((0, 4, EQ_ROWS), (4096, 0, EQ_ROWS), (4096, 4, 0)):
        with pytest.raises(ValueError, match="no rows form"):
            eq_cuda.rows_plan(S, B, res)
    with pytest.raises(ValueError, match="limits"):
        eq_cuda.rows_plan(2**30, 2**12, EQ_ROWS)
    assert eq_cuda.rows_plan(2**30 - TILE, 2**12, EQ_ROWS).tiles == 2**19 - 1


def test_eq_rows_sizes_are_the_kernels():
    """The wrapper's tile is the kernel's (128 x 16), two staged buffers of
    x and xd at L + 4 floats a run; the launch's number in a 4-word
    header."""
    src = (CSRC / "eq_cascade.cu").read_text()
    assert re.search(r"constexpr int kRowsThreads = (\d+);", src).group(1) == str(T0)
    assert 1 << int(re.search(r"constexpr int kRowsLg = (\d+);", src).group(1)) == L0
    assert ("kRowsFloats = 4 * static_cast<size_t>(kRowsThreads) * ((1 << kRowsLg) + 4);"
            in src)
    assert "eq_lookback_kernel" not in src
    rows = (CSRC / "rows.cuh").read_text()
    assert re.search(r"kHeader = (\d+);", rows).group(1) == "4"
    # two buffers of x and xd at the kernel's tile fit a CTA's shared memory
    assert 2 * 2 * T0 * (L0 + 4) * 4 <= 227 * 1024


# --- the kernels' arithmetic, in their order --------------------------------


def tile_scans(xs, tab, a, f, T, L):
    """Each tile's own scan (``tile_scan``: T threads of L samples; every
    warp scans the warp totals as warp 0 of ``eq_scan::scan_up`` does),
    vectorised over tiles: (E [tiles, T, 2, 4] each thread's entry from zero
    state at its tile's start, M [T, 2, 4] = A^(L*thread), agg [tiles, 2, 4]
    the tile's zero-state result)."""
    tiles, W = xs.shape[0], T // 32
    lg = L.bit_length() - 1
    v = np.zeros((tiles, T, 2, 4), F32)
    for j in range(L):
        v = _step(v, xs[:, :, j], a, f)
    v = v.reshape(tiles, W, 32, 2, 4)
    incl = _warp_scan(v, tab, lg, 32, axis=2)
    e = _shift(incl, 1, axis=2)
    e[:, :, 0] = 0.0
    wv = _warp_scan(incl[:, :, 31], tab, lg + 5, W, axis=1)
    Ew = np.zeros_like(wv)
    Ew[:, 1:] = wv[:, :-1]
    ident = np.zeros((32, 2, 4), F32)
    ident[..., 0] = 1.0
    M_lane = _apply_bits(ident, np.arange(32), tab, lg, 5)
    E = _mv(M_lane[None, None], Ew[:, :, None]) + e
    M = _apply_bits(np.broadcast_to(M_lane, (W, 32, 2, 4)), np.arange(W)[:, None], tab,
                    lg + 5, W.bit_length() - 1)
    return E.reshape(tiles, T, 2, 4), M.reshape(T, 2, 4), wv[:, W - 1]


def lookback_entries(agg, y0, tab, ltile, order):
    """The look-back's entry state of every tile, the tiles taken in
    ``order``: a tile whose 32 tiles before it hold no published inclusive
    state waits (goes to the back of the queue); else it folds the
    aggregates after the nearest one (before tile 0: the row's poles) and
    publishes its own inclusive state A^n y + agg."""
    incl, entries, queue = {}, {}, list(order)
    while queue:
        t = queue.pop(0)
        lanes = [t - 32 + k for k in range(32)]
        done = [i for i in lanes if i < 0 or i in incl]
        if not done:
            queue.append(t)
            continue
        p = max(done)
        y = y0 if p < 0 else incl[p]
        for j in range(p + 1, t):
            y = _absorb(agg[j], y, tab, ltile)
        entries[t] = y
        incl[t] = _absorb(agg[t], y, tab, ltile)
    return [entries[t] for t in range(len(order))]


def model_eq_rows(x, xd, poles0, gains, f_lo, f_hi, form, T=T0, L=L0, order=None):
    """One row of S samples in tiles of T x L: (out [S], poles [4, 2] at
    S-1).  ``FORM_ROWS``: the CTA's register carry, y <- A^n y + agg, tile by
    tile; ``LOOK``: the entries of the region EQ op's look-back
    (``lookback_entries``) with the tiles finishing in ``order`` (default:
    in order)."""
    S, n = x.shape[0], T * L
    tiles = -(-S // n)
    tab = eq_cuda.kernel_tables(f_lo, f_hi)
    a = tab[eq_cuda.TABLE_A:eq_cuda.TABLE_A + 2]
    f = np.array([f_lo, f_hi], F32)
    ltile = (L.bit_length() - 1) + (T.bit_length() - 1)
    xs, xds = np.zeros(tiles * n, F32), np.zeros(tiles * n, F32)
    xs[:S], xds[:S] = x, xd
    xs, xds = xs.reshape(tiles, T, L), xds.reshape(tiles, T, L)
    E, M, agg = tile_scans(xs, tab, a, f, T, L)
    y0 = poles0.astype(F32).T.copy()  # [band, stage]
    if form == LOOK:
        entries = lookback_entries(agg, y0, tab, ltile, order or range(tiles))
    else:
        entries, y = [], y0
        for t in range(tiles):
            entries.append(y)
            y = _absorb(agg[t], y, tab, ltile)
    st = _mv(M[None], np.stack(entries)[:, None]) + E  # [tiles, T, 2, 4]
    out = np.empty((tiles, T, L), F32)
    last = divmod(S - 1, n)
    for j in range(L):
        st = _step(st, xs[:, :, j], a, f)
        lo, hi = st[..., 0, 3], st[..., 1, 3]
        out[:, :, j] = lo * gains[0] + (hi - lo) * gains[1] + (xds[:, :, j] - hi) * gains[2]
        if last[1] % L == j:
            poles = st[last[0], last[1] // L].T.copy()
    return out.reshape(-1)[:S], poles


def _rows_batch(B, S, seed):
    """B rows: x, xd (x delayed by 3 after a random history), poles, gains."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, S)).astype(F32)
    hist = rng.uniform(-1, 1, (B, 3)).astype(F32)
    xd = np.concatenate([hist, x], axis=1)[:, :S].copy()
    poles = rng.uniform(-0.1, 0.1, (B, 4, 2)).astype(F32)
    gains = rng.uniform(0.5, 2.0, (B, 3)).astype(F32)
    return x, xd, poles, gains


_JAX = {}


def _pallas_vmap(f_lo, f_hi):
    key = (f_lo, f_hi)
    if key not in _JAX:
        _JAX[key] = jax.jit(jax.vmap(lambda x, xd, p, g: jax_eq_pallas.eq_cascade_pallas(
            x, xd, p, g, f_lo, f_hi, VSA)))
    return _JAX[key]


def _twin(x, xd, poles, gains, f_lo, f_hi):
    out, p = eq_cuda.eq_cascade_torch_batched(
        torch.from_numpy(x), torch.from_numpy(xd), torch.from_numpy(poles),
        torch.from_numpy(gains), f_lo, f_hi, VSA)
    return out.numpy(), p.numpy()


# S: one sample short of a tile, a tile, one past it (a last tile of one
# sample), a last tile of one chunk of 128, the fleet's 15-tick block and
# config 3's
EQ_S = [TILE - 1, TILE, TILE + 1, 2 * TILE + 128, 12_000, 96_000]


@pytest.mark.parametrize("form", [ROWS, LOOK])
@pytest.mark.parametrize("S", EQ_S)
def test_eq_rows_model_matches_the_twin_and_the_pallas_kernel(S, form):
    """Two rows with their own poles and gains, 2 carried blocks (the
    model's poles feed its next block): output and poles within 2e-5 of the
    batched twin and of ``jax.vmap(eq_cascade_pallas)`` from the same
    poles."""
    f_lo, f_hi = _coeffs(48_000)
    B = 2
    x, xd, poles, gains = _rows_batch(B, 2 * S, S)
    pm, pt = poles.copy(), poles.copy()
    for blk in range(2):
        sl = slice(blk * S, (blk + 1) * S)
        xb, xdb = np.ascontiguousarray(x[:, sl]), np.ascontiguousarray(xd[:, sl])
        want, pt_next = _twin(xb, xdb, pt, gains, f_lo, f_hi)
        jout, jpoles = (np.asarray(v) for v in _pallas_vmap(f_lo, f_hi)(
            jnp.asarray(xb), jnp.asarray(xdb), jnp.asarray(pm), jnp.asarray(gains)))
        got = [model_eq_rows(xb[b], xdb[b], pm[b], gains[b], f_lo, f_hi, form) for b in range(B)]
        for b, (out, p) in enumerate(got):
            tag = f"block {blk} row {b}"
            np.testing.assert_allclose(out, want[b], **EQ_TOL, err_msg=tag)
            np.testing.assert_allclose(p, pt_next[b], **EQ_TOL, err_msg=tag)
            np.testing.assert_allclose(out, jout[b], **EQ_TOL, err_msg=tag)
            np.testing.assert_allclose(p, jpoles[b], **EQ_TOL, err_msg=tag)
        pm = np.stack([p for _, p in got])
        pt = pt_next


@pytest.mark.parametrize("T,L", [(64, 16), (128, 8), (128, 32), (256, 8), (256, 16),
                                 (256, 32)])
def test_eq_rows_model_at_every_swept_tile(T, L):
    """Other CTA sizes and runs of the kernel's tile (the rows sweep's,
    recorded in PERF.md), at the fleet's 12,000: one CTA a row within 2e-5
    of the twin, and the look-back's fold the same bits."""
    f_lo, f_hi = _coeffs(48_000)
    x, xd, poles, gains = _rows_batch(1, 12_000, T + L)
    want, pwant = _twin(x, xd, poles, gains, f_lo, f_hi)
    rows = model_eq_rows(x[0], xd[0], poles[0], gains[0], f_lo, f_hi, ROWS, T, L)
    look = model_eq_rows(x[0], xd[0], poles[0], gains[0], f_lo, f_hi, LOOK, T, L)
    np.testing.assert_allclose(rows[0], want[0], **EQ_TOL)
    np.testing.assert_allclose(rows[1], pwant[0], **EQ_TOL)
    assert rows[0].tobytes() == look[0].tobytes() and rows[1].tobytes() == look[1].tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_eq_lookback_gives_the_same_bits_in_any_finishing_order(seed):
    """96,000 samples (47 tiles, more than a look-back window of 32) with
    the tiles finishing in a random order: the entries of the region EQ
    op's look-back, so the output and the poles, are the bits of one CTA's
    fold in order (every tile's inclusive state is the same fold,
    whichever tile a look-back finds)."""
    f_lo, f_hi = _coeffs(48_000)
    S = 96_000
    x, xd, poles, gains = _rows_batch(1, S, 100 + seed)
    order = list(np.random.default_rng(seed).permutation(-(-S // TILE)))
    look = model_eq_rows(x[0], xd[0], poles[0], gains[0], f_lo, f_hi, LOOK, order=order)
    rows = model_eq_rows(x[0], xd[0], poles[0], gains[0], f_lo, f_hi, ROWS)
    assert look[0].tobytes() == rows[0].tobytes()
    assert look[1].tobytes() == rows[1].tobytes()


# --- the launch number (csrc/rows.cuh), modelled -----------------------------

AGG, INCL = 1, 2


def _tag(seq, state):
    return (seq * 4 + state) & 0xFFFFFFFF


class StatusModel:
    """A status scratch: the header (launches ended, ticket counter, CTAs
    ended, pad) and a flag a tile; ``writer`` records which launch wrote
    each flag last."""

    def __init__(self, n_tiles):
        self.hdr = [0, 0, 0, 0]
        self.flag = [0] * n_tiles
        self.writer = [None] * n_tiles
        # the earlier protocol's alternating ticket counters
        self.tickets = [0, 0]


def _cta(st, batch, tiles, ctas, launch, seq_host, count):
    """One CTA of a look-back launch as a generator (a yield between its
    steps): its number (the device's, or ``seq_host`` in the earlier
    protocol), tickets, each tile's aggregate flag, its look-back (waiting
    while the window is not ready; every flag it relies on must be this
    launch's, else ``count["stale"]`` counts it), its inclusive flag,
    leaving."""
    total = batch * tiles
    seq = st.hdr[0] + 1 if seq_host is None else seq_host
    yield
    while True:
        if seq_host is None:
            t = st.hdr[1]
            st.hdr[1] += 1
        else:
            st.tickets[(seq + 1) & 1] = 0
            t = st.tickets[seq & 1]
            st.tickets[seq & 1] += 1
        yield
        if t >= total:
            break
        row, tile = divmod(t, tiles)
        count["tiles"] += 1
        st.flag[t], st.writer[t] = _tag(seq, AGG), launch
        yield
        while True:
            idx = [tile - 32 + k for k in range(32)]
            flags = [_tag(seq, INCL) if i < 0 else st.flag[row * tiles + i] for i in idx]
            ready = [k for k, fl in enumerate(flags) if fl == _tag(seq, INCL)]
            if ready:
                pl = ready[-1]
                if all(fl in (_tag(seq, INCL), _tag(seq, AGG)) for fl in flags[pl + 1:]):
                    used = [row * tiles + i for i in idx[pl:] if i >= 0]
                    count["stale"] += sum(st.writer[u] != launch for u in used)
                    break
            yield
        st.flag[t], st.writer[t] = _tag(seq, INCL), launch
        yield
    if seq_host is None:
        st.hdr[2] += 1
        if st.hdr[2] == ctas:
            st.hdr[1] = st.hdr[2] = 0
            st.hdr[0] = seq


def run_launch(st, batch, tiles, ctas, launch, rng, seq_host=None, late=False):
    """Run a launch's ``ctas`` CTAs interleaved at random (``late``: the
    last one starts only once the others took their last ticket).  Returns
    (the number the launch ran under, stale flags relied on, tiles run)."""
    count = {"stale": 0, "tiles": 0}
    seq = st.hdr[0] + 1 if seq_host is None else seq_host
    gens = [_cta(st, batch, tiles, ctas, launch, seq_host, count) for _ in range(ctas)]
    held = gens.pop() if late else None
    while gens:
        g = gens[rng.integers(len(gens))]
        try:
            next(g)
        except StopIteration:
            gens.remove(g)
        if not gens and held is not None:
            gens, held = [held], None
    return seq, count["stale"], count["tiles"]


# a recorded sequence of launches on one stream: ("launch", batch, tiles,
# ctas), ("refused",): a launch the runtime refused, which never runs;
# ("regrow",): the wrapper's scratch grown (zeroed anew); ("replay", n): the
# last launch captured into a graph and replayed n times
SCENARIOS = {
    "stream": [("launch", 2, 40, 8)] * 4,
    "late CTA": [("launch", 1, 70, 5), ("launch", 3, 10, 31)],
    "refused": [("launch", 2, 12, 6), ("refused",), ("launch", 2, 12, 6)],
    "regrown": [("launch", 1, 8, 4), ("launch", 1, 8, 4), ("regrow",), ("launch", 2, 33, 12)],
    "replayed": [("launch", 2, 40, 9), ("replay", 4), ("launch", 1, 40, 3), ("replay", 2)],
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_launch_number_on_the_device_never_reads_a_stale_word(name, seed):
    """Every launch runs under one more than the launches that ended on
    its scratch (1 after a regrow; a refused launch takes none), and no
    look-back relies on a flag an earlier launch wrote, with late CTAs and
    captured launches replayed."""
    rng = np.random.default_rng(seed)
    st, want, launch, last = StatusModel(200), 1, 0, None
    for op in SCENARIOS[name]:
        if op[0] == "regrow":
            st, want = StatusModel(200), 1
            continue
        if op[0] == "refused":
            continue
        runs = [op[1:]] if op[0] == "launch" else [last] * op[1]
        for args in runs:
            launch += 1
            seq, stale, ran = run_launch(st, *args, launch, rng, late=name == "late CTA")
            assert (seq, stale, ran) == (want, 0, args[0] * args[1]), (op, launch)
            assert st.hdr[:3] == [seq, 0, 0]
            want += 1
        last = runs[-1]


def test_a_number_held_on_the_host_goes_wrong_when_replayed():
    """The protocol this replaces: the host's number, frozen into a captured
    launch.  A replay finds its ticket counter where the last replay left
    it and runs no tile; once an eager launch on fewer tiles has cleared
    that counter, the replay relies on flags the capture's run wrote."""
    rng = np.random.default_rng(0)
    st = StatusModel(200)
    assert run_launch(st, 2, 40, 9, 1, rng, seq_host=1) == (1, 0, 80)
    assert run_launch(st, 2, 40, 9, 2, rng, seq_host=1) == (1, 0, 0)  # no tile ran
    assert run_launch(st, 1, 40, 9, 3, rng, seq_host=2) == (2, 0, 40)  # eager, one row
    seq, stale, ran = run_launch(st, 2, 40, 9, 4, rng, seq_host=1)
    assert ran == 80 and stale > 0


def _stand_in(monkeypatch, capturing):
    """``kernels`` with CPU scratches, stream 7, ``capturing[0]`` as the
    stream's capture state, and a stand-in for the envelope's launch that
    runs the header's protocol on the scratch the wrapper passed (by its
    address): -> (the scratches made, the numbers and scratch sizes the
    launches ran with)."""
    scratches, numbers, sizes = {}, [], []

    def zeros(nbytes, index):
        t = torch.zeros(nbytes, dtype=torch.uint8)
        scratches[t.data_ptr()] = t
        return t

    def launch(name, what, index, *args):
        assert name == "mixlab_envelope_block" and args[4] == envelope_cuda.FORM_LOOKBACK
        hdr = scratches[args[8]].view(torch.int32)
        seq = int(hdr[0]) + 1  # every CTA reads it; the last to leave advances it
        numbers.append(seq)
        sizes.append(scratches[args[8]].numel())
        hdr[0] = seq

    monkeypatch.setattr(kernels, "_zeros", zeros)
    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "_status", {})
    monkeypatch.setattr(kernels, "_captured_status", {})
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    return scratches, numbers, sizes


def _envelope_lookback(B, tiles=3):
    """One look-back call of the envelope's wrapper over B rows of 3 tiles
    (CPU tensors: only the stand-in launch reads them)."""
    lane = envelope_cuda.ROWS_LANES[0]
    S = tiles * envelope_cuda.THREADS * lane
    x = torch.zeros(B, S)
    state = {"mode_on": torch.zeros(B, dtype=torch.bool),
             "on_pos": torch.zeros(B, dtype=torch.int32),
             "off_pos": torch.zeros(B, dtype=torch.int32), "off_amp": torch.zeros(B)}
    params = {k: torch.ones(B) for k in envelope_cuda._PARAMS}
    plan = envelope_cuda.BatchPlan(envelope_cuda.FORM_LOOKBACK, lane, tiles, 4)
    envelope_cuda._launch(x, 0, state, params, 1000 / 48_000, plan=plan)


def test_status_scratch_under_two_threads(monkeypatch):
    """Two host threads, 200 look-back calls each through the envelope's
    wrapper on one stream: one scratch for the stream, grown (zeroed anew)
    and never shrunk, and every launch a number of its own, in the stream's
    order."""
    scratches, numbers, sizes = _stand_in(monkeypatch, [False])

    def calls(k):
        for i in range(200):
            _envelope_lookback(1 + (i * 7 + k) % 5)

    threads = [threading.Thread(target=calls, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(kernels._status) == 1
    (scratch,) = kernels._status.values()
    assert scratch.numel() >= 16 + envelope_cuda.STATUS_BYTES * 5 * 3
    assert sizes == sorted(sizes)
    # a regrown scratch starts at 1 again; within one, the numbers count up
    runs, prev = [], None
    for seq, size in zip(numbers, sizes):
        if size != prev:
            runs.append([])
        runs[-1].append(seq)
        prev = size
    assert all(r == list(range(1, len(r) + 1)) for r in runs)
    assert sum(map(len, runs)) == 400


def test_status_scratch_refuses_to_be_made_while_capturing(monkeypatch):
    """A look-back launch captured on a stream with no scratch, or with one
    too small, is refused before it launches: a scratch made in the capture
    would be zeroed only when the graph replays."""
    capturing = [True]
    _, numbers, _ = _stand_in(monkeypatch, capturing)
    with pytest.raises(RuntimeError, match="status scratch"):
        _envelope_lookback(2)
    assert kernels._status == {} and numbers == []
    capturing[0] = False
    _envelope_lookback(2)  # the warm-up on the stream
    capturing[0] = True
    with pytest.raises(RuntimeError, match="status scratch"):
        _envelope_lookback(4000)  # past the scratch's size
    assert numbers == [1]


def test_status_scratch_a_capture_used_outlives_a_regrow(monkeypatch):
    """The scratch a capture launched on stays alive after the stream's
    scratch is regrown (the graph keeps its address); the captured launch
    and the eager ones each count on their own scratch."""
    capturing = [False]
    scratches, numbers, _ = _stand_in(monkeypatch, capturing)
    _envelope_lookback(2)
    capturing[0] = True
    _envelope_lookback(2)  # the capture: the scratch the warm-up made
    (key, first), = kernels._status.items()
    assert kernels._captured_status == {first.data_ptr(): first}
    capturing[0] = False
    _envelope_lookback(4000)  # regrown
    assert kernels._status[key] is not first
    assert kernels._captured_status[first.data_ptr()] is first
    assert numbers == [1, 2, 1]
