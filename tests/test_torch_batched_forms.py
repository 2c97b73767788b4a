"""The batched rows forms of the envelope and region kernels
(``csrc/rows.cuh``) modelled on the CPU.

A rows form cuts a block of the batch (a row) into tiles.  One CTA walks a
row where the rows alone fill the card; where they do not, a decoupled
look-back deals the rows' tiles out by ticket, and every tile folds the
aggregates of the tiles before it onto the nearest inclusive state.  Here:

  * both wrappers' ``batch_plan`` at their edges: which form each B x S
    takes, the tiles a row, the CTAs against the card, the status sizes and
    the refusals past the limits;
  * the envelope's carry in the kernel's order: each tile's lanes run phase
    A from both entry modes, a block scan composes their records (a warp
    scan of 32 lanes, then of the 8 warp totals), the tiles' aggregates
    carry the state on (one CTA's own carry, or the look-back's concrete
    fold), phase B runs each lane from its entry: bit-equal to
    ``envelope_block_torch_batched`` and within 2e-5 of
    ``jax.vmap(envelope_block_pallas)`` in interpret mode;
  * the region EQ's affine carry in the kernel's order (the tile's scan of
    ``tests/test_torch_eq_scan.py``, then the tiles' aggregates): within
    2e-5 of the twin and of ``eq_cascade_pallas`` in interpret mode.

Tile edges fall on, before and after gate edges, and the last tile holds
one sample (the envelope) or one chunk of 128 (the EQ).  The kernels
themselves run on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
batched paths and batched region).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu.dsp import eq_pallas as jax_eq_pallas
from mixlab_tpu.dsp.envelope_pallas import envelope_block_pallas
from mixlab_tpu_torch.dsp import envelope_cuda as envc
from mixlab_tpu_torch.dsp import eq_cuda
from mixlab_tpu_torch.dsp.eq_three import VSA
from mixlab_tpu_torch.engine import region_cuda as rc
from tests.test_torch_eq_scan import (F32, GAINS, _absorb, _apply_bits, _coeffs, _mv, _shift,
                                      _step, _warp_scan)
from torch_support import tile_edge_gates

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mixlab_tpu_torch" / "csrc"
ENV_ATOL = 2e-5  # tests/test_envelope_pallas.py
EQ_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_eq_pallas.py:110
# what an H100 holds at once (132 SMs): the cooperative grids' CTAs, and the
# rows forms' (the model needs only numbers; the kernels ask the occupancy
# query)
N_SM = 132
ENV_GRID, ENV_ROWS = 2 * N_SM, 4 * N_SM
REGION_GRID, REGION_ROWS = 6 * N_SM, 2 * N_SM
FLAGSHIP = rc.Shape(n_operands=6, n_scratch=8, n_eq=1)
E_GRID, E_ROWS, E_LOOK = envc.FORM_GRID, envc.FORM_ROWS, envc.FORM_LOOKBACK
R_GRID, R_ROWS, R_LOOK = rc.FORM_GRID, rc.FORM_ROWS, rc.FORM_LOOKBACK


# --- the plans at their edges ----------------------------------------------


@pytest.mark.parametrize("S,B,want", [
    # 12,000 samples (3 tiles of 4,096): the grid while B x tiles fit
    (12_000, 1, (E_GRID, 2, 24, 24)),
    (12_000, 11, (E_GRID, 2, 24, 264)),
    (12_000, 12, (E_GRID, 3, 16, 192)),
    (12_000, 88, (E_GRID, 16, 3, 264)),
    # then the look-back over the card's 528 CTAs while its waves of tiles
    # (x 1.25) end before one CTA a block's waves of blocks, else the latter
    (12_000, 89, (E_LOOK, 16, 3, 267)),
    (12_000, 352, (E_LOOK, 16, 3, 528)),
    (12_000, 353, (E_ROWS, 16, 3, 353)),
    (12_000, 1024, (E_ROWS, 16, 3, 1024)),
    (12_000, 8192, (E_ROWS, 16, 3, 8192)),
    # 38,400 and 96,000: tiles of 8,192 (the last one padded under a tenth)
    (38_400, 1024, (E_ROWS, 32, 5, 1024)),
    (38_400, 100, (E_LOOK, 32, 5, 500)),
    (96_000, 11, (E_GRID, 16, 24, 264)),
    (96_000, 12, (E_LOOK, 32, 12, 144)),
    (96_000, 32, (E_LOOK, 32, 12, 384)),
    (4_096, 300, (E_ROWS, 16, 1, 300)),  # one tile a block: no carry to pass
])
def test_envelope_batch_plan_takes_each_form_at_its_edges(S, B, want):
    assert envc.batch_plan(S, B, ENV_GRID, ENV_ROWS) == want


@pytest.mark.parametrize("S", [4096, 4097, 12_000, 38_400, 96_000, 1_000_003])
@pytest.mark.parametrize("B", [1, 2, 12, 33, 89, 200, 527, 528, 1024, 8192])
def test_envelope_rows_plan_fills_the_card(S, B):
    """Every rows plan: the longest lane whose tiles pad a block by under a
    tenth; the look-back exactly where its waves of tiles, at 1.25 a tile,
    end before one CTA a block's, over the card's CTAs (a multiple of the SM
    count) or one a tile; its scratch 16 + 96 B a tile."""
    plan = envc.rows_plan(S, B, ENV_ROWS)
    lane = plan.lane
    assert lane in envc.ROWS_LANES
    tiles = -(-S // (256 * lane))
    assert plan.tiles == tiles and tiles * 256 * lane * 10 < 11 * S or lane == 16
    if lane == 16 and S > 8192:
        assert -(-S // 8192) * 8192 * 10 >= 11 * S
    waves = lambda n: -(-n // ENV_ROWS)
    if 1.25 * waves(B * tiles) < waves(B) * tiles:
        assert plan == (E_LOOK, lane, tiles, min(ENV_ROWS, B * tiles))
        assert plan.ctas % N_SM == 0 or plan.ctas == B * tiles
    else:
        assert plan == (E_ROWS, lane, tiles, B)


def test_envelope_rows_plan_refuses_past_its_limits():
    for S, B, lane in ((0, 4, 16), (4096, 0, 16), (4096, 4, 3), (4096, 4, 64),
                       (2**29, 2**20, 16)):
        with pytest.raises(ValueError):
            envc.rows_plan(S, B, ENV_ROWS, lane=lane)
    # the wrapper's record sizes and limits are the kernel's
    env = (CSRC / "envelope.cu").read_text()
    assert re.search(r"sizeof\(Status\) == (\d+)", env).group(1) == str(envc.STATUS_BYTES)
    assert re.search(r"kMaxRowsLane = (\d+);", env).group(1) == str(max(envc.ROWS_LANES))


@pytest.mark.parametrize("S,B,want", [
    (12_800, 1, (R_GRID, 4, 25, 25)),
    (12_800, 198, (R_GRID, 32, 4, 792)),
    # past the grid, tiles of 1,024: one CTA a row unless a few long rows
    # leave most of the card's 264 CTAs idle
    (12_800, 199, (R_ROWS, 8, 13, 199)),
    (12_800, 264, (R_ROWS, 8, 13, 264)),
    (12_800, 1024, (R_ROWS, 8, 13, 1024)),
    (12_800, 8192, (R_ROWS, 8, 13, 8192)),
    (38_400, 1024, (R_ROWS, 8, 38, 1024)),
    (102_400, 8, (R_GRID, 16, 50, 400)),
    (102_400, 64, (R_LOOK, 8, 100, 264)),
    (512, 1000, (R_ROWS, 8, 1, 1000)),  # one tile a row: no carry to pass
])
def test_region_batch_plan_takes_each_form_at_its_edges(S, B, want):
    assert rc.batch_plan(S, B, REGION_GRID, FLAGSHIP, REGION_ROWS) == want


@pytest.mark.parametrize("shape,run", [
    (FLAGSHIP, 8),              # 91,280 B a CTA
    (rc.Shape(3, 8, 1), 8),     # the sink zoo's
    (rc.Shape(2, 0, 0), 8),     # a PEAK plan's
    (rc.Shape(24, 40, 2), 4),   # 185,584 B a CTA at 4 chunks
    (rc.Shape(32, 90, 3), 2),
    (rc.Shape(32, 300, 4), 1),
])
def test_region_rows_tile_fits_shared_memory(shape, run):
    """The rows forms' tile: ``ROWS_RUN`` chunks, halved while two staged
    buffers of the operands, the scratch tiles, the EQ's tile and 24 floats
    an EQ op (and an entry of 12) do not fit 200 KB; the C side's size
    agrees."""
    assert rc.rows_run(shape) == run
    assert rc.rows_shared_bytes(shape, run) <= rc.ROWS_SHARED
    if run < rc.ROWS_RUN:
        assert rc.rows_shared_bytes(shape, 2 * run) > rc.ROWS_SHARED
    src = (CSRC / "region.cu").read_text()
    body = src[src.index("constexpr size_t rows_floats("):]
    body = body[:body.index("}")]
    assert "(2 * n_operands + n_scratch) * kChunk * run" in body
    assert "tile_floats(kChunk, run)" in body and "(2 * n_eq + 1) * kCarry" in body
    assert re.search(r"kCarry = (\d+);", src).group(1) == "12"
    assert re.search(r"kRecord = (\d+);", src).group(1) == str(rc.RECORD_BYTES // 4)


def test_region_rows_plan_refuses_past_its_limits():
    with pytest.raises(ValueError, match="shared memory"):
        rc.rows_run(rc.Shape(33, 0, 0))
    with pytest.raises(ValueError, match="shared memory"):
        rc.rows_run(rc.Shape(32, 400, 1))
    with pytest.raises(ValueError, match="limits"):
        rc.rows_plan(4096 * 128, 2**22, FLAGSHIP, REGION_ROWS)
    assert rc.rows_plan(512, 3, FLAGSHIP, REGION_ROWS) == (R_ROWS, 8, 1, 3)
    assert rc.rows_plan(12_800, 3, FLAGSHIP, REGION_ROWS) == (R_LOOK, 8, 13, 39)


# --- the envelope's carry, in the kernel's order ----------------------------

THREADS, WARPS = envc.THREADS, envc.THREADS // 32
CONC, ENTRY, ON = 0, 1, 2  # off_amp record kinds (csrc/envelope.cu)


def _clip01(v):
    return F32(1.0) if v > 1.0 else (F32(0.0) if v < 0.0 else v)


def _since(t, pos):
    """f32 of the int32 difference t - pos (two's-complement wrap)"""
    return np.array(t - pos, np.int64).astype(np.int32).astype(F32)[()]


def _amp_on_at(pos, on, p):
    ms = _since(pos, on) * p["msps"]
    attack_amp = ms / p["attack"]
    decay_amp = F32(1.0) - _clip01((ms - p["attack"]) / p["decay"])
    sustain_amp = p["sustain"] + (F32(1.0) - p["sustain"]) * decay_amp
    return attack_amp if ms < p["attack"] else sustain_amp


def _identity():
    return tuple((e, 1, 0, 1, 0, ENTRY, F32(0.0), 0) for e in range(2))


def _phase_a(xs, base, p):
    """Both entry machines' symbolic records over a lane's samples."""
    out = []
    for e in range(2):
        mode, on_sym, on_pos, off_sym, off_pos, ampk, ampv, ampp = _identity()[e]
        for c, xc in enumerate(xs):
            t = base + c
            if mode == 1 and xc == 0.0:  # falling
                if on_sym == 0:
                    ampk, ampv = CONC, _amp_on_at(t, on_pos, p)
                else:
                    ampk, ampp = ON, t
                mode, off_sym, off_pos = 0, 0, t
            elif mode == 0 and xc == 1.0:  # rising
                mode, on_sym, on_pos = 1, 0, t
        out.append((mode, on_sym, on_pos, off_sym, off_pos, ampk, ampv, ampp))
    return tuple(out)


def _substitute(g, f, p):
    mode, on_sym, on_pos, off_sym, off_pos, ampk, ampv, ampp = g
    o_on = (f[1], f[2]) if on_sym else (0, on_pos)
    o_off = (f[3], f[4]) if off_sym else (0, off_pos)
    if ampk == CONC:
        amp = (CONC, ampv, ampp)
    elif ampk == ENTRY:
        amp = (f[5], f[6], f[7])
    elif f[1] == 0:
        amp = (CONC, _amp_on_at(ampp, f[2], p), ampp)
    else:
        amp = (ON, F32(0.0), ampp)
    return (mode, *o_on, *o_off, *amp)


def _compose(f, g, p):
    """g after f, for both entry modes."""
    return tuple(_substitute(g[f[e][0]], f[e], p) for e in range(2))


def _apply(pair, E, p):
    """The concrete state after a span entered with E = (mode, on, off, amp)."""
    s = pair[E[0]]
    amp = s[6] if s[5] == CONC else (E[3] if s[5] == ENTRY else _amp_on_at(s[7], E[1], p))
    return (s[0], E[1] if s[1] else s[2], E[2] if s[3] else s[4], amp)


def _scan(v, width, p):
    """Inclusive in-order Hillis-Steele scan over ``width`` lanes
    (shfl_up: lane i reads lane i - d)."""
    v = list(v)
    d = 1
    while d < width:
        v = [_compose(v[i - d], v[i], p) if i >= d else v[i] for i in range(len(v))]
        d *= 2
    return v


def _block_scan(recs, p):
    """The CTA's inclusive scan of its lanes: 32-lane warp scans, a scan of
    the 8 warp totals, each warp's lanes after the warps before it."""
    warps = [_scan(recs[w * 32:(w + 1) * 32], 32, p) for w in range(WARPS)]
    tot = _scan([w[31] for w in warps], WARPS, p)
    return [v if w == 0 else _compose(tot[w - 1], v, p)
            for w in range(WARPS) for v in warps[w]]


def _phase_b(xs, base, S, st, p):
    mode, on, off, amp = st
    out = []
    for c, xc in enumerate(xs):
        t = base + c
        if t >= S:
            break
        if mode == 1 and xc == 0.0:
            amp, mode, off = _amp_on_at(t, on, p), 0, t
        elif mode == 0 and xc == 1.0:
            mode, on = 1, t
        if mode == 1:
            out.append(_amp_on_at(t, on, p))
        else:
            ms_off = _since(t, off) * p["msps"]
            out.append(amp * (F32(1.0) - _clip01(ms_off / p["release"])))
    return out


def _padded(x, lane):
    T = THREADS * lane
    xp = np.full(-(-len(x) // T) * T, 0.5, F32)
    xp[:len(x)] = x
    return xp


def tile_prefixes(x, p, lane):
    """Each tile's lanes' inclusive prefixes (phase A and the block scan),
    which no entry state changes."""
    T, xp = THREADS * lane, _padded(x, lane)
    return [_block_scan([_phase_a(xp[t * T + k * lane:t * T + (k + 1) * lane], t * T + k * lane, p)
                         for k in range(THREADS)], p) for t in range(len(xp) // T)]


def model_envelope_row(x, E0, p, lane, form, pres):
    """One row through a rows form, given its ``tile_prefixes``: (out [S],
    exit state).  ``form``: ``FORM_ROWS`` (the CTA's carry: the last lane's
    exit) or ``FORM_LOOKBACK`` (the nearest inclusive state, then the
    aggregates of the tiles after it, each applied concretely)."""
    S, T, xp = len(x), THREADS * lane, _padded(x, lane)
    tiles = len(pres)
    entries, e = [], E0
    for t in range(tiles):
        entries.append(e)
        # either way the state after a tile is its aggregate applied to its
        # entry: the last lane's exit, or the look-back's fold (whichever
        # tile it finds inclusive, its state is this fold's)
        e = _apply(pres[t][-1], e, p)
    out = []
    for t in range(tiles):
        exits = [_apply(pre, entries[t], p) for pre in pres[t]]
        for k in range(THREADS):
            st = entries[t] if k == 0 else exits[k - 1]
            out += _phase_b(xp[t * T + k * lane:t * T + (k + 1) * lane], t * T + k * lane, S,
                            st, p)
    mode, on, off, amp = exits[-1]
    floor = envc.POS_FLOOR
    return np.array(out, F32), (bool(mode), max(on - S, floor), max(off - S, floor), amp)


ENV_PARAMS = [  # attack, decay, sustain, release (ms): one row each
    (25.0, 500.0, 0.8, 200.0), (0.0, 10.0, 0.6, 5.0), (3.0, 0.0, 0.3, 1.0)]
MSPS = 1000.0 / 48_000
# (lane, S): tiles of 256 and 512 samples, S cut so the last tile holds one
# sample (2,561 at either lane) or is one sample short of a whole tile
# (2,559); two lengths, so the JAX kernel compiles twice
ENV_CASES = [(1, 2561), (2, 2561), (2, 2559)]
ENV_FORMS = [E_ROWS, E_LOOK]

_PALLAS_ENV = jax.jit(jax.vmap(lambda x, st, aux: envelope_block_pallas(
    x, st, aux, MSPS, interpret=True)))


def _env_inputs(lane, S, n_blocks=2):
    """[n_blocks, B, S] gates whose edges sit at T-1, T and T+1 of every tile
    boundary (on, before and after the tiles' edges), on the first and last
    sample of a block, and a dense row."""
    T = THREADS * lane
    rng = np.random.default_rng(S)
    edges = tile_edge_gates(np, "tile_edges", S, T, n_blocks, rng).reshape(n_blocks, S)
    every = tile_edge_gates(np, "every_tile", S, T, n_blocks, rng).reshape(n_blocks, S)
    dense = rng.choice([0.0, 1.0, 0.5], size=(n_blocks, S), p=[0.02, 0.02, 0.96])
    return np.stack([edges, every, dense.astype(F32)], axis=1)


@pytest.mark.parametrize("lane,S", ENV_CASES)
def test_envelope_rows_model_equals_the_twin_and_the_pallas_kernel(lane, S):
    """Both rows forms, 2 carried blocks: outputs and state bit-equal to the
    batched twin (any grouping of the exact records gives the same bits),
    within 2e-5 of the JAX kernel under vmap."""
    xs = _env_inputs(lane, S)
    B = xs.shape[1]
    prm = {k: torch.tensor([r[i] for r in ENV_PARAMS], dtype=torch.float32)
           for i, k in enumerate(("attack_ms", "decay_ms", "sustain_amplitude", "release_ms"))}
    st_twin = {"mode_on": torch.zeros(B, dtype=torch.bool),
               "on_pos": torch.full((B,), envc.POS_FLOOR, dtype=torch.int32),
               "off_pos": torch.full((B,), envc.POS_FLOOR, dtype=torch.int32),
               "off_amp": torch.zeros(B)}
    st_jax = {k: jnp.asarray(v.numpy()) for k, v in st_twin.items()}
    aux = {k: jnp.asarray(v.numpy()) for k, v in prm.items()}
    rows = [dict(attack=F32(a), decay=F32(d), sustain=F32(s), release=F32(r), msps=F32(MSPS))
            for a, d, s, r in ENV_PARAMS]
    states = {f: [(False, envc.POS_FLOOR, envc.POS_FLOOR, F32(0.0))] * B for f in ENV_FORMS}
    with np.errstate(divide="ignore", invalid="ignore"):
        for blk in range(xs.shape[0]):
            want, st_twin = envc.envelope_block_torch_batched(
                torch.from_numpy(xs[blk]), st_twin, prm, MSPS)
            got_jax, st_jax = _PALLAS_ENV(jnp.asarray(xs[blk]), st_jax, aux)
            np.testing.assert_allclose(np.asarray(got_jax), want.numpy(), atol=ENV_ATOL)
            pres = [tile_prefixes(xs[blk, b], rows[b], lane) for b in range(B)]
            for form in ENV_FORMS:
                for b in range(B):
                    out, states[form][b] = model_envelope_row(
                        xs[blk, b], states[form][b], rows[b], lane, form, pres[b])
                    tag = f"block {blk} row {b} form {form}"
                    assert out.tobytes() == want[b].numpy().tobytes(), tag
                    mode, on, off, amp = states[form][b]
                    assert (mode, on, off) == (bool(st_twin["mode_on"][b]),
                                               int(st_twin["on_pos"][b]),
                                               int(st_twin["off_pos"][b])), tag
                    assert F32(amp).tobytes() == st_twin["off_amp"][b].numpy().tobytes(), tag
                    np.testing.assert_allclose(out, np.asarray(got_jax[b]), atol=ENV_ATOL)


# --- the region EQ's carry, in the kernel's order ----------------------------

CHUNK, RUN = rc.CHUNK, rc.ROWS_RUN


def _tile_scans(xs, tab, a, f, L):
    """The tiles' own scans (csrc/eq_scan.cuh scan_up, 128 threads of L
    samples), vectorised over tiles: (E [tiles, T, 2, 4] each thread's entry
    from zero state at its tile's start, M [T, 2, 4] = A^(L*thread), agg
    [tiles, 2, 4] the tile's aggregate)."""
    tiles, T = xs.shape[0], CHUNK
    lg, W = L.bit_length() - 1, T // 32
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


def model_eq_rows(x, xd, poles0, gains, f_lo, f_hi, form, L=RUN):
    """The region's EQ op over one row of S samples (a multiple of 128) in a
    rows form: (out [S], poles [4, 2] at S-1).  ``form``: ``FORM_ROWS`` (the
    poles carried exactly from pass 2) or ``FORM_LOOKBACK`` (y <- A^n y + E
    over the tiles' aggregates: whichever tile the look-back finds
    inclusive, its state is this fold's)."""
    S = x.shape[0]
    n = CHUNK * L
    tiles = -(-S // n)
    tab = eq_cuda.kernel_tables(f_lo, f_hi)
    a = tab[eq_cuda.TABLE_A:eq_cuda.TABLE_A + 2]
    f = np.array([f_lo, f_hi], F32)
    lg = L.bit_length() - 1
    ltile = lg + 7
    xs, xds = np.zeros(tiles * n, F32), np.zeros(tiles * n, F32)
    xs[:S], xds[:S] = x, xd
    xs, xds = xs.reshape(tiles, CHUNK, L), xds.reshape(tiles, CHUNK, L)
    E, M, agg = _tile_scans(xs, tab, a, f, L)
    y = poles0.astype(F32).T.copy()  # [band, stage]
    out = np.empty((tiles, CHUNK, L), F32)
    entries = {}
    for t in range(tiles):
        entries[t] = y
        if form == rc.FORM_LOOKBACK:
            y = _absorb(agg[t], y, tab, ltile)
            continue
        st = _mv(M, y) + E[t]  # one CTA a row: pass 2 leaves the tile's last state
        for j in range(L):
            st = _step(st, xs[t, :, j], a, f)
        y = st[-1]
    last = divmod(S - 1, n)
    for t in range(tiles):
        st = _mv(M, entries[t]) + E[t]
        for j in range(L):
            st = _step(st, xs[t, :, j], a, f)
            lo, hi = st[..., 0, 3], st[..., 1, 3]
            out[t, :, j] = lo * gains[0] + (hi - lo) * gains[1] + (xds[t, :, j] - hi) * gains[2]
            if t == last[0] and last[1] % L == j:
                poles = st[last[1] // L].T.copy()
    return out.reshape(-1)[:S], poles


EQ_FORMS = [R_ROWS, R_LOOK]
# 25 tiles of 512 (the fleet's 16-tick block); 16 with a last tile of one
# chunk of 128
EQ_S = [12_800, 15 * 512 + 128]

_PALLAS_EQ = jax.jit(jax_eq_pallas.eq_cascade_pallas, static_argnums=(4, 5, 6))


def _eq_block(S, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, S).astype(F32)
    hist = rng.uniform(-1, 1, 3).astype(F32)
    return x, np.concatenate([hist, x])[:S], rng.uniform(-0.1, 0.1, (4, 2)).astype(F32)


@pytest.mark.parametrize("S", EQ_S)
def test_region_eq_rows_model_matches_the_twin_and_the_pallas_kernel(S):
    """Both rows forms, 2 carried blocks (the model's poles feed its next
    block): output and poles within 2e-5 of the twin and of
    ``eq_cascade_pallas``."""
    f_lo, f_hi = _coeffs(48_000)
    x, xd, poles = _eq_block(2 * S, S)
    pm = {fs: poles for fs in EQ_FORMS}
    pt = torch.from_numpy(poles)
    for blk in range(2):
        sl = slice(blk * S, (blk + 1) * S)
        want, pt_next = eq_cuda.eq_cascade_torch(
            torch.from_numpy(x[sl]), torch.from_numpy(xd[sl]), pt, torch.from_numpy(GAINS),
            f_lo, f_hi, VSA)
        jax_out, jax_poles = _PALLAS_EQ(jnp.asarray(x[sl]), jnp.asarray(xd[sl]),
                                        jnp.asarray(pt.numpy()), jnp.asarray(GAINS),
                                        f_lo, f_hi, VSA)
        for fs in EQ_FORMS:
            got, got_poles = model_eq_rows(x[sl], xd[sl], pm[fs], GAINS, f_lo, f_hi, fs)
            tag = f"block {blk} form {fs}"
            np.testing.assert_allclose(got, want.numpy(), **EQ_TOL, err_msg=tag)
            np.testing.assert_allclose(got_poles, pt_next.numpy(), **EQ_TOL, err_msg=tag)
            if blk == 0:  # the JAX kernel from the same poles
                np.testing.assert_allclose(got, np.asarray(jax_out), **EQ_TOL, err_msg=tag)
                np.testing.assert_allclose(got_poles, np.asarray(jax_poles), **EQ_TOL,
                                           err_msg=tag)
            pm[fs] = got_poles
        pt = pt_next
