"""The eq kernel's scan (``csrc/eq_scan.cuh``) modelled in numpy, on the CPU.

The model repeats the kernel's arithmetic in its order, in float32 with a
separate multiply and add (the kernels are built with ``-fmad=false``):

  * pass 1: each thread of each CTA runs both 4-stage cascades over its run
    of L samples from zero state (samples past S read 0);
  * the CTA's scan: a warp-shuffle scan of the runs' end states, a scan of
    the warp totals by warp 0, then each thread's exclusive entry
    E = A^(L*lane) E_warp + e_lane and its power A^(L*thread), the powers
    by their binary digits from the table;
  * after the grid barrier warp 0 folds the CTAs' aggregates before its own
    (q of them a lane, the lanes ending at the CTA, the block's poles as the
    element before the first CTA) and scans the lanes: the true entry state
    of the CTA; each thread's entry is A^(L*thread) Y + E;
  * pass 2 reruns the samples from there, mixes the bands and takes the
    poles at sample S-1.

It is held against the twin (``eq_cuda.eq_cascade_torch``) and against the
JAX package's ``eq_cascade_pallas`` in interpret mode within EQ_TOL, at the
sizes the kernel meets and at runs and CTAs cut by S; the kernel's tables
against a float64 recurrence on unit states, and ``scan_plan`` at its edges.
The kernel itself runs on the card (``tests/test_torch_cuda.py``, and
``chip_smoke.py``'s eq and region checks and main paths).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu.dsp import eq_pallas as jax_eq_pallas
from mixlab_tpu_torch.dsp import eq_cuda
from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

EQ_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_eq_pallas.py:110
F32 = np.float32
# what an H100 holds at once at the longest run (132 SMs); the model needs
# only a number, the kernel reads it from the occupancy query
RESIDENT = 132 * 6


def _coeffs(sample_rate=44_100):
    return _filter_coeff(FREQ_LO, sample_rate), _filter_coeff(FREQ_HI, sample_rate)


# --- the kernel's arithmetic, vectorised over CTAs and threads -------------
# a state is an array [..., 2 bands, 4 stages] of float32


def _mv(c, y):
    """C y for the lower-triangular Toeplitz C of first column c [..., 2, 4]:
    row i = c[i]*y[0] + c[i-1]*y[1] + ... + c[0]*y[i], left to right."""
    o = np.empty(np.broadcast_shapes(c.shape, y.shape), F32)
    for i in range(4):
        acc = c[..., i] * y[..., 0]
        for j in range(1, i + 1):
            acc = acc + c[..., i - j] * y[..., j]
        o[..., i] = acc
    return o


def _pow(tab, k):
    """A^(2^k) of both bands, [2, 4]."""
    at = eq_cuda.TABLE_POW + 2 * k * 4
    return tab[at:at + 8].reshape(2, 4)


def _absorb(v, u, tab, k):
    """v + A^(2^k) u: an earlier span's state u through a later span of 2^k
    samples whose zero-state result is v."""
    return _mv(_pow(tab, k), u) + v


def _step(y, x, a, f):
    """One sample of both cascades; y [..., 2, 4], x [...]."""
    y = y.copy()
    for b in range(2):
        d = x * f[b] + F32(VSA)
        for s in range(4):
            y[..., b, s] = a[b] * y[..., b, s] + d
            d = f[b] * y[..., b, s]
    return y


def _shift(v, off, axis):
    """shfl_up along ``axis``: lane i gets lane i-off (lanes below off keep
    their own value, which the callers do not use)."""
    out = v.copy()
    idx = [slice(None)] * v.ndim
    src = list(idx)
    idx[axis], src[axis] = slice(off, None), slice(None, -off)
    out[tuple(idx)] = v[tuple(src)]
    return out


def _warp_scan(v, tab, k0, width, axis):
    """Inclusive Hillis-Steele scan over ``width`` lanes on ``axis``; round
    r absorbs with A^(2^(k0 + r))."""
    lane = np.arange(v.shape[axis]).reshape([-1 if d == axis else 1 for d in range(v.ndim)])
    r, off = 0, 1
    while off < width:
        up = _shift(v, off, axis)
        v = np.where(lane >= off, _absorb(v, up, tab, k0 + r), v)
        r, off = r + 1, off * 2
    return v


def _apply_bits(M, n, tab, k0, bits):
    """M through A^(2^(k0+k)) for each set bit k < bits of the int array n,
    in increasing k, as the kernel builds its powers; M [..., 2, 4]."""
    for k in range(bits):
        on = ((n >> k) & 1).astype(bool)[..., None, None]
        M = np.where(on, _mv(_pow(tab, k0 + k), M), M)
    return M


def model_kernel(x, xd, poles0, gains, f_lo, f_hi, threads, run):
    """The eq kernel on one launch (S <= MAX_KERNEL_S): (out [S], poles [4, 2])."""
    S = x.shape[0]
    run, tiles = eq_cuda.scan_plan(S, RESIDENT, threads, run)
    T, L = threads, run
    lg, lt = L.bit_length() - 1, T.bit_length() - 1
    W = T // 32
    tab = eq_cuda.kernel_tables(f_lo, f_hi)
    a = tab[eq_cuda.TABLE_A:eq_cuda.TABLE_A + 2]
    f = np.array([f_lo, f_hi], F32)
    n = tiles * T * L
    xs = np.zeros(n, F32)
    xs[:S] = x
    xds = np.zeros(n, F32)
    xds[:S] = xd
    xs, xds = xs.reshape(tiles, T, L), xds.reshape(tiles, T, L)

    # pass 1
    v = np.zeros((tiles, T, 2, 4), F32)
    for j in range(L):
        v = _step(v, xs[:, :, j], a, f)
    # the CTA's scan: lanes, then warp totals by warp 0
    v = v.reshape(tiles, W, 32, 2, 4)
    incl = _warp_scan(v, tab, lg, 32, axis=2)
    e = _shift(incl, 1, axis=2)
    e[:, :, 0] = 0.0
    wv = _warp_scan(incl[:, :, 31], tab, lg + 5, W, axis=1)  # [tiles, W, 2, 4]
    agg = wv[:, W - 1]
    Ew = np.zeros_like(wv)
    Ew[:, 1:] = wv[:, :-1]
    lane = np.arange(32)
    ident = np.zeros((32, 2, 4), F32)
    ident[..., 0] = 1.0
    M_lane = _apply_bits(ident, lane, tab, lg, 5)  # A^(L*lane), [32, 2, 4]
    E = _mv(M_lane[None, None], Ew[:, :, None]) + e  # [tiles, W, 32, 2, 4]
    warp = np.arange(W)[:, None]
    M = _apply_bits(np.broadcast_to(M_lane, (W, 32, 2, 4)), warp, tab, lg + 5, lt - 5)

    # after the barrier: each CTA's entry from the aggregates before it
    p0 = poles0.astype(F32).T  # [band, stage]
    Y = np.empty((tiles, 2, 4), F32)
    for c in range(tiles):
        lq = 0
        while (32 << lq) < c + 1:
            lq += 1
        q = 1 << lq
        ys = np.zeros((32, 2, 4), F32)
        for ln in range(32):
            start = c - (32 - ln) * q
            if start + q <= -1:
                continue
            y = p0.copy() if start <= -1 else np.zeros((2, 4), F32)
            for jt in range(max(start, 0), start + q):
                y = _absorb(agg[jt], y, tab, lg + lt)
            ys[ln] = y
        Y[c] = _warp_scan(ys, tab, lg + lt + lq, 32, axis=0)[31]
    st = _mv(M[None], Y[:, None, None]) + E  # [tiles, W, 32, 2, 4]
    st = st.reshape(tiles, T, 2, 4)

    # pass 2
    out = np.empty((tiles, T, L), F32)
    last = divmod(S - 1, T * L)
    for j in range(L):
        st = _step(st, xs[:, :, j], a, f)
        lo, hi = st[..., 0, 3], st[..., 1, 3]
        out[:, :, j] = lo * gains[0] + (hi - lo) * gains[1] + (xds[:, :, j] - hi) * gains[2]
        if last[1] % L == j:
            poles = st[last[0], last[1] // L].T.copy()
    return out.reshape(-1)[:S], poles


def model_call(x, xd, poles0, gains, f_lo, f_hi, threads=eq_cuda.THREADS, run=eq_cuda.RUN):
    """The wrapper's split of a long block into sequential launches."""
    S = x.shape[0]
    if S <= eq_cuda.MAX_KERNEL_S:
        return model_kernel(x, xd, poles0, gains, f_lo, f_hi, threads, run)
    n_parts = -(-S // eq_cuda.MAX_KERNEL_S)
    part = -(-S // n_parts)
    outs = []
    for i in range(n_parts):
        sl = slice(i * part, min((i + 1) * part, S))
        o, poles0 = model_kernel(x[sl], xd[sl], poles0, gains, f_lo, f_hi, threads, run)
        outs.append(o)
    return np.concatenate(outs), poles0


# --- the tables -----------------------------------------------------------


@pytest.mark.parametrize("sample_rate", [44_100, 48_000])
@pytest.mark.parametrize("k", [0, 1, 3, 5, 8, 12])
def test_transition_tables_match_a_float64_recurrence(sample_rate, k):
    """A_b^(2^k) in the table is the float64 cascade run 2^k samples without
    input from each unit state, to f32 rounding; a_b is f32(1 - f_b)."""
    f_lo, f_hi = _coeffs(sample_rate)
    tab = eq_cuda.kernel_tables(f_lo, f_hi)
    assert tab.dtype == np.float32 and tab.shape == (eq_cuda.TABLE_LEN,)
    for b, f in enumerate((f_lo, f_hi)):
        a = 1.0 - f
        assert tab[eq_cuda.TABLE_A + b] == np.float32(a)
        for j in range(4):
            y = np.zeros(4)
            y[j] = 1.0
            for _ in range(2 ** k):
                d = 0.0
                for s in range(4):
                    y[s] = a * y[s] + d
                    d = f * y[s]
            # column j of a lower-triangular Toeplitz matrix is its first
            # column shifted down by j
            col = _pow(tab, k)[b]
            want = np.concatenate([np.zeros(j), y[j:]])
            np.testing.assert_allclose(np.concatenate([np.zeros(j), col[:4 - j]]), want,
                                       rtol=1e-6, atol=1e-30)


# --- the plan -------------------------------------------------------------

L0, T0 = eq_cuda.RUN, eq_cuda.THREADS
PLAN_S = [1, L0 - 1, L0, L0 + 1, 8192, 44_100, 48_000, eq_cuda.MAX_KERNEL_S,
          eq_cuda.MAX_KERNEL_S + 1]


@pytest.mark.parametrize("S", PLAN_S)
@pytest.mark.parametrize("resident", [RESIDENT, 132, 12])
def test_scan_plan(S, resident):
    """The default run while the CTAs fit; else the shortest power of two
    that does; every CTA but the last full, the last holding sample S-1."""
    try:
        run, tiles = eq_cuda.scan_plan(S, resident)
    except ValueError:
        assert -(-S // (resident * T0 * eq_cuda.MAX_RUN)) > 1
        return
    tile = T0 * run
    assert run >= L0 and run & (run - 1) == 0 and run <= eq_cuda.MAX_RUN
    assert tiles <= resident and (tiles - 1) * tile < S <= tiles * tile
    if run > L0:  # lengthened only because half the run would not fit
        assert -(-S // (T0 * run // 2)) > resident


def test_scan_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        eq_cuda.scan_plan(12 * T0 * eq_cuda.MAX_RUN + 1, 12)
    assert eq_cuda.scan_plan(44_100, RESIDENT) == (L0, -(-44_100 // (T0 * L0)))


# --- the model against the twin and the JAX kernel -------------------------


def _block(S, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, S).astype(F32)
    hist = rng.uniform(-1, 1, 3).astype(F32)
    poles = rng.uniform(-0.1, 0.1, (4, 2)).astype(F32)
    return x, np.concatenate([hist, x])[:S], poles


GAINS = np.array([1.6, 0.8, 1.4], F32)
# (S, threads, run): the plan's sizes, runs and CTAs cut by S
MODEL_CASES = [(S, T0, L0) for S in PLAN_S] + [
    (T0 * L0 - 1, T0, L0), (T0 * L0 + 1, T0, L0), (3 * T0 * L0 + 5, T0, L0),
    (1000, 64, 4), (5 * 256 * 2 + 3, 256, 2), (40 * 32 * 1 + 17, 32, 1)]


@pytest.mark.parametrize("S,threads,run", MODEL_CASES,
                         ids=[f"S{S}-T{t}-L{r}" for S, t, r in MODEL_CASES])
def test_model_matches_twin(S, threads, run):
    """Output and poles at S-1 within EQ_TOL of the twin, 2 carried blocks
    (the model's poles feed its next block)."""
    f_lo, f_hi = _coeffs()
    x, xd, poles = _block(2 * S, S)
    pm, pt = poles, torch.from_numpy(poles)
    for blk in range(2):
        sl = slice(blk * S, (blk + 1) * S)
        got, pm = model_call(x[sl], xd[sl], pm, GAINS, f_lo, f_hi, threads, run)
        want, pt = eq_cuda.eq_cascade_torch(
            torch.from_numpy(x[sl]), torch.from_numpy(xd[sl]), pt, torch.from_numpy(GAINS),
            f_lo, f_hi, VSA)
        np.testing.assert_allclose(got, want.numpy(), **EQ_TOL, err_msg=f"block {blk}")
        np.testing.assert_allclose(pm, pt.numpy(), **EQ_TOL, err_msg=f"block {blk}")


_PALLAS = jax.jit(jax_eq_pallas.eq_cascade_pallas, static_argnums=(4, 5, 6))


@pytest.mark.parametrize("S", [8192, 44_100, 48_000, T0 * L0 * 7 + 1])
@pytest.mark.parametrize("sample_rate", [44_100, 48_000])
def test_model_matches_pallas_kernel(S, sample_rate):
    """The model against ``eq_cascade_pallas`` in interpret mode, one block."""
    f_lo, f_hi = _coeffs(sample_rate)
    x, xd, poles = _block(S, S + sample_rate)
    got, got_poles = model_call(x, xd, poles, GAINS, f_lo, f_hi)
    want, want_poles = _PALLAS(jnp.asarray(x), jnp.asarray(xd), jnp.asarray(poles),
                               jnp.asarray(GAINS), f_lo, f_hi, VSA)
    np.testing.assert_allclose(got, np.asarray(want), **EQ_TOL)
    np.testing.assert_allclose(got_poles, np.asarray(want_poles), **EQ_TOL)
