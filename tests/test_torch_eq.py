"""The port's EqThree (tables, plain twin, module) against the JAX package:
the Pallas kernel in interpret mode and the chunked ``_linrec_blocked``
path; and the twin against a float64 sample-by-sample cascade."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as p
from mixlab_tpu.dsp import eq_pallas as jax_eq_pallas
from mixlab_tpu.dsp import eq_three as jax_eq_three
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.convert import to_numpy, to_torch
from mixlab_tpu_torch.dsp import eq_cuda, eq_three
from mixlab_tpu_torch.engine import config as tc

CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_eq_pallas.py:110
PARAMS = p.EqThreeParams(p.Decibel(4.0), p.Decibel(-2.0), p.Decibel(3.0))
T_PARAMS = tp.EqThreeParams(tp.Decibel(4.0), tp.Decibel(-2.0), tp.Decibel(3.0))


@pytest.mark.parametrize("sample_rate", [44_100, 48_000])
def test_tables_bit_identical(sample_rate):
    f_lo = eq_three._filter_coeff(eq_three.FREQ_LO, sample_rate)
    f_hi = eq_three._filter_coeff(eq_three.FREQ_HI, sample_rate)
    a_lo, a_hi = 1.0 - f_lo, 1.0 - f_hi
    for a_tuple, C in [((a_lo, a_hi), 256), ((a_lo, a_lo), 128), ((a_hi, a_hi), 128)]:
        for mine, theirs in zip(eq_cuda._toeplitz_tables(a_tuple, C),
                                jax_eq_three._toeplitz_tables(a_tuple, C)):
            assert mine.dtype == theirs.dtype == np.float32
            assert np.array_equal(mine, theirs)
    K = 345  # the CLI's block at 44.1 kHz
    mine = eq_cuda._lane_tables(a_lo, a_hi, 128, K)
    theirs = jax_eq_pallas._lane_tables(a_lo, a_hi, 128, K)
    assert np.array_equal(mine[0], theirs[0]) and np.array_equal(mine[1], theirs[1])
    assert mine[2] == theirs[2]
    # the kernel's table starts with the same a per band (the JAX tables'
    # a^1); its transitions are held to a float64 recurrence in
    # tests/test_torch_eq_scan.py
    kt = eq_cuda.kernel_tables(f_lo, f_hi)
    T_lo = jax_eq_three._toeplitz_tables((a_lo, a_lo), 128)[0][0]
    T_hi = jax_eq_three._toeplitz_tables((a_hi, a_hi), 128)[0][0]
    assert kt[eq_cuda.TABLE_A] == T_lo[1, 0] and kt[eq_cuda.TABLE_A + 1] == T_hi[1, 0]
    assert kt.shape == (eq_cuda.TABLE_LEN,)


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, S).astype(np.float32)
    poles = rng.uniform(-0.1, 0.1, (4, 2)).astype(np.float32)
    hist = rng.uniform(-1, 1, 3).astype(np.float32)
    return x, poles, hist


_PALLAS = jax.jit(jax_eq_pallas.eq_cascade_pallas, static_argnums=(4, 5, 6))


@pytest.mark.parametrize("S", [8192, 44_100])
def test_twin_matches_pallas_kernel(S):
    """3 carried blocks through the wrapper (CPU tensors -> twin) against
    eq_cascade_pallas in interpret mode."""
    sr = 44_100
    f_lo = eq_three._filter_coeff(eq_three.FREQ_LO, sr)
    f_hi = eq_three._filter_coeff(eq_three.FREQ_HI, sr)
    gains = np.array([1.6, 0.8, 1.4], np.float32)
    _, poles, hist = _inputs(S, S)
    pj, pt = jnp.asarray(poles), torch.from_numpy(poles)
    x_all = np.random.default_rng(S + 1).uniform(-1, 1, 3 * S).astype(np.float32)
    xd_all = np.concatenate([hist, x_all])[:3 * S]
    for blk in range(3):
        x, xd = x_all[blk * S:(blk + 1) * S], xd_all[blk * S:(blk + 1) * S]
        want, pj = _PALLAS(jnp.asarray(x), jnp.asarray(xd), pj, jnp.asarray(gains),
                           f_lo, f_hi, eq_three.VSA)
        got, pt = eq_cuda.eq_cascade_cuda(
            torch.from_numpy(x), torch.from_numpy(xd), pt, torch.from_numpy(gains),
            f_lo, f_hi, eq_three.VSA)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"block {blk}")
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


@pytest.mark.parametrize("sample_rate,n_ticks", [(44_100, 1), (48_000, 3)],
                         ids=["S735", "S2400"])
def test_module_plain_path_matches_linrec_blocked(sample_rate, n_ticks):
    """Below the kernel's gate the module runs the plain twin, held to the
    JAX package's plain path (``_linrec_blocked``); 3 carried blocks, state
    converted from JAX."""
    cfg = EngineConfig(sample_rate=sample_rate)
    block = BlockSpec(n_ticks)
    t_cfg, t_block = tc.EngineConfig(sample_rate=sample_rate), tc.BlockSpec(n_ticks)
    S = block.n_samples(cfg)
    jd = jax_eq_three.EqThreeDef()
    td = eq_three.EqThreeDef()
    run_jax = jax.jit(lambda aux, st, x: jd.run_block(
        PARAMS, aux, None, st, [x], cfg, block)[:2])
    aux_j = jd.prepare(PARAMS, cfg)
    aux_t = td.prepare(T_PARAMS, t_cfg, CPU)
    x0, poles, hist = _inputs(S, 3)
    st_j = {"poles": jnp.asarray(poles), "hist": jnp.asarray(hist)}
    st_t = to_torch({"poles": poles, "hist": hist}, CPU)
    x_all = np.random.default_rng(S).uniform(-1, 1, 3 * S).astype(np.float32)
    for blk in range(3):
        x = x_all[blk * S:(blk + 1) * S]
        st_j, (want,) = run_jax(aux_j, st_j, jnp.asarray(x))
        st_t, (got,), _ = td.run_block(T_PARAMS, aux_t, None, st_t,
                                       [torch.from_numpy(x)], t_cfg, t_block, CPU)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        got_state = to_numpy(st_t)
        np.testing.assert_allclose(got_state["poles"], np.asarray(st_j["poles"]), **TOL)
        assert np.array_equal(got_state["hist"], np.asarray(st_j["hist"]))


def _cascade_f64(x, xd, poles, gains, f_lo, f_hi):
    """EqThree sample by sample in float64 (eq_three.rs:117-124)."""
    y = poles.astype(np.float64).copy()  # [stage, band]
    f = np.array([f_lo, f_hi])
    out = np.empty(len(x))
    for i in range(len(x)):
        b = f * x[i] + eq_three.VSA
        for k in range(4):
            y[k] = (1.0 - f) * y[k] + b
            b = f * y[k]
        lo, hi = y[3, 0], xd[i] - y[3, 1]
        mid = xd[i] - (hi + lo)
        out[i] = lo * gains[0] + mid * gains[1] + hi * gains[2]
    return out, y


@pytest.mark.parametrize("S", [1, 127, 735])
def test_twin_matches_sequential_cascade(S):
    """The twin at sizes below one chunk, at one chunk less a sample and at
    the 1-tick block, against the cascade run sample by sample."""
    sr = 44_100
    f_lo = eq_three._filter_coeff(eq_three.FREQ_LO, sr)
    f_hi = eq_three._filter_coeff(eq_three.FREQ_HI, sr)
    gains = np.array([1.6, 0.8, 1.4], np.float32)
    x, poles, hist = _inputs(S, S + 7)
    xd = np.concatenate([hist, x])[:S]
    got, got_poles = eq_cuda.eq_cascade_torch(
        torch.from_numpy(x), torch.from_numpy(xd), torch.from_numpy(poles),
        torch.from_numpy(gains), f_lo, f_hi, eq_three.VSA)
    want, want_poles = _cascade_f64(x, xd, poles, gains, f_lo, f_hi)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_poles.numpy(), want_poles, **TOL)
