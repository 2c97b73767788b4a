"""The port's envelope (plain twin and module) against the JAX package: the
Pallas kernel run in interpret mode and the flat-scan ``run_block``; gates
with edges at the CUDA kernel's tile boundaries; and the kernel's tile plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as p
from mixlab_tpu.dsp.envelope import EnvelopeDef as JaxEnvelope
from mixlab_tpu.dsp.envelope_pallas import envelope_block_pallas
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.convert import to_numpy, to_torch
from mixlab_tpu_torch.dsp.envelope import EnvelopeDef
from mixlab_tpu_torch.dsp import envelope_cuda as envc
from mixlab_tpu_torch.dsp.envelope_cuda import envelope_block_cuda
from mixlab_tpu_torch.engine import config as tc
from torch_support import tile_edge_gates

CPU = torch.device("cpu")
CFG = EngineConfig(sample_rate=44_100)
T_CFG = tc.EngineConfig(sample_rate=44_100)  # the port's own config
MS = 1000.0 / CFG.sample_rate
ATOL = 2e-5  # tests/test_envelope_pallas.py


def gates(kind, S, n_blocks, seed):
    """Gate signals for ``n_blocks`` consecutive blocks of S samples."""
    rng = np.random.default_rng(seed)
    n = S * n_blocks
    if kind == "open":  # all the flagship's trigger ever sends
        return np.ones(n, np.float32)
    if kind == "dense":  # random {0, 1, 0.5} every sample
        return rng.choice([0.0, 1.0, 0.5], size=n).astype(np.float32)
    if kind in ("tile_edges", "every_tile"):  # at the kernel's tile boundaries
        return tile_edge_gates(np, kind, S, envc.TILE, n_blocks, rng)
    # sparse edges, some placed right at / across block boundaries
    x = np.full(n, 0.5, np.float32)
    edges = sorted(set(rng.integers(0, n, 12).tolist()
                       + [S - 1, S, 2 * S - 2, 2 * S + 1]))
    for i, e in enumerate(edges):
        x[e] = 1.0 if i % 2 == 0 else 0.0
    return x


def _jax_flat(block):
    """The JAX module's flat-scan run_block, jitted (its eager form pays a
    compile per primitive)."""
    d = JaxEnvelope()
    return jax.jit(lambda aux, st, x: d.run_block(
        p.EnvelopeParams(), aux, None, st, [x], CFG, block)[:2])


_FLAT_60 = _jax_flat(BlockSpec(60))
_FLAT_3 = _jax_flat(BlockSpec(3))
_PALLAS = jax.jit(lambda x, st, aux: envelope_block_pallas(x, st, aux, MS,
                                                           interpret=True))


def _port(params):
    """The same envelope params as the port's protocol object."""
    return tp.EnvelopeParams(params.attack_ms, params.decay_ms,
                             params.sustain_amplitude, params.release_ms)


def _check_state(jax_state, torch_state):
    j = {k: np.asarray(v) for k, v in jax_state.items()}
    t = to_numpy(torch_state)
    assert bool(j["mode_on"]) == bool(t["mode_on"])
    assert int(j["on_pos"]) == int(t["on_pos"])
    assert int(j["off_pos"]) == int(t["off_pos"])
    np.testing.assert_allclose(t["off_amp"], j["off_amp"], atol=ATOL)


@pytest.mark.parametrize("params", [
    p.EnvelopeParams(),
    p.EnvelopeParams(attack_ms=0.0, decay_ms=10.0, sustain_amplitude=0.6,
                     release_ms=25.0),
], ids=["default", "attack0"])
@pytest.mark.parametrize("kind", ["open", "dense", "sparse", "tile_edges", "every_tile"])
def test_twin_matches_pallas_and_flat_scans(kind, params):
    """3 carried blocks at the CLI's block size (S = 44,100, the kernel's
    gate) through the port's wrapper (CPU tensor -> twin), the JAX Pallas
    kernel in interpret mode and the JAX flat-scan module.  ``tile_edges``
    puts edges at T-1, T and T+1 of every boundary of the CUDA kernel's
    tiles (T = ``envelope_cuda.TILE``) and on each block's first and last
    sample; ``every_tile`` one edge in every tile."""
    S = 44_100
    jd, td = JaxEnvelope(), EnvelopeDef()
    aux_j = jd.prepare(params, CFG)
    aux_t = td.prepare(_port(params), T_CFG, CPU)
    st_flat = jd.init_state(params, CFG)
    st_pl = jd.init_state(params, CFG)
    st_t = td.init_state(_port(params), T_CFG, CPU)
    x_all = gates(kind, S, 3, seed=7)
    for blk in range(3):
        x = x_all[blk * S:(blk + 1) * S]
        st_flat, (want,) = _FLAT_60(aux_j, st_flat, jnp.asarray(x))
        pallas, st_pl = _PALLAS(jnp.asarray(x), st_pl, aux_j)
        got, st_t = envelope_block_cuda(torch.from_numpy(x), st_t, aux_t, MS)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL,
                                   err_msg=f"vs pallas, block {blk}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"vs flat, block {blk}")
        _check_state(st_pl, st_t)
        _check_state(st_flat, st_t)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_module_below_gate_matches_flat_scans(kind):
    """Realtime-sized blocks (S = 2,205, below the kernel's gate) through
    the module, carried across 3 blocks, with state converted from JAX."""
    params = p.EnvelopeParams(attack_ms=3.0, decay_ms=10.0,
                              sustain_amplitude=0.6, release_ms=25.0)
    block = BlockSpec(3)
    S = block.n_samples(CFG)
    jd, td = JaxEnvelope(), EnvelopeDef()
    aux_j = jd.prepare(params, CFG)
    aux_t = to_torch({k: np.asarray(v) for k, v in aux_j.items()}, CPU)
    st_j = jd.init_state(params, CFG)
    st_t = to_torch({k: np.asarray(v) for k, v in st_j.items()}, CPU)
    x_all = gates(kind, S, 3, seed=11)
    for blk in range(3):
        x = x_all[blk * S:(blk + 1) * S]
        st_j, (want,) = _FLAT_3(aux_j, st_j, jnp.asarray(x))
        st_t, (got,), _ = td.run_block(_port(params), aux_t, None, st_t,
                                       [torch.from_numpy(x)], T_CFG,
                                       tc.BlockSpec(block.n_ticks), CPU)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        _check_state(st_j, st_t)


@pytest.mark.parametrize("ticks,batch,route", [
    (16, 0, "twin"),  # one fleet-sized block (12,800 samples), under the gate
    (41, 0, "kernel"),  # 32,800 samples: the single block's gate opens
    (16, 3, "kernel"),  # a batch takes the kernel at any length
])
def test_module_route_by_gate_and_batch(ticks, batch, route):
    """``run_block`` at 48 kHz, its spans on: an unbatched block under
    ``PALLAS_THRESHOLD`` takes the twin, one over it and a batch under vmap
    the kernel's wrapper (on a CPU tensor the twin, bit for bit)."""
    from mixlab_tpu_torch import spans

    cfg, block = tc.EngineConfig(sample_rate=48_000), tc.BlockSpec(ticks)
    S = block.n_samples(cfg)
    params = tp.EnvelopeParams(attack_ms=3.0, decay_ms=10.0, sustain_amplitude=0.6,
                               release_ms=25.0)
    td = EnvelopeDef()
    aux, st = td.prepare(params, cfg, CPU), td.init_state(params, cfg, CPU)
    x = torch.from_numpy(gates("sparse", S, 3, seed=ticks).reshape(3, S)[:batch or 1])
    run = lambda x, st, aux: td.run_block(params, aux, None, st, [x], cfg, block, CPU)[:2]
    spans.enable("t:")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            if batch:
                st = {k: v.expand(batch).clone() for k, v in st.items()}
                got_st, (got,) = torch.func.vmap(run, in_dims=(0, 0, None))(x, st, aux)
            else:
                got_st, (got,) = run(x[0], st, aux)
    finally:
        spans.disable()
    names = [e.name for e in prof.events()]
    assert (names.count("t:envelope.kernel"), names.count("t:envelope.twin")) == (
        (1, 0) if route == "kernel" else (0, 1))
    want, want_st = envc.envelope_block_torch_batched(
        x, {k: v.reshape(-1).expand(len(x)) for k, v in st.items()},
        {k: v.reshape(1).expand(len(x)) for k, v in aux.items()}, 1000.0 / 48_000)
    assert torch.equal(got.reshape(want.shape), want)
    for k in want_st:
        assert torch.equal(got_st[k].reshape(-1), want_st[k]), k


# (S, resident CTAs) -> (lane, tiles): LANE samples a thread while the tiles
# fit, else the shortest lane that fits in min(resident, MAX_TILES) tiles
TILE_PLANS = [
    ((envc.TILE - 1, 264), (envc.LANE, 1)), ((envc.TILE, 264), (envc.LANE, 1)),
    ((envc.TILE + 1, 264), (envc.LANE, 2)), ((44_100, 264), (2, 87)),
    ((48_000, 264), (2, 94)), ((384_000, 264), (6, 250)), ((384_000, 132), (12, 125)),
    ((envc.MAX_KERNEL_S, 132), (envc.MAX_LANE, 128)),
]


@pytest.mark.parametrize("args,want", TILE_PLANS, ids=[f"S{a[0]}-r{a[1]}" for a, _ in TILE_PLANS])
def test_tile_plan(args, want):
    lane, tiles = envc.tile_plan(*args)
    assert (lane, tiles) == want
    S, resident = args
    assert tiles <= min(resident, envc.MAX_TILES) and lane <= envc.MAX_LANE
    assert (tiles - 1) * envc.THREADS * lane < S <= tiles * envc.THREADS * lane


def test_tile_plan_refuses_a_block_that_does_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        envc.tile_plan(envc.MAX_KERNEL_S + 1, 128)
    assert envc.TILE == envc.THREADS * envc.LANE == 512
