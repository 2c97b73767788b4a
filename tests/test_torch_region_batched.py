"""The region program over a batch, on the CPU: the batched twin of the
region kernel (``engine/region_cuda.py``) against its single twin row by
row, the batching rule of its custom op, the two kernel forms' plan, and the
batched paths that take the region program where the block qualifies, as
the JAX package's do: the fleet against ``jax.vmap`` of the JAX fleet's
region program, the stems against ``mixlab_tpu.parallel.stems`` over a JAX
CPU mesh, a fleet's edits and resets against the regular program, a 4-entry
CPU mesh against one entry, and fleet serving in 16-tick blocks.

The JAX programs run unjitted (the region in Pallas interpret mode), as
``tests/test_torch_region.py`` runs them: jitted, XLA's fused FmSine phase
alone moves a tap by up to 2^-11, which would hide the region behind it.
"""

import json
import queue
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bench import build_16_module_graph as jax_flagship
from mixlab_tpu.engine.config import BlockSpec as JaxBlockSpec
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.parallel.fleet import Fleet as JaxFleet
from mixlab_tpu.parallel.stems import make_mesh as jax_mesh
from mixlab_tpu.parallel.stems import stem_parallel_step as jax_stem_parallel_step
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.convert import fleet_from_jax, fleet_to_numpy, to_numpy, tree_leaves
from mixlab_tpu_torch.dsp.base import RegionPlan
from mixlab_tpu_torch.engine import region_cuda
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.flagship import build_16_module_graph
from mixlab_tpu_torch.parallel import make_mesh
from mixlab_tpu_torch.parallel.fleet import Fleet
from mixlab_tpu_torch.parallel.stems import stem_parallel_step
from mixlab_tpu_torch.server.fleet_serve import FleetEngine
from torch_support import fleet_workspaces, region_plans, same_bits

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG = EngineConfig(sample_rate=48_000)
CFG_J = JaxEngineConfig(sample_rate=48_000)
REGION_ATOL = 2e-5  # tests/test_pallas_graph.py:85
MIX_ATOL = 2e-4     # tests/test_multichip.py:29
MON = "16"          # the flagship's Monitor


def _port(ws_j) -> Workspace:
    return Workspace.from_persist(json.loads(json.dumps(ws_j.to_persist())))


def _jax_instances(n):
    """n JAX flagship workspaces with their own oscillator, amplifier and
    EQ params (tests/test_torch_fleet.py's spread)."""
    from mixlab_tpu import protocol as jp

    base, _ = jax_flagship()
    out = []
    for i in range(n):
        ws = base.snapshot()
        d = i / max(n - 1, 1)
        ws.update_params(jp.ModuleId(3), jp.ModuleParams(
            "Oscillator", jp.OscillatorParams(110.0 * (1 + 0.1 * d), jp.Waveform.SINE)))
        ws.update_params(jp.ModuleId(8), jp.ModuleParams(
            "Amplifier", jp.AmplifierParams(amplitude=0.5 - 0.2 * d, mod_depth=0.3)))
        ws.update_params(jp.ModuleId(12), jp.ModuleParams("EqThree", jp.EqThreeParams(
            jp.Decibel(4.0 - 2 * d), jp.Decibel(d), jp.Decibel(4.0 + d))))
        out.append(ws)
    return out


@pytest.fixture(scope="module")
def plans():
    return region_plans(torch)


def _inputs(rng, plan, row, B, S, shared=(), nan=False):
    """numpy-seeded inputs for B rows (``torch_support.region_inputs`` on the CPU)."""
    ops = []
    for i, dt in enumerate(region_cuda.operand_dtypes(plan)):
        shape = (S,) if i in shared else (B, S)
        if dt == torch.int16:
            ops.append(torch.from_numpy(rng.integers(-32768, 32767, shape).astype(np.int16)))
        else:
            ops.append(torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)))
    if nan:
        ops[0][-1, S // 2 + 7] = float("nan")
        ops[1][0, S // 2 + 100] = 1e30
    pf = row * torch.from_numpy(rng.uniform(0.5, 1.5, (B, row.numel())).astype(np.float32))
    sf = torch.from_numpy(rng.uniform(-0.1, 0.1, (B, plan.n_ef)).astype(np.float32))
    return ops, pf, sf


TWIN_CASES = [("flagship", ()), ("flagship", (0,)), ("sink zoo", ()), ("sink zoo", (1,)),
              ("peak", ())]


@pytest.mark.parametrize("key,shared", TWIN_CASES,
                         ids=[f"{k.replace(' ', '_')}-shared{list(s)}" for k, s in TWIN_CASES])
def test_batched_twin_equals_single_twin_row_by_row(plans, key, shared):
    """B = 3 rows of 12,800 samples cut into two parts of 6,400 (the exits
    of part 1 are part 2's state row), 2 carried blocks; an operand in
    ``shared`` is one [S] row every row reads.  The batched twin runs the
    single twin's ops in the same order on every row, so each row is EXACTLY
    the single twin's (scalar taps and a NaN included)."""
    plan, row, consts = plans[key]
    rng = np.random.default_rng(13)
    B, S, half = 3, 12_800, 6_400
    _, _, sf = _inputs(rng, plan, row, B, S)
    sf_rows = [sf[i] for i in range(B)]
    for blk in range(2):
        ops, pf, _ = _inputs(rng, plan, row, B, S, shared, nan=key == "peak" and blk == 1)
        for a in (0, half):
            part = [v[..., a:a + half] for v in ops]
            taps, stap, ef = region_cuda.region_part_torch_batched(plan, part, pf, sf, half,
                                                                   consts, B)
            assert taps.shape == (B, plan.n_taps, half) and ef.shape == (B, plan.n_ef)
            for i in range(B):
                mine = [v if v.dim() == 1 else v[i] for v in part]
                t1, s1, e1 = region_cuda.region_part_torch(
                    plan, mine, torch.cat([pf[i], consts]), sf_rows[i], half)
                for g, w in ((taps[i], t1), (stap[i], s1), (ef[i], e1)):
                    assert same_bits(torch, g, w)
                sf_rows[i] = e1
            sf = ef
    if key == "peak":  # the NaN won in its row only, 1e30 in the first
        assert torch.isnan(stap[-1]).all() and stap[0].item() == torch.tensor(1e30).item()


def test_vmap_makes_one_batched_call_and_keeps_a_shared_operand_at_stride_0(plans,
                                                                            monkeypatch):
    """Under ``torch.func.vmap`` the part is the custom op, whose batching
    rule calls ``region_part_batched`` once with the batch first and an
    unbatched operand as its one [S] row (never expanded to [B, S])."""
    plan, row, consts = plans["flagship"]
    rng = np.random.default_rng(5)
    B, S = 4, 1_280
    ops, pf, sf = _inputs(rng, plan, row, B, S, shared=(2,))
    calls = []
    real = region_cuda.region_part_batched

    def spy(plan_, operands, pf_, sf_, S_, consts_, batch):
        calls.append(([tuple(v.shape) for v in operands], tuple(pf_.shape), batch))
        return real(plan_, operands, pf_, sf_, S_, consts_, batch)

    monkeypatch.setattr(region_cuda, "region_part_batched", spy)
    in_dims = tuple(None if v.dim() == 1 else 1 for v in ops)
    moved = [v if v.dim() == 1 else v.T for v in ops]  # batch axis last: the rule moves it

    def one(*args):
        *operands, pf_, sf_ = args
        return region_cuda.region_part_cuda(plan, operands, pf_, sf_, S, consts)

    taps, stap, ef = torch.func.vmap(one, in_dims=(*in_dims, 0, 0))(*moved, pf, sf)
    assert len(calls) == 1
    shapes, pf_shape, batch = calls[0]
    assert batch == B and pf_shape == (B, plan.n_pf)
    assert shapes[2] == (S,) and all(s == (B, S) for i, s in enumerate(shapes) if i != 2)
    want = region_cuda.region_part_torch_batched(plan, ops, pf, sf, S, consts, B)
    for g, w in zip((taps, stap, ef), want):
        assert torch.equal(g, w)


def test_batch_plan_takes_the_grid_where_it_fits_else_one_cta_a_row():
    S = 12_800  # 100 chunks: 25 CTAs a row at L = 4, 4 at L = 32
    shape = region_cuda.Shape(n_operands=6, n_scratch=8, n_eq=1)
    plan = lambda B: region_cuda.batch_plan(S, B, 792, shape, 264)
    G, R = region_cuda.FORM_GRID, region_cuda.FORM_ROWS
    assert plan(1) == (G, 4, 25, 25)
    assert plan(31) == (G, 4, 25, 775)
    assert plan(32) == (G, 8, 13, 416)
    assert plan(198) == (G, 32, 4, 792)
    # past the grid, one CTA a row in tiles of 1,024 samples
    assert plan(199) == (R, 8, 13, 199)
    assert plan(8192) == (R, 8, 13, 8192)
    # the tiles of every slot must fit a CTA's shared memory
    assert region_cuda.rows_shared_bytes(shape, 8) == 4 * (20 * 1024 + 2 * 128 * 9 + 3 * 12)
    wide = lambda n: region_cuda.Shape(n_operands=8, n_scratch=n, n_eq=1)
    assert [region_cuda.rows_run(wide(n)) for n in (8, 31, 32, 81, 82, 180, 181)] == [
        8, 8, 4, 4, 2, 2, 1]
    with pytest.raises(ValueError, match="shared memory"):
        region_cuda.rows_run(wide(500))
    # the wrapper's limits are the kernel's
    src = (ROOT / "mixlab_tpu_torch" / "csrc" / "region.cu").read_text()
    assert re.search(r"kRowsShared = (\d+) \* 1024", src).group(1) == str(
        region_cuda.ROWS_SHARED // 1024)
    assert re.search(r"kMaxChunks = (\d+);", src).group(1) == str(region_cuda.MAX_CHUNKS)


def test_plan_rebuilt_from_its_words(plans):
    plan = plans["sink zoo"][0]
    again = RegionPlan.from_words(plan.words, plan.meta())
    assert list(again.ops()) == list(plan.ops()) and again.meta() == plan.meta()


# -- the batched paths ----------------------------------------------------------


class _CountTwin:
    """Counts the batched twin's calls (one a part a call of the vmapped
    program on the CPU)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = region_cuda.region_part_torch_batched

        def counted(*a):
            self.n += 1
            return real(*a)

        monkeypatch.setattr(region_cuda, "region_part_torch_batched", counted)


def test_fleet_matches_jax_vmap_of_the_region_program(monkeypatch):
    """3 sessions with their own params at 12 ticks (9,600 samples: 75
    chunks, the region engages in both packages), both fleets started from
    the same state: the port's taps and carried state within REGION_ATOL of
    ``jax.vmap`` of the JAX fleet's region program over 2 blocks, the
    batched twin once a block."""
    n, ticks = 3, 12
    ws_j = _jax_instances(n)
    fj = JaxFleet.build(ws_j[0], n, CFG_J, JaxBlockSpec(ticks), per_instance_params=ws_j)
    fp = Fleet.build(_port(ws_j[0]), n, CFG, BlockSpec(ticks),
                     per_instance_params=[_port(w) for w in ws_j], device="cpu")
    assert fj.patch._mega and fp.patch._mega
    fleet_from_jax(fj, fp)
    count = _CountTwin(monkeypatch)
    program, state_j = jax.vmap(fj.patch._fn), fj.state
    spb = ticks * CFG.samples_per_tick
    for b in range(2):
        state_j, want = program(fj.aux, fj.host_aux(b * spb), state_j)
        got = to_numpy(fp.run_block(b * spb))
        for g, w in zip(got[MON]["audio"], want[MON]["audio"]):
            assert g.shape == (n, ticks, 800)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=REGION_ATOL)
    assert count.n == 2
    for g, w in zip(tree_leaves(fleet_to_numpy(fp)[1]),
                    tree_leaves(jax.tree.map(np.asarray, state_j))):
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=0,
                                   atol=REGION_ATOL)


@pytest.mark.parametrize("ticks,mega", [(15, False), (16, True), (12, True), (13, False)])
def test_fleet_program_choice_matches_jax(ticks, mega):
    """The fleet takes the region program exactly where the JAX fleet does:
    15 ticks (12,000 samples) and 13 (10,400) are not whole chunks."""
    ws_j = _jax_instances(2)
    fj = JaxFleet.build(ws_j[0], 2, CFG_J, JaxBlockSpec(ticks), per_instance_params=ws_j)
    fp = Fleet.build(_port(ws_j[0]), 2, CFG, BlockSpec(ticks),
                     per_instance_params=[_port(w) for w in ws_j], device="cpu")
    assert fj.patch._mega == fp.patch._mega == mega
    assert not Fleet.build(_port(ws_j[0]), 2, CFG, BlockSpec(ticks), device="cpu",
                           mega=False).patch._mega


def test_stems_match_jax_stems_over_a_cpu_mesh():
    """3 stems at 16 ticks over 2 mesh entries (one pad stem): the port's
    master against the JAX ``stem_parallel_step`` over 2 virtual CPU devices,
    both on the region program (the JAX step unjitted, within MIX_ATOL), and
    n x the one-stem region render."""
    ws_j, mon = jax_flagship()
    ws = _port(ws_j)
    fn_j, args_j, patch_j = jax_stem_parallel_step(ws_j, CFG_J, JaxBlockSpec(16), jax_mesh(2),
                                                   monitor_key=str(mon.value), n_stems=3)
    fn, make_args, patch = stem_parallel_step(ws, CFG, BlockSpec(16), str(mon.value), n_stems=3,
                                              mesh=make_mesh(2, devices=["cpu"]))
    assert patch_j._mega and patch._mega
    with jax.disable_jit():
        _, want = fn_j(*args_j(0))
    _, master = fn(*make_args(0))
    np.testing.assert_allclose(master.numpy(), np.asarray(want), rtol=0, atol=MIX_ATOL)
    p1 = compile_patch(ws, CFG, BlockSpec(16), CPU)
    _, taps = p1.run(p1.prepare_aux(ws), p1.host_aux(0), p1.init_state(ws))
    one = torch.stack(list(taps[str(mon.value)]["audio"]), -1)
    np.testing.assert_allclose(master.numpy(), 3 * one.numpy(), rtol=0, atol=MIX_ATOL)


def test_fleet_edits_and_resets_on_the_region_program_match_the_regular():
    """A param edit of one instance, a reset of another and of a row range
    between blocks: the region fleet's taps and state within REGION_ATOL of
    the same fleet on the regular program, its checkpoint of the same
    structure and dtypes."""
    wss = fleet_workspaces(4)
    block, spb = BlockSpec(16), 16 * CFG.samples_per_tick
    fleets = [Fleet.build(wss[0], 4, CFG, block, per_instance_params=wss, device="cpu",
                          mega=mega) for mega in (None, False)]
    assert fleets[0].patch._mega and not fleets[1].patch._mega
    edited = wss[1].snapshot()
    edited.update_params(p.ModuleId(12), p.ModuleParams("EqThree", p.EqThreeParams(
        p.Decibel(-6.0), p.Decibel(3.0), p.Decibel(0.0))))
    out = []
    for fl in fleets:
        taps = [to_numpy(fl.run_block(0))]
        fl.update_instance_aux(1, edited)
        fl.reset_instance_state(0, wss[0])
        fl.reset_rows(fl.state, fl.init_state(wss[0]), [2, 3])
        for b in (1, 2):
            taps.append(to_numpy(fl.run_block(b * spb)))
        out.append((taps, fleet_to_numpy(fl)))
    (tr, (aux_r, st_r)), (tg, (aux_g, st_g)) = out
    for a, b in zip(tr, tg):
        for x, y in zip(a[MON]["audio"], b[MON]["audio"]):
            np.testing.assert_allclose(x, y, rtol=0, atol=REGION_ATOL)
    for x, y in zip(tree_leaves(st_r), tree_leaves(st_g)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=REGION_ATOL)
    for x, y in zip(tree_leaves(aux_r), tree_leaves(aux_g)):
        assert np.array_equal(x, y)
    # the edit reached its instance only
    assert not np.allclose(tr[2][MON]["audio"][0][1], tr[2][MON]["audio"][0][2])


def test_region_fleet_over_four_cpu_entries_equals_one(monkeypatch):
    """8 sessions at 16 ticks over a 4-entry CPU mesh: every tap and state
    leaf equal to the one-entry fleet's bit for bit (each shard's rows run
    the same twin ops), the batched twin once a shard a block."""
    wss = fleet_workspaces(8)
    block, spb = BlockSpec(16), 16 * CFG.samples_per_tick
    one = Fleet.build(wss[0], 8, CFG, block, per_instance_params=wss, device="cpu")
    four = Fleet.build(wss[0], 8, CFG, block, per_instance_params=wss,
                       mesh=make_mesh(4, axis="fleet", devices=["cpu"]), axis="fleet")
    assert four.patch._mega
    count = _CountTwin(monkeypatch)
    for b in range(2):
        want, got = one.run_block(b * spb), four.run_block(b * spb)
        for g, w in zip(got[MON]["audio"], want[MON]["audio"]):
            assert torch.equal(g, w)
    assert count.n == 2 * (1 + 4)
    for g, w in zip(tree_leaves(fleet_to_numpy(four)[1]), tree_leaves(fleet_to_numpy(one)[1])):
        assert np.array_equal(g, w)


def test_fleet_engine_in_16_tick_blocks_serves_region_renders():
    """``FleetEngine(block_ticks=16)`` on the flagship takes the region
    program; an edited and an unedited session each receive EXACTLY the i16
    PCM of a dedicated single-patch render of their workspace."""
    from tests.test_torch_fleet_serve import FakeSub, pcm_of

    template, _ = build_16_module_graph()
    eng = FleetEngine(template, 3, CFG, block_ticks=16, device="cpu")
    assert eng.fleet.patch._mega
    slots = []
    for _ in range(2):
        done = queue.Queue(maxsize=1)
        eng._process_cmd(("join", done))
        slots.append(done.get_nowait())
    params = p.ModuleParams("Oscillator", p.OscillatorParams(220.0, p.Waveform.SINE))
    msg = p.WorkspaceMessage(1, p.UpdateModuleParams(p.ModuleId(3), params))
    eng._process_cmd(("op", slots[0], msg))
    subs = [FakeSub(), FakeSub()]
    for s, sub in zip(slots, subs):
        s.monitors.append(sub)
    for _ in range(3):  # issue-ahead: N + 1 blocks deliver N packets
        eng._block_once()
    edited = template.snapshot()
    edited.update_params(p.ModuleId(3), params)
    for ws, sub in ((edited, subs[0]), (template, subs[1])):
        patch = compile_patch(ws, CFG, BlockSpec(16), CPU)
        assert patch._mega
        state, pcm = patch.init_state(ws), []
        for b in range(2):
            state, taps = patch.run(patch.prepare_aux(ws), patch.host_aux(b * 12_800), state)
            pcm.append(np.stack([(torch.clamp(c.reshape(-1), -1, 1) * 32767.0)
                                 .to(torch.int16).numpy() for c in taps[MON]["audio"]], 1))
        got = np.concatenate([pcm_of(sub, i)[1] for i in range(2)])
        assert np.array_equal(got, np.concatenate(pcm))
