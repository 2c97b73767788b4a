"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips.  On a machine
with one: ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from mixlab_tpu_torch.dsp import envelope_cuda as envc
from mixlab_tpu_torch.dsp import eq_cuda as eqc
from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff
from torch_support import (REGION_ATOL, HoldRegion, fleet_workspaces, launch_tiles, peaks_exact,
                           region_inputs, region_plans, rows_err, run_blocks, sink_zoo,
                           tile_edge_gates, tree_err)

pytestmark = pytest.mark.cuda

ENV_ATOL = 2e-5
EQ_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's Toeplitz products
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _env_state(dev):
    return {"mode_on": torch.tensor(False, device=dev),
            "on_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
            "off_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
            "off_amp": torch.tensor(0.0, device=dev)}


def _env_params(dev, attack=25.0):
    return {k: torch.tensor(v, device=dev) for k, v in dict(
        attack_ms=attack, decay_ms=500.0, sustain_amplitude=0.8,
        release_ms=200.0).items()}


def _gates(kind, S, seed):
    """Three blocks of S samples: random {0, 1, 0.5}, or edges at the
    kernel's tile boundaries (T-1, T, T+1, the first and last sample) or one
    in every tile (as ``chip_smoke.check_envelope``)."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        return rng.choice([0.0, 1.0, 0.5], size=3 * S).astype(np.float32)
    _, T = launch_tiles(envc, S)
    return tile_edge_gates(np, kind, S, T, 3, rng)


ENV_SIZES = [735, envc.TILE - 1, envc.TILE + 1, 44_100, 48_000, envc.MAX_KERNEL_S,
             envc.MAX_KERNEL_S + 1]


@pytest.mark.parametrize("S", ENV_SIZES)
@pytest.mark.parametrize("attack", [25.0, 0.0])
@pytest.mark.parametrize("kind", ["dense", "tile_edges", "every_tile"])
def test_envelope_kernel_matches_twin(dev, S, attack, kind):
    params = _env_params(dev, attack)
    st_k, st_t = _env_state(dev), _env_state(dev)
    x_all = torch.from_numpy(_gates(kind, S, S)).to(dev)
    for blk in range(3):
        x = x_all[blk * S:(blk + 1) * S]
        got, st_k = envc.envelope_block_cuda(x, st_k, params, 1000 / 44_100)
        want, st_t = envc.envelope_block_torch(x, st_t, params, 1000 / 44_100)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ENV_ATOL)
        for k in ("mode_on", "on_pos", "off_pos"):
            assert st_k[k].item() == st_t[k].item(), k
        assert abs(st_k["off_amp"].item() - st_t["off_amp"].item()) <= ENV_ATOL


# the kernel's edges: a run (RUN samples a thread) and a CTA's tile cut by S
# (as ``chip_smoke.check_eq``), both rates' blocks, the split bound
EQ_SIZES = [1, eqc.RUN - 1, eqc.RUN + 1, eqc.THREADS * eqc.RUN - 1, eqc.THREADS * eqc.RUN,
            eqc.THREADS * eqc.RUN + 1, 8192, 44_100, 48_000, eqc.MAX_KERNEL_S,
            eqc.MAX_KERNEL_S + 1]


@pytest.mark.parametrize("S", EQ_SIZES)
def test_eq_kernel_matches_twin(dev, S):
    f_lo = _filter_coeff(FREQ_LO, 44_100)
    f_hi = _filter_coeff(FREQ_HI, 44_100)
    rng = np.random.default_rng(S)
    gains = torch.tensor([1.6, 0.8, 1.4], device=dev)
    p_k = torch.from_numpy(rng.uniform(-0.1, 0.1, (4, 2)).astype(np.float32)).to(dev)
    p_t = p_k.clone()
    hist = torch.zeros(3, device=dev)
    for _ in range(3):
        x = torch.from_numpy(rng.uniform(-1, 1, S).astype(np.float32)).to(dev)
        xd = torch.cat([hist, x])[:S]
        hist = x[-3:]
        got, p_k = eqc.eq_cascade_cuda(x, xd, p_k, gains, f_lo, f_hi, VSA)
        want, p_t = eqc.eq_cascade_torch(x, xd, p_t, gains, f_lo, f_hi, VSA)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **EQ_TOL)
        np.testing.assert_allclose(p_k.cpu().numpy(), p_t.cpu().numpy(), **EQ_TOL)


def test_eq_kernel_one_device_launch_per_call(dev):
    """One eq call is one kernel on the card (the profiler's device items),
    and the wrapper counts it once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    S = 44_100
    x = torch.ones(S, device=dev)
    args = (x, x, torch.zeros(4, 2, device=dev), torch.ones(3, device=dev), 0.06, 0.38, 0.0)
    eqc.eq_cascade_cuda(*args)  # the tables reach the card once
    torch.cuda.synchronize()
    n = eqc.eq_cascade_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eqc.eq_cascade_cuda(*args)
        torch.cuda.synchronize()
    items = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    assert len(items) == 1 and "eq_cascade_kernel" in next(iter(items)), items
    assert next(iter(items.values())) == 5
    assert eqc.eq_cascade_cuda.launches == n + 5


def test_wrappers_reject_bad_tensors(dev):
    x = torch.zeros(44_100, device=dev)
    with pytest.raises(ValueError):
        envc.envelope_block_cuda(x[::2], _env_state(dev), _env_params(dev), 0.02)
    with pytest.raises(ValueError):
        envc.envelope_block_cuda(x.double(), _env_state(dev), _env_params(dev), 0.02)
    with pytest.raises(ValueError):
        eqc.eq_cascade_cuda(x, x, torch.zeros(4, 2), torch.ones(3, device=dev),
                            0.1, 0.2, 0.0)  # poles on the CPU


def test_launch_counters_count_launches(dev):
    n_env, n_eq = envc.envelope_block_cuda.launches, eqc.eq_cascade_cuda.launches
    S = envc.MAX_KERNEL_S + 1  # two sequential launches
    envc.envelope_block_cuda(torch.ones(S, device=dev), _env_state(dev),
                             _env_params(dev), 0.02)
    x = torch.zeros(eqc.MAX_KERNEL_S + 1, device=dev)
    eqc.eq_cascade_cuda(x, x, torch.zeros(4, 2, device=dev),
                        torch.ones(3, device=dev), 0.1, 0.2, 0.0)
    assert envc.envelope_block_cuda.launches == n_env + 2
    assert eqc.eq_cascade_cuda.launches == n_eq + 2


REGION_CASES = [("flagship", 60, 1), ("flagship", 300, 2), ("flagship", 152, 1),
                ("sink_zoo", 60, 1), ("sink_zoo", 300, 2)]


@pytest.mark.parametrize("graph,ticks,parts", REGION_CASES,
                         ids=[f"{g}-{t}" for g, t, _ in REGION_CASES])
def test_region_kernel_matches_twin(dev, graph, ticks, parts):
    """Every launch of the region program, 3 carried blocks at 48 kHz, held
    against the twin on the same inputs (``HoldRegion`` raises past
    2e-5); then the whole program against the regular one."""
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph

    cfg = EngineConfig(sample_rate=48_000)
    feeds = None
    if graph == "flagship":
        ws = build_16_module_graph()[0]
    else:
        ws, si = sink_zoo()
        rng = np.random.default_rng(7)
        feeds = {i: {str(si.value): {"pcm": rng.integers(
            -32768, 32767, (2, ticks * 800)).astype(np.int16)}} for i in range(3)}
    pm = compile_patch(ws, cfg, BlockSpec(ticks), dev)
    assert pm._mega
    with HoldRegion(torch) as hold:
        sm, tm = run_blocks(pm, ws, 3, feeds)
    assert hold.launches == 3 * parts and hold.worst <= REGION_ATOL
    sr, tr = run_blocks(compile_patch(ws, cfg, BlockSpec(ticks), dev, mega=False),
                        ws, 3, feeds)
    assert tree_err(sm, sr, "state") <= REGION_ATOL
    for a, b in zip(tm, tr):
        assert tree_err(a, b, "taps") <= REGION_ATOL


def _region_case(dev):
    """A one-op plan (a tap of the first operand) and its inputs."""
    from mixlab_tpu_torch.dsp.base import OP_TAP, RegionPlan

    plan = RegionPlan(n_operands=1, n_pf=0, n_ef=0)
    plan.add(OP_TAP, 0, 0)
    plan.n_taps = 1
    x = torch.arange(4096, dtype=torch.float32, device=dev)
    return plan, x, torch.zeros(0, device=dev), torch.zeros(0, device=dev)


def test_region_wrapper_rejects_bad_tensors_and_counts_launches(dev):
    from mixlab_tpu_torch.engine import region_cuda

    plan, x, pf, sf = _region_case(dev)
    n = region_cuda.region_part_cuda.launches
    taps, _, _ = region_cuda.region_part_cuda(plan, [x], pf, sf, 4096)
    torch.cuda.synchronize()
    assert torch.equal(taps[0], x) and region_cuda.region_part_cuda.launches == n + 1
    for bad in ([x.double()], [x.cpu()], [x[::2]], [x[:4000]]):
        with pytest.raises(ValueError):
            region_cuda.region_part_cuda(plan, bad, pf, sf, 4096)
    with pytest.raises(ValueError):
        region_cuda.region_part_cuda(plan, [x[:4000]], pf, sf, 4000)  # not whole chunks
    assert region_cuda.region_part_cuda.launches == n + 1



def test_batched_region_kernel_matches_twin_in_both_forms(dev):
    """The flagship's region plan over 3 rows of 12,800 samples cut into two
    parts of 6,400, 2 carried blocks, operand 0 one row every row reads
    (row stride 0): the cooperative grid and the rows form (one CTA a row)
    each within 2e-5 of the batched twin, one launch a call."""
    from mixlab_tpu_torch.engine import region_cuda as rc

    plan, row, consts = region_plans(torch)["flagship"]
    consts = consts.to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    B, half = 3, 6_400
    s0 = torch.rand((B, plan.n_ef), generator=g, device=dev) * 0.2 - 0.1
    one_a_row = rc.rows_plan(half, B, rc.plan_shape(plan), 1)
    forms = (rc.FORM_GRID, one_a_row)
    sf = {f: s0.clone() for f in ("twin", *forms)}
    for _ in range(2):
        ops, pf = region_inputs(torch, g, plan, row, B, 2 * half, dev, shared=(0,))
        for a in (0, half):
            part = [v[..., a:a + half] for v in ops]
            want = rc.region_part_torch_batched(plan, part, pf, sf["twin"], half, consts, B)
            sf["twin"] = want[2]
            for form in forms:
                n = rc.region_part_cuda.launches
                got = rc.region_part_batched(plan, part, pf, sf[form], half, consts, B,
                                             form=form)
                torch.cuda.synchronize()
                assert rc.region_part_cuda.launches == n + 1
                sf[form] = got[2]
                for x, y in zip(got, want):  # the flagship has no scalar tap: stap is empty
                    assert rows_err(torch, x, y) <= REGION_ATOL


def test_batched_region_wrapper_rejects_bad_tensors(dev):
    from mixlab_tpu_torch.engine import region_cuda

    plan, x, _, _ = _region_case(dev)
    rows, none = torch.stack([x, -x]), torch.zeros((2, 0), device=dev)
    consts = torch.zeros(0, device=dev)
    n = region_cuda.region_part_cuda.launches
    for op in (rows, x):  # two rows, and one row both rows read
        taps, _, _ = region_cuda.region_part_batched(plan, [op], none, none, 4096, consts, 2)
        torch.cuda.synchronize()
        assert torch.equal(taps[:, 0], op.expand(2, -1))
    wide = torch.zeros((2, 8192), device=dev)
    for bad, c in (([rows[:1]], consts), ([wide[:, ::2]], consts), ([rows.cpu()], consts),
                   ([rows.double()], consts), ([rows], consts[None])):
        with pytest.raises(ValueError):
            region_cuda.region_part_batched(plan, bad, none, none, 4096, c, 2)
    assert region_cuda.region_part_cuda.launches == n + 2


def test_fleet_region_block_launches_the_region_kernel_once(dev):
    """4 sessions of the flagship at 48 kHz in 16-tick blocks on the card:
    one region launch a block and no eq launch, taps within 2e-5 of the
    same fleet on the CPU (the batched twin)."""
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(16)
    wss = fleet_workspaces(4)
    fleets = [Fleet.build(wss[0], 4, cfg, block, per_instance_params=wss, device=d)
              for d in ("cuda", "cpu")]
    assert fleets[0].patch._mega
    for b in range(2):
        n, e = region_cuda.region_part_cuda.launches, eqc.eq_cascade_cuda.launches
        got = fleets[0].run_block(b * 12_800)
        torch.cuda.synchronize()
        assert region_cuda.region_part_cuda.launches == n + 1
        assert eqc.eq_cascade_cuda.launches == e
        want = fleets[1].run_block(b * 12_800)
        for x, y in zip(got["16"]["audio"], want["16"]["audio"]):
            assert (x.cpu() - y).abs().max().item() <= REGION_ATOL

# n % 16 of 0, 1, 11 and 15; 1025x16 and 540x960 leave the last CTA of the
# vector range ragged (as ``chip_smoke.check_crossfade``)
CROSSFADE_SHAPES = [(1080, 1920), (540, 960), (36, 100), (1, 1), (7, 13), (17, 31), (5, 13),
                    (1025, 16)]


@pytest.mark.parametrize("shape", CROSSFADE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_crossfade_kernel_matches_twin(dev, shape):
    """Exact, at every fade, alone and as the first plane of a three-plane
    launch of mixed sizes; also at an odd byte offset (the ragged range)."""
    from mixlab_tpu_torch.video import blend

    rng = np.random.default_rng(shape[0] + shape[1])
    n = shape[0] * shape[1]
    buf = torch.from_numpy(rng.integers(0, 256, 4 * n + 1, dtype=np.uint8)).to(dev)
    a, b = buf[:n].view(shape), buf[n:2 * n].view(shape)
    odd_a, odd_b = buf[2 * n + 1:3 * n + 1].view(shape), buf[3 * n + 1:].view(shape)
    small = torch.from_numpy(rng.integers(0, 256, (7, 13), dtype=np.uint8)).to(dev)
    for fade in (0, 1, 127, 128, 254, 255):
        (got,) = blend.crossfade_cuda([a], [b], fade)
        assert torch.equal(got, blend.crossfade_torch(a, b, fade)), fade
        (got,) = blend.crossfade_cuda([odd_a], [odd_b], fade)
        assert torch.equal(got, blend.crossfade_torch(odd_a, odd_b, fade)), fade
        got = blend.crossfade_cuda([a, small, odd_b], [b, small.flip(0), odd_a], fade)
        for g, x, y in zip(got, (a, small, odd_b), (b, small.flip(0), odd_a)):
            assert torch.equal(g, blend.crossfade_torch(x, y, fade)), fade


def test_crossfade_wrapper_rejects_bad_planes(dev):
    from mixlab_tpu_torch.video import blend

    y = torch.zeros((48, 64), dtype=torch.uint8, device=dev)
    n = blend.crossfade_cuda.launches
    for a, b in (([y], [y.cpu()]),                     # a mix of devices
                 ([y[:, ::2]], [y[:, ::2]]),           # not contiguous
                 ([y], [y[:24]]),                      # shapes differ
                 ([y.float()], [y.float()]),           # not uint8
                 ([y] * 4, [y] * 4)):                  # more than three planes
        with pytest.raises(ValueError):
            blend.crossfade_cuda(a, b, 128)
    with pytest.raises(ValueError, match="fade"):
        blend.crossfade_cuda([y], [y], 256)
    with pytest.raises(ValueError):
        blend.crossfade_picture({"y": y}, {"y": y.cpu()}, 128)
    assert blend.crossfade_cuda.launches == n


def test_cuda_engine_ticks_launch_the_crossfade_once_each(dev):
    """Three ticks of the port's Engine on the card with live video (small
    frames): one crossfade launch per tick, and each composite equal to the
    twin on the stored pictures."""
    import chip_smoke
    from mixlab_tpu_torch.video.blend import crossfade_cuda, crossfade_torch

    sizes = ((96, 54), (64, 48))
    eng, ids, _ = chip_smoke.realtime_engine("cuda", ("cuda-cam1", "cuda-cam2"))
    cams = chip_smoke.Cameras(("cuda-cam1", "cuda-cam2"), sizes)
    pipe = eng.monitor_pipe(ids["monitor"])
    mixer = eng._video_mixers[ids["mixer"]]
    try:
        n = crossfade_cuda.launches
        for tick in range(3):
            assert cams.publish(tick, chip_smoke.cam_frames(torch, np, dev, tick, sizes))
            eng.tick_once()
            _, audio, video = pipe.q.get(timeout=10)
            assert audio.shape == (735, 2) and video is not None
            assert video.picture.planes["y"].shape == (54, 96)
            a_pic, b_pic = (mixer.channels[i].stored for i in (0, 1))
            for k in ("y", "u", "v"):
                assert torch.equal(video.picture.planes[k],
                                   crossfade_torch(a_pic.planes[k], b_pic.planes[k], 153))
        assert crossfade_cuda.launches == n + 3
    finally:
        cams.close()
        eng.stop()



def test_cuda_served_session_streams_the_monitor(dev, tmp_path, monkeypatch):
    """The served session on the card (``chip_smoke.served_session``, 3 s,
    small frames): the session socket builds the realtime workspace, the
    Monitor's socket streams fMP4 segments from the native CAVLC tier, and
    the crossfade launches once per video tick; the pictures the codec
    thread fed its encoder are within 1 LSB of the engine's composites."""
    import chip_smoke

    sizes = ((96, 54), (64, 48))
    monkeypatch.setattr(chip_smoke.cam_frames, "__defaults__", (sizes,))
    monkeypatch.setattr(chip_smoke.Cameras.__init__, "__defaults__", (sizes,))
    monkeypatch.setattr(chip_smoke, "SERVED_SECONDS", 3.0)
    launches = chip_smoke.served_session(torch, np, dev, tmp_path)["launches"]
    assert launches["crossfade"] >= 60

RESIZE_CASES = [
    ([(720, 1280), (360, 640), (360, 640)], [(1080, 1920), (540, 960), (540, 960)]),
    ([(240, 250)], [(256, 125)]),
    ([(110, 330), (64, 96), (98, 174)], [(40, 120), (64, 96), (147, 174)]),
    ([(26, 26), (52, 260)], [(18, 22), (36, 220)]),
]


@pytest.mark.parametrize("src,dst", RESIZE_CASES, ids=lambda s: f"{len(s)}x{s[0][0]}x{s[0][1]}")
def test_resize_kernel_matches_twin(dev, src, dst):
    """Exact against the twin, one launch per picture (a 720p -> 1080p
    yuv420p picture; a 16-phase plane; the steepest downscale beside an
    unchanged plane and a rows-only plane; ratios with zero weights between
    nonzero taps); each resized plane within 1 LSB of the dense f32
    resize."""
    from mixlab_tpu_torch.video import resize_cuda as rc
    from mixlab_tpu_torch.video import scale

    rng = np.random.default_rng(src[0][0] + dst[0][1])
    planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev) for s in src]
    n = rc.resize_picture_polyphase.launches
    got = rc.resize_picture_polyphase(planes, dst)
    want = rc.resize_picture_torch(planes, dst)
    torch.cuda.synchronize()
    assert rc.resize_picture_polyphase.launches == n + 1
    for g, w, x, size in zip(got, want, planes, dst):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
        dense = scale.resize_plane(x, *size, method="f32")
        assert int((g.to(torch.int16) - dense.to(torch.int16)).abs().max()) <= 1
    (plane,) = rc.resize_picture_polyphase(planes[:1], dst[:1])
    assert torch.equal(plane, rc.resize_plane_polyphase(planes[0], *dst[0]))
    assert torch.equal(plane, got[0]) and rc.resize_picture_polyphase.launches == n + 3


def test_resize_wrapper_rejects_bad_tensors(dev):
    from mixlab_tpu_torch.video import resize_cuda as rc

    x = torch.zeros((48, 64), dtype=torch.uint8, device=dev)
    n = rc.resize_picture_polyphase.launches
    for planes, sizes in (([x.float()], [(72, 96)]),               # not uint8
                          ([x[None]], [(72, 96)]),                 # not 2-D
                          ([x], [(71 * 97, 96)]),                  # no plan
                          ([x, x.cpu()], [(72, 96), (72, 96)]),    # a mix of devices
                          ([x] * 4, [(72, 96)] * 4),               # more than three planes
                          ([x, x], [(72, 96)])):                   # a size per plane
        with pytest.raises(ValueError):
            rc.resize_picture_polyphase(planes, sizes)
    assert rc.resize_picture_polyphase.launches == n
    got = rc.resize_picture_polyphase([x, x], [(48, 64), (48, 64)])  # nothing to resize
    assert all(torch.equal(g, x) for g in got) and rc.resize_picture_polyphase.launches == n


def test_lean_path_refuses_other_cards_and_strided_tensors(dev):
    """Every wrapper launches through ``kernels.launch``: a tensor the
    kernel cannot take raises before it, and a tensor on another card than
    the current one launches there (with two cards or more)."""
    from mixlab_tpu_torch.tools import profile_env_eq as tool
    from mixlab_tpu_torch.video import blend

    x = torch.arange(4096, dtype=torch.float32, device=dev)
    n = tool.passthrough_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        tool.passthrough_cuda(x[::2])
    y = torch.zeros((8, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="not contiguous"):
        blend.crossfade_cuda([y[:, ::2]], [y[:, ::2]], 128)
    assert tool.passthrough_cuda.launches == n
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", 1)
        with pytest.raises(ValueError, match="the others on"):
            blend.crossfade_cuda([y], [y.to(other)], 128)
        got = tool.passthrough_cuda(x.to(other))
        torch.cuda.synchronize(other)
        assert got.device == other and torch.equal(got.cpu(), tool.passthrough_torch(x).cpu())
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("S", [384_000, 1_000_003])
def test_passthrough_kernel_matches_twin(dev, S):
    from mixlab_tpu_torch.tools import profile_env_eq as tool

    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(dev)
    n = tool.passthrough_cuda.launches
    got = tool.passthrough_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tool.passthrough_torch(x)) and tool.passthrough_cuda.launches == n + 1
    for bad in (x[::2], x.double(), x.reshape(-1, 1)):
        with pytest.raises(ValueError):
            tool.passthrough_cuda(bad)
    assert tool.passthrough_cuda.launches == n + 1


# each way a host process may ask for TF32 on the card
TF32_SWITCHES = {
    "allow_tf32": lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", True),
    "matmul_precision_high": lambda: torch.set_float32_matmul_precision("high"),
    "cuda_fp32_precision": lambda: setattr(torch.backends.cuda.matmul, "fp32_precision", "tf32"),
    "global_fp32_precision": lambda: (
        setattr(torch.backends.cuda.matmul, "fp32_precision", "none"),
        setattr(torch.backends, "fp32_precision", "tf32")),
}


@pytest.mark.parametrize("switch", list(TF32_SWITCHES))
def test_f32_products_on_the_card_refuse_tf32(dev, switch):
    """With TF32 switched on, EqThree's products on a 735-sample block (the
    module's plain path below the kernel's gate), the "f32" resize, the
    letterbox and the f32 fold raise a RuntimeError naming the setting;
    with it off again they give the IEEE result.  The flags are restored."""
    from mixlab_tpu_torch.precision import reduced_precision_setting, switch_tf32_off
    from mixlab_tpu_torch.video import scale
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings
    from mixlab_tpu_torch.video.fused import resize_crossfade_roll

    if "fp32_precision" in switch and not hasattr(torch.backends, "fp32_precision"):
        pytest.skip("this PyTorch has no fp32_precision API")
    rng = np.random.default_rng(735)
    x = torch.from_numpy(rng.uniform(-1, 1, 735).astype(np.float32)).to(dev)
    xd = torch.cat([torch.zeros(3, device=dev), x])[:735]
    poles = torch.zeros(4, 2, device=dev)
    gains = torch.tensor([1.6, 0.8, 1.4], device=dev)
    f_lo, f_hi = _filter_coeff(FREQ_LO, 44_100), _filter_coeff(FREQ_HI, 44_100)
    plane = torch.from_numpy(rng.integers(0, 256, (720, 1280), dtype=np.uint8)).to(dev)
    pic = Picture(PictureSettings(1280, 720), {"y": plane, "u": plane[::2, ::2].contiguous(),
                                               "v": plane[1::2, 1::2].contiguous()})
    runs = {"EqThree": lambda: eqc.eq_cascade_torch(x, xd, poles, gains, f_lo, f_hi, VSA),
            "resize_plane": lambda: scale.resize_plane(plane, 1080, 1920, "f32"),
            "letterbox": lambda: scale.scale_picture(pic, PictureSettings(1920, 1080), "f32"),
            "fold": lambda: resize_crossfade_roll(plane, 1080, 1920, 128, "f32")}
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.fp32_precision,
             torch.backends.fp32_precision)
    try:
        TF32_SWITCHES[switch]()
        setting = reduced_precision_setting("cuda")
        assert setting is not None
        for what, run in runs.items():
            with pytest.raises(RuntimeError, match="IEEE f32") as err:
                run()
            assert setting in str(err.value), what
        switch_tf32_off()
        for what, run in runs.items():
            run()
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.fp32_precision = saved[1]
        torch.backends.fp32_precision = saved[2]
        torch.backends.cuda.matmul.allow_tf32 = False


# -- the batched forms (the fleet, the stems) ------------------------------------


def _eq_batch(dev, B, S, seed):
    rng = np.random.default_rng(seed)
    t = lambda *shape, lo=-1.0, hi=1.0: torch.from_numpy(
        rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    return (t(3, B, S), t(3, B, S), t(B, 4, 2, lo=-0.1, hi=0.1), t(B, 3, lo=0.5, hi=2.0))


def _batch_sizes():
    """B = 1, 2 and one either side of the cooperative grid's limit at one
    CTA a block (eq and envelope)."""
    eq_r = eqc.resident_tiles(0)
    env_r = envc.resident_tiles(0)
    return [1, 2, eq_r - 1, eq_r, eq_r + 1], [1, 2, env_r - 1, env_r, env_r + 1]


@pytest.mark.parametrize("S", [1, eqc.RUN + 1, eqc.THREADS * eqc.RUN - 1,
                               eqc.THREADS * eqc.RUN, eqc.ROWS_THREADS * eqc.ROWS_RUN + 1, 12_000])
def test_batched_eq_kernel_matches_twin(dev, S):
    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    for B in _batch_sizes()[0]:
        x, xd, poles, gains = _eq_batch(dev, B, S, B * 7 + S)
        pk, pt = poles, poles
        for blk in range(3):
            n0 = eqc.eq_cascade_cuda.launches
            got, pk = eqc.eq_cascade_batched(x[blk], xd[blk], pk, gains, *f)
            assert eqc.eq_cascade_cuda.launches == n0 + 1
            want, pt = eqc.eq_cascade_torch_batched(x[blk], xd[blk], pt, gains, *f)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **EQ_TOL,
                                       err_msg=f"B={B} S={S}")
            np.testing.assert_allclose(pk.cpu().numpy(), pt.cpu().numpy(), **EQ_TOL)


@pytest.mark.parametrize("S", [1, envc.TILE - 1, envc.TILE + 1,
                               envc.THREADS * envc.ROWS_LANES[0] + 1, 32_768])
def test_batched_envelope_kernel_matches_twin(dev, S):
    rng = np.random.default_rng(S)
    for B in _batch_sizes()[1]:
        x = torch.from_numpy(rng.choice([0.0, 1.0, 0.5], size=(3, B, S), p=[0.01, 0.01, 0.98])
                             .astype(np.float32)).to(dev)
        st = {k: v.expand(B).contiguous() for k, v in _env_state(dev).items()}
        params = {k: v.expand(B).contiguous() for k, v in _env_params(dev).items()}
        sk, stw = st, st
        for blk in range(3):
            got, sk = envc.envelope_block_batched(x[blk], sk, params, 1000 / 48_000)
            want, stw = envc.envelope_block_torch_batched(x[blk], stw, params, 1000 / 48_000)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ENV_ATOL,
                                       err_msg=f"B={B} S={S}")
            for k in ("mode_on", "on_pos", "off_pos"):
                assert torch.equal(sk[k], stw[k]), k
            np.testing.assert_allclose(sk["off_amp"].cpu().numpy(),
                                       stw["off_amp"].cpu().numpy(), atol=ENV_ATOL)


# the rows forms: one CTA a row; the look-back over 1, 3 and 64 CTAs (a CTA
# that walks a row's tiles by ticket, CTAs that take turns, more CTAs than
# tiles)
ROWS_SPLITS = [(1, 0), (2, 1), (2, 3), (2, 64)]


@pytest.mark.parametrize("form,ctas", ROWS_SPLITS)
@pytest.mark.parametrize("lane,S", [(16, 5 * 4096 + 17), (32, 3 * 8192 + 1), (1, 3000),
                                    (2, 512)])
def test_batched_envelope_rows_forms_equal_the_twin(dev, form, ctas, lane, S):
    """The rows forms at small B x S with every split forced: outputs and
    state bit-equal to the batched twin over 3 carried blocks (gates with
    edges at T-1, T, T+1 of every tile boundary, the first and last sample),
    one launch a call."""
    B, T = 3, envc.THREADS * lane
    tiles = -(-S // T)
    plan = envc.BatchPlan(form, lane, tiles, ctas or B)
    rng = np.random.default_rng(S + ctas)
    x = torch.from_numpy(np.stack([tile_edge_gates(np, "tile_edges", S, T, 3, rng)
                                   .reshape(3, S) for _ in range(B)], 1)).to(dev)
    params = {k: v.expand(B).contiguous() for k, v in _env_params(dev).items()}
    params["attack_ms"] = torch.tensor([25.0, 0.0, 3.0], device=dev)
    sk = {k: v.expand(B).contiguous() for k, v in _env_state(dev).items()}
    stw = dict(sk)
    for blk in range(3):
        n = envc.envelope_block_cuda.launches
        got, sk = envc._launch(x[blk].contiguous(), 0, sk, params, 1000 / 48_000, plan=plan)
        assert envc.envelope_block_cuda.launches == n + 1
        want, stw = envc.envelope_block_torch_batched(x[blk], stw, params, 1000 / 48_000)
        torch.cuda.synchronize()
        assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0)), (blk, form, ctas)
        for k in envc._STATE:
            assert torch.equal(sk[k].nan_to_num(-1.0), stw[k].nan_to_num(-1.0)), k


@pytest.mark.parametrize("S", [12_000, 12_800])
def test_batched_envelope_module_takes_the_kernel_at_the_fleets_shapes(dev, S):
    """``EnvelopeDef.run_block`` under ``torch.func.vmap`` at the fleet's
    own B x S (8,192 sessions in 15- and 16-tick blocks at 48 kHz, under the
    single block's gate): one kernel launch a block over 3 carried blocks,
    against the batched twin, with gates and params drawn from the seed."""
    from mixlab_tpu_torch.dsp.envelope import PALLAS_THRESHOLD, EnvelopeDef
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.protocol import EnvelopeParams

    B, cfg = 8192, EngineConfig(sample_rate=48_000)
    block = BlockSpec(S // cfg.samples_per_tick)
    assert block.n_samples(cfg) == S < PALLAS_THRESHOLD
    g = torch.Generator(device=dev).manual_seed(S)
    u = torch.rand((3, B, S), generator=g, device=dev)
    x = torch.where(u < 1e-3, 1.0, torch.where(u < 2e-3, 0.0, 0.5))
    del u
    params = {k: lo + (hi - lo) * torch.rand(B, generator=g, device=dev) for k, lo, hi in (
        ("attack_ms", 1.0, 50.0), ("decay_ms", 1.0, 500.0), ("sustain_amplitude", 0.0, 1.0),
        ("release_ms", 1.0, 300.0))}
    sk = {k: v.expand(B).contiguous() for k, v in _env_state(dev).items()}
    stw = dict(sk)
    td = EnvelopeDef()
    run = torch.func.vmap(lambda x, st, aux: td.run_block(
        EnvelopeParams(), aux, None, st, [x], cfg, block, dev)[:2])
    for blk in range(3):
        n = envc.envelope_block_cuda.launches
        sk, (got,) = run(x[blk], sk, params)
        assert envc.envelope_block_cuda.launches == n + 1
        want, stw = envc.envelope_block_torch_batched(x[blk], stw, params, 1000 / 48_000)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= ENV_ATOL, blk
        for k in ("mode_on", "on_pos", "off_pos"):
            assert torch.equal(sk[k], stw[k]), k
        assert (sk["off_amp"] - stw["off_amp"]).abs().max().item() <= ENV_ATOL


@pytest.mark.parametrize("form,ctas", ROWS_SPLITS)
@pytest.mark.parametrize("key", ["flagship", "sink zoo", "peak"])
def test_batched_region_rows_forms_match_the_twin(dev, form, ctas, key):
    """The region's rows forms with every split forced: the flagship's plan
    (operand 0 shared, row stride 0), the sink zoo's (i16 operands, a PEAK)
    and a PEAK plan with a NaN in one row, over 3 rows of 12,800 samples in
    tiles of 1,024 (13 a row, the last of 512) and 8,320 (8 and a last tile
    of one chunk), 2 carried blocks: taps and exits within 2e-5 of the
    batched twin, scalar taps the exact max of the launch's own taps, one
    launch a call."""
    from mixlab_tpu_torch.engine import region_cuda as rc

    plan, row, consts = region_plans(torch)[key]
    consts = consts.to(dev)
    g = torch.Generator(device=dev).manual_seed(ctas)
    B = 3
    for S in (12_800, 8_320):
        bp = rc.BatchPlan(form, 8, -(-S // 1024), ctas or B)
        s0 = torch.rand((B, plan.n_ef), generator=g, device=dev) * 0.2 - 0.1
        sf = {"twin": s0.clone(), "kernel": s0.clone()}
        for blk in range(2):
            ops, pf = region_inputs(torch, g, plan, row, B, S, dev,
                                    (0,) if key == "flagship" else (),
                                    key == "peak" and blk == 1)
            want = rc.region_part_torch_batched(plan, ops, pf, sf["twin"], S, consts, B)
            n = rc.region_part_cuda.launches
            got = rc.region_part_batched(plan, ops, pf, sf["kernel"], S, consts, B, form=bp)
            torch.cuda.synchronize()
            assert rc.region_part_cuda.launches == n + 1
            sf = {"twin": want[2], "kernel": got[2]}
            for x, y in zip(got, want):
                assert rows_err(torch, x, y) <= REGION_ATOL, (S, blk)
            assert peaks_exact(torch, plan, ops, got[0], got[1])


@pytest.mark.parametrize("ctas", [None, 1, 2])  # one CTA a row, one CTA, 2 CTAs walking 3 rows
def test_batched_eq_rows_form_matches_the_twin(dev, ctas):
    """The eq's one CTA a row with every split forced, 3 rows with their own
    poles and gains over 3 carried blocks, S cut so the last tile holds one
    sample, one chunk of 128 or most of a tile, and odd S whose rows are not
    16-byte aligned: output and poles within 2e-5 of the batched twin, one
    launch a call."""
    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    T = eqc.ROWS_THREADS * eqc.ROWS_RUN
    for S in (3 * T + 1, 2 * T + 128, 5 * T - 7, 12_001):
        B = 3
        x, xd, poles, gains = _eq_batch(dev, B, S, S + (ctas or 0))
        plan = eqc.BatchPlan(eqc.FORM_ROWS, eqc.ROWS_RUN, -(-S // T), ctas or B,
                             eqc.ROWS_THREADS)
        pk, pt = poles, poles
        for blk in range(3):
            n = eqc.eq_cascade_cuda.launches
            got, pk = eqc._launch(x[blk], xd[blk], pk, gains, *f, 0, plan=plan)
            assert eqc.eq_cascade_cuda.launches == n + 1
            want, pt = eqc.eq_cascade_torch_batched(x[blk], xd[blk], pt, gains, *f)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **EQ_TOL,
                                       err_msg=f"S={S} block {blk}")
            np.testing.assert_allclose(pk.cpu().numpy(), pt.cpu().numpy(), **EQ_TOL)


def test_batched_eq_refuses_another_tile(dev):
    """The kernel's tile is fixed: a plan naming another is refused by the C
    entry point, not run."""
    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    x, xd, poles, gains = _eq_batch(dev, 2, 12_000, 0)
    for threads, run in ((256, 16), (128, 8)):
        plan = eqc.BatchPlan(eqc.FORM_ROWS, run, -(-12_000 // (threads * run)), 2, threads)
        with pytest.raises(RuntimeError, match="eq_cascade kernel launch"):
            eqc._launch(x[0], xd[0], poles, gains, *f, 0, plan=plan)


@pytest.mark.parametrize("kernel", ["envelope", "region"])
def test_captured_lookback_launch_matches_the_twin_on_every_replay(dev, kernel):
    """A look-back launch at a shape whose plan takes it, captured into a
    CUDA graph and replayed with new inputs, an eager call after each
    replay: every replay and call the twin's, every launch counted in the
    scratch's header (the launch's number lives on the device,
    csrc/rows.cuh)."""
    import chip_smoke

    chip_smoke.lookback_replays(torch, dev, kernel)


@pytest.mark.parametrize("kernel", ["envelope", "region"])
def test_two_threads_of_lookback_launches_on_one_stream_match_the_twin(dev, kernel):
    import chip_smoke

    chip_smoke.lookback_threads(torch, dev, kernel)


@pytest.mark.parametrize("kernel", ["envelope", "region"])
def test_capture_refuses_a_status_scratch_made_in_it(dev, kernel):
    """A look-back launch captured on a stream that has no status scratch
    yet is refused: a scratch made in the capture would be zeroed only when
    the graph replays."""
    import chip_smoke

    make, call, _, _, _ = chip_smoke.lookback_cases(torch, dev)[kernel]
    static = make(0)
    call(static)  # a call on another stream: its scratch is that stream's
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="status scratch"):
        with torch.cuda.graph(graph, stream=side):
            call(static)


def test_media_player_uploads_complete_pictures_to_the_card(dev):
    """The MediaPlayer's uploads land on the engine's device, complete when
    the frame is pushed: a Y4M upload's frames, read back on the card's own
    stream right after they come out of the feed, equal the file's planes.
    The imdct's matrix form on the card matches the numpy IMDCT (2e-3)."""
    import io

    from mixlab_tpu_torch.av.vorbis import imdct_batch, imdct_batch_torch
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.feeds import MediaSourceFeed
    from mixlab_tpu_torch.engine.media_player import MediaPlayer
    from mixlab_tpu_torch.io_host import throttle

    w, h, n = 1920, 1080, 4
    rng = np.random.default_rng(4)
    frames = [[rng.integers(0, 256, s, dtype=np.uint8) for s in ((h, w), (h // 2, w // 2),
                                                                 (h // 2, w // 2))]
              for _ in range(n)]
    blob = f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420\n".encode() + b"".join(
        b"FRAME\n" + b"".join(p.tobytes() for p in f) for f in frames)
    cfg = EngineConfig(sample_rate=44_100)
    feed = MediaSourceFeed(cfg)
    wait_until = throttle.MediaThrottle.wait_until
    throttle.MediaThrottle.wait_until = lambda self, t: None
    player = MediaPlayer(io.BytesIO(blob), feed, cfg, dev)
    player.start()
    try:
        for i in range(2 * n):  # past the loop at EOF
            pts, frame = feed.video_q.get(timeout=30)
            planes = frame.picture.planes
            assert all(p.device.type == "cuda" for p in planes.values())
            for k, want in zip("yuv", frames[i % n]):
                assert torch.equal(planes[k].cpu(), torch.from_numpy(want)), (i, k)
    finally:
        player.stop()
        player.join(timeout=5)
        throttle.MediaThrottle.wait_until = wait_until
    assert not player.is_alive()
    specs = rng.normal(size=(8, 256)).astype(np.float32)
    got = imdct_batch_torch(specs, device=dev)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), imdct_batch(specs), atol=2e-3)


def test_rtmp_ingest_uploads_pictures_to_the_card(dev):
    """The RTMP ingest's pure tier, given the card, hands the mountpoint
    pictures on it, complete: the port's CAVLC intra stream of two 1080p
    pictures over loopback RTMP, each picture equal to the decoder's."""
    import asyncio

    from mixlab_tpu_torch.av import flv
    from mixlab_tpu_torch.av.h264dec import PureH264Decoder
    from mixlab_tpu_torch.av.h264enc import PureH264Stream
    from mixlab_tpu_torch.io_host import source
    from mixlab_tpu_torch.io_host.rtmp import client, server
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings

    w, h = 1920, 1080
    rng = np.random.default_rng(5)
    enc = PureH264Stream(PictureSettings(w, h), mode="cavlc", qp=30)
    units = []
    for _ in range(2):
        enc.feed(Picture(PictureSettings(w, h), {
            k: rng.integers(0, 256, s, dtype=np.uint8)
            for k, s in (("y", (h, w)), ("u", (h // 2, w // 2)), ("v", (h // 2, w // 2)))}))
        ((_key, avcc),) = enc.poll_access_units()
        units.append(avcc)
    dec = PureH264Decoder(enc.dcr)
    want = [dec.decode(u)[-1][1:] for u in units]
    recv = source.RTMP_MOUNTPOINTS.listen("card-ingest")
    key = flv.VideoFrameType.KEY_FRAME

    async def go():
        async def on_conn(reader, writer):
            try:
                await server.accept(reader, writer, dev)
            finally:
                writer.close()

        srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        pub = await client.start("127.0.0.1", srv.sockets[0].getsockname()[1], "card-ingest", "k")
        pub.publish_video(0, flv.VideoPacket(key, flv.VideoPacketType.SEQUENCE_HEADER, 0,
                                             enc.dcr).to_bytes())
        for i, avcc in enumerate(units):
            pub.publish_video(33 * (i + 1), flv.VideoPacket(key, flv.VideoPacketType.NALU, 0,
                                                            avcc).to_bytes())
        await pub.close()
        srv.close()
        await srv.wait_closed()

    try:
        asyncio.run(go())
        got = []
        while (f := recv.read_video()) is not None:
            got.append(f.data.picture.planes)
    finally:
        recv.close()
    assert len(got) == len(want)
    for planes, ref in zip(got, want):
        for k, plane in zip("yuv", ref):
            assert planes[k].device.type == "cuda"
            assert torch.equal(planes[k].cpu(), torch.from_numpy(plane)), k


# -- the mesh paths: two shards on the one card --------------------------------------


def test_stems_over_two_shards_of_the_card_match_one_device(dev):
    """The flagship's 5 stems over [cuda:0] x 2 (a pad stem on the second
    shard), 16-tick blocks at 48 kHz (12,800 samples: the stems take the
    region program, as the JAX stems do): the master equals the one-device
    step's within 2e-4, one batched region launch a shard and no eq
    launch."""
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.stems import stem_parallel_step

    ws, mon = build_16_module_graph()
    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(16)
    fn1, args1, _ = stem_parallel_step(ws, cfg, block, str(mon.value), n_stems=5, device="cuda")
    _, want = fn1(*args1(0))
    fn, make_args, _ = stem_parallel_step(ws, cfg, block, str(mon.value), n_stems=5,
                                          mesh=make_mesh(2, devices=["cuda:0"]))
    args = make_args(0)
    eqc.eq_cascade_cuda.launches = region_cuda.region_part_cuda.launches = 0
    _, got = fn(*args)
    torch.cuda.synchronize()
    assert (region_cuda.region_part_cuda.launches, eqc.eq_cascade_cuda.launches) == (2, 0)
    assert (got - want).abs().max().item() <= 2e-4


def test_fleet_over_two_shards_of_the_card_matches_one_device(dev):
    """8 flagship sessions with their own params over [cuda:0] x 2, 15-tick
    blocks: every session's taps equal the one-device fleet's bit for bit,
    over two carried blocks."""
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(15)
    wss = fleet_workspaces(8)
    one = Fleet.build(wss[0], 8, cfg, block, per_instance_params=wss, device="cuda")
    two = Fleet.build(wss[0], 8, cfg, block, per_instance_params=wss,
                      mesh=make_mesh(2, devices=["cuda:0"]))
    for b in range(2):
        want, got = one.run_block(b * 12_000), two.run_block(b * 12_000)
        for g, w in zip(got["16"]["audio"], want["16"]["audio"]):
            assert torch.equal(g, w)


def test_threaded_structural_edit_is_warmed_off_the_engine_thread(dev):
    """The realtime engine on the card, threaded: a structural edit (an
    oscillator into the Monitor) is warmed on the compile thread and adopted
    between ticks; ticks go on meanwhile and the Monitor then hears the
    oscillator."""
    import threading
    import time

    import chip_smoke
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.engine import Engine

    eng, ids, sid = chip_smoke.realtime_engine("cuda", ())
    warms = []

    def warm(patch, gen, warm_args):
        ok = Engine._warm_and_stage(eng, patch, gen, warm_args)
        warms.append((threading.current_thread().name, ok))
        return ok

    eng._warm_and_stage = warm
    pipe = eng.monitor_pipe(ids["monitor"])
    eng.start()
    try:
        time.sleep(0.3)
        t0, new = eng.tick, p.ModuleId(eng.ws.module_seq + 1)
        eng.update(sid, p.WorkspaceMessage(100, p.CreateModule(p.ModuleParams(
            "Oscillator", p.OscillatorParams(1000.0, p.Waveform.SQUARE)), p.WindowGeometry())))
        deadline = time.time() + 5
        while time.time() < deadline and new not in eng.ws.modules:
            time.sleep(0.01)
        eng.update(sid, p.WorkspaceMessage(101, p.CreateConnection(
            p.InputId(ids["monitor"], 1), p.OutputId(new, 1))))
        deadline = time.time() + 10
        while time.time() < deadline and new not in eng._patch.order:
            time.sleep(0.01)
        assert new in eng._patch.order and eng.tick > t0
        assert warms and all(name == "compile" and ok for name, ok in warms)
        time.sleep(0.2)
        while not pipe.q.empty():
            pipe.q.get_nowait()
        _, audio, _ = pipe.q.get(timeout=5)
        assert float(np.abs(audio).max()) > 0.5  # the square wave
    finally:
        eng.stop()


def test_pipeline_depth_routes_the_same_items_on_the_card(dev):
    """Depth 2 on the card routes depth 0's monitor audio, two ticks later,
    through its pinned copies; ``flush_inflight`` routes the last two."""
    import chip_smoke

    items = {}
    for d in (0, 2):
        eng, ids, _ = chip_smoke.realtime_engine("cuda", (), pipeline_depth=d)
        pipe = eng.monitor_pipe(ids["monitor"])
        got = []
        try:
            for _ in range(6):
                eng.tick_once()
                while not pipe.q.empty():
                    got.append(pipe.q.get_nowait())
            assert len(got) == 6 - d
            eng.flush_inflight()
            while not pipe.q.empty():
                got.append(pipe.q.get_nowait())
        finally:
            eng.stop()
        items[d] = got
    assert [t0 for t0, _, _ in items[2]] == [t0 for t0, _, _ in items[0]]
    for (_, a, _), (_, b, _) in zip(items[2], items[0]):
        assert np.array_equal(a, b)
