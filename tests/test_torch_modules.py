"""The port's modules against the JAX package, module by module, on the same
seeded inputs: the elementwise kinds, and the sinks and feeds with the
per-block host buffers of the feeds (``ext_spec``, zero-filled by
``host_aux`` where the caller gives none)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as p
from mixlab_tpu.dsp.registry import get_def as jax_def
from mixlab_tpu.engine.compiler import compile_patch as jax_compile_patch
from mixlab_tpu.engine.config import BlockSpec, EngineConfig
from mixlab_tpu.engine.graph import Workspace as JaxWorkspace
from mixlab_tpu.protocol import wire as jax_wire
from mixlab_tpu_torch.dsp import audio
from mixlab_tpu_torch.dsp.registry import get_def as torch_def
from mixlab_tpu_torch.engine import config as port_config
from mixlab_tpu_torch.engine.compiler import compile_patch, upload
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.protocol import wire as port_wire

CPU = torch.device("cpu")
# (config, block): S = 2,400 (48 kHz, 3 ticks) and S = 44,100 (the CLI's
# 60-tick block at 44.1 kHz)
SIZES = [(EngineConfig(sample_rate=48_000), BlockSpec(3)),
         (EngineConfig(sample_rate=44_100), BlockSpec(60))]
# f32 elementwise math in the same order; sin may differ by an ulp between
# libms (XLA's vs PyTorch's), so modules with sin get 2e-6
ATOL = 1e-6
ATOL_SIN = 2e-6


def port_params(kind, params):
    """The JAX package's params as the port's protocol objects (the two
    packages' classes are distinct; their wire encoding is one)."""
    return port_wire.decode_module_params(
        jax_wire.encode(p.ModuleParams(kind, params))).params


def port_cfg(cfg, block):
    return (port_config.EngineConfig(sample_rate=cfg.sample_rate),
            port_config.BlockSpec(block.n_ticks))


def _stereo_np(S, rng):
    return (rng.uniform(-1, 1, S).astype(np.float32),
            rng.uniform(-1, 1, S).astype(np.float32))


def _to_jax(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(jnp.asarray(c) for c in v)
    return jnp.asarray(v)


def _to_torch(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(torch.from_numpy(c) for c in v)
    return torch.from_numpy(v)


def _flat(out):
    """Module outputs / taps -> list of numpy arrays (None and pairs
    flattened in order)."""
    res = []
    for v in out:
        if v is None:
            continue
        for c in (v if isinstance(v, tuple) else (v,)):
            res.append(c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c))
    return res


def _run_both(kind, params, inputs, cfg, block, t0, host=None):
    """One block of ``kind`` through both packages; ``host`` stands in for
    ``host_prepare`` (a feed's per-block buffers)."""
    jd, td = jax_def(kind), torch_def(kind)
    tparams = port_params(kind, params)
    tcfg, tblock = port_cfg(cfg, block)
    j_host = jd.host_prepare(params, t0, block, cfg) if host is None else {
        k: jnp.asarray(v) for k, v in host.items()}
    t_host = td.host_prepare(tparams, t0, tblock, tcfg) if host is None else host
    j_state, j_outs, j_taps = jd.run_block(
        params, jd.prepare(params, cfg), j_host,
        None, [_to_jax(v) for v in inputs], cfg, block)
    t_state, t_outs, t_taps = td.run_block(
        tparams, td.prepare(tparams, tcfg, CPU), upload(t_host, CPU),
        None, [_to_torch(v) for v in inputs], tcfg, tblock, CPU)
    assert j_state is None and t_state is None
    assert sorted(j_taps) == sorted(t_taps)
    return (_flat(j_outs) + _flat([j_taps[k] for k in sorted(j_taps)]),
            _flat(t_outs) + _flat([t_taps[k] for k in sorted(t_taps)]))


def _cases(S, rng):
    mono = rng.uniform(-1, 1, S).astype(np.float32)
    env = rng.uniform(0, 1, S).astype(np.float32)
    return [
        ("Oscillator", p.OscillatorParams(330.0, p.Waveform.SINE), [], ATOL_SIN),
        ("Oscillator", p.OscillatorParams(330.0, p.Waveform.SQUARE), [], ATOL_SIN),
        ("Oscillator", p.OscillatorParams(330.0, p.Waveform.SAW), [], ATOL),
        ("Oscillator", p.OscillatorParams(330.0, p.Waveform.TRIANGLE), [], ATOL),
        ("Oscillator", p.OscillatorParams(330.0, p.Waveform.ON), [], ATOL),
        ("FmSine", p.FmSineParams(440.0, 880.0), [env], ATOL_SIN),
        ("FmSine", p.FmSineParams(440.0, 880.0), [None], ATOL_SIN),
        ("Amplifier", p.AmplifierParams(0.5, 0.3), [_stereo_np(S, rng), env], ATOL),
        ("Amplifier", p.AmplifierParams(0.7, 0.3), [_stereo_np(S, rng), None], ATOL),
        ("Mixer", p.MixerParams(tuple(
            p.MixerChannelParams(p.Decibel(g), f, c)
            for g, f, c in [(0.0, 1.0, False), (-6.0, 0.5, True), (3.0, 0.8, True)])),
         [_stereo_np(S, rng), None, _stereo_np(S, rng)], ATOL),
        ("StereoPanner", None, [mono, None], ATOL),
        ("StereoSplitter", None, [_stereo_np(S, rng)], ATOL),
        ("Trigger", p.GateState.OPEN, [], ATOL),
        ("Trigger", p.GateState.CLOSED, [], ATOL),
        ("Monitor", None, [None, _stereo_np(S, rng)], ATOL),
        ("Monitor", None, [None, None], ATOL),
    ]


@pytest.mark.parametrize("size", range(len(SIZES)), ids=["S2400", "S44100"])
def test_elementwise_modules_match_jax(size):
    cfg, block = SIZES[size]
    S = block.n_samples(cfg)
    rng = np.random.default_rng(1000 + size)
    # a late block start exercises the f64 host phase bases
    t0 = 1_000 * S
    kinds = set()
    for kind, params, inputs, atol in _cases(S, rng):
        kinds.add(kind)
        want, got = _run_both(kind, params, inputs, cfg, block, t0)
        assert len(want) == len(got), kind
        for w, g in zip(want, got):
            assert w.shape == g.shape, (kind, params)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{kind} {params}")
    assert len(kinds) == 8  # the 7 elementwise kinds and Monitor


def _assert_same(want, got, what):
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        assert w.shape == g.shape and w.dtype == g.dtype, what
        if w.dtype == np.bool_:
            assert np.array_equal(g, w), what
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=what)


def _sink_cases(S, rng):
    """(kind, params, inputs, host buffers) for every sink and feed."""
    loud = tuple(1.5 * c for c in _stereo_np(S, rng))  # |x| > 1: clips
    quiet = tuple(0.5 * c for c in _stereo_np(S, rng))
    return [
        ("Plotter", None, [_stereo_np(S, rng)], None),
        ("Plotter", None, [None], None),
        ("OutputDevice", p.OutputDeviceParams(), [quiet], None),
        ("OutputDevice", p.OutputDeviceParams(), [loud], None),
        ("OutputDevice", p.OutputDeviceParams(), [None], None),
        ("StreamOutput", p.StreamOutputParams(), [None, _stereo_np(S, rng)], None),
        ("StreamOutput", p.StreamOutputParams(), [None, None], None),
        ("StreamInput", p.StreamInputParams(), [],
         {"pcm": rng.integers(-32768, 32767, (2, S)).astype(np.int16)}),
        ("StreamInput", p.StreamInputParams(), [],
         {"pcm": np.array([[-32768, 32767] * (S // 2)] * 2, np.int16)}),
        ("MediaSource", p.MediaSourceParams(), [],
         {"pcm": rng.uniform(-1, 1, (2, S)).astype(np.float32)}),
    ]


CASE_IDS = ["plotter", "plotter_unpatched", "output_quiet", "output_clipping",
            "output_unpatched", "stream_output", "stream_output_unpatched",
            "stream_input", "stream_input_extremes", "media_source"]


@pytest.mark.parametrize("case", range(len(CASE_IDS)), ids=CASE_IDS)
@pytest.mark.parametrize("size", range(len(SIZES)), ids=["S2400", "S44100"])
def test_sinks_and_feeds_match_jax(size, case):
    cfg, block = SIZES[size]
    S = block.n_samples(cfg)
    kind, params, inputs, host = _sink_cases(S, np.random.default_rng(2000 + size))[case]
    want, got = _run_both(kind, params, inputs, cfg, block, t0=0, host=host)
    _assert_same(want, got, f"{kind} {CASE_IDS[case]}")
    if CASE_IDS[case] in ("output_quiet", "output_clipping"):
        assert bool(got[-1]) == (CASE_IDS[case] == "output_clipping")


def _feed_graph(ws_cls, proto):
    """A StreamInput and a MediaSource, both into a 2-channel mixer that a
    Monitor taps (built the same way in either package)."""
    ws = ws_cls()
    si = ws.create_module(proto.ModuleParams("StreamInput", proto.StreamInputParams()))
    ms = ws.create_module(proto.ModuleParams("MediaSource", proto.MediaSourceParams()))
    mix = ws.create_module(proto.ModuleParams("Mixer", proto.MixerParams.with_channels(2)))
    mon = ws.create_module(proto.ModuleParams("Monitor", None))
    ws.connect(proto.InputId(mix, 0), proto.OutputId(si, 1))
    ws.connect(proto.InputId(mix, 1), proto.OutputId(ms, 1))
    ws.connect(proto.InputId(mon, 1), proto.OutputId(mix, 0))
    return ws, si, ms


@pytest.mark.parametrize("fed", ["none", "stream_input", "both"])
def test_host_aux_zero_fills_missing_feeds(fed):
    """``host_aux`` declares each feed's buffer from ``ext_spec`` and
    zero-fills what the caller does not give, as the JAX package's does;
    the rendered block then agrees with the JAX package's."""
    from mixlab_tpu_torch import protocol as tp

    cfg, block = SIZES[0]
    tcfg, tblock = port_cfg(cfg, block)
    S = block.n_samples(cfg)
    ws_j, si, ms = _feed_graph(JaxWorkspace, p)
    ws_t, _, _ = _feed_graph(Workspace, tp)
    rng = np.random.default_rng(3)
    feeds = {}
    if fed in ("stream_input", "both"):
        feeds[str(si.value)] = {"pcm": rng.integers(-32768, 32767, (2, S)).astype(np.int16)}
    if fed == "both":
        feeds[str(ms.value)] = {"pcm": rng.uniform(-1, 1, (2, S)).astype(np.float32)}
    pj = jax_compile_patch(ws_j, cfg, block)
    pt = compile_patch(ws_t, tcfg, tblock, CPU)
    hj, ht = pj.host_aux(0, ext_feeds=feeds), pt.host_aux(0, ext_feeds=feeds)
    for key in (str(si.value), str(ms.value)):
        assert sorted(ht[key]) == sorted(hj[key]) == ["pcm"]
        assert ht[key]["pcm"].dtype == np.asarray(hj[key]["pcm"]).dtype
        assert ht[key]["pcm"].shape == (2, S)
        assert np.array_equal(ht[key]["pcm"], np.asarray(hj[key]["pcm"]))
        if key not in feeds:
            assert not ht[key]["pcm"].any()
    _, taps_j = pj.run(pj.prepare_aux(ws_j), hj, pj.init_state(ws_j))
    _, taps_t = pt.run(pt.prepare_aux(ws_t), ht, pt.init_state(ws_t))
    for cj, ct in zip(taps_j["4"]["audio"], taps_t["4"]["audio"]):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=ATOL)


def test_cpu_sine_takes_one_element_first(monkeypatch):
    """The oscillators' sine on the CPU: one element on the calling thread
    before the process's first real call, then plain ``torch.sin``."""
    real, sizes = torch.sin, []
    monkeypatch.setattr(audio, "_sin_warm", False)
    monkeypatch.setattr(torch, "sin", lambda x: sizes.append(x.numel()) or real(x))
    x = torch.linspace(0.0, 400.0, 44_100)
    assert torch.equal(audio._sin(x), real(x))
    assert torch.equal(audio._sin(x), real(x))
    assert sizes == [1, 44_100, 44_100]
