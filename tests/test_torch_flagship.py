"""The offline render slice end to end: the flagship 16-module graph through
the port against the float64 oracle and against the JAX package, the graph
and project files shared by both packages, and the render CLI."""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from bench import build_16_module_graph as jax_flagship
from mixlab_tpu.av.flacdec import decode_flac_file
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.project import ProjectBase as JaxProjectBase
from mixlab_tpu.engine.scan_render import render_scanned as jax_render_scanned
from mixlab_tpu.io_host.wav import decode_frames, parse_header
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch import render_cli
from mixlab_tpu_torch.convert import to_numpy, to_torch
from mixlab_tpu_torch.engine import scan_render
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.engine.project import ProjectBase
from mixlab_tpu_torch.engine.render import render
from mixlab_tpu_torch.engine.scan_render import render_scanned, scan_blocks
from mixlab_tpu_torch.flagship import build_16_module_graph
from test_whole_graph_oracle import oracle_16_module
from torch_support import parse_fmp4

CPU = torch.device("cpu")
CFG44 = EngineConfig(sample_rate=44_100)
CFG44_J = JaxEngineConfig(sample_rate=44_100)
# Monitor taps vs the JAX package's jitted render: one ulp of FmSine's f32
# phase argument n*2pi below 4096 rad (t < 2.9 s).  XLA's fused evaluation
# of n = carrier + f_amp*x*t rounds differently from op-by-op evaluation (the
# JAX package's own jitted and eager renders differ by 2.4e-4 here); every
# module taken alone matches at 2e-6 (test_torch_modules.py).
TAP_ATOL = 2.0 ** -11
STATE_TOL = dict(rtol=2e-5, atol=2e-5)


def _wire(saved) -> str:
    """A saved workspace as its JSON text: the two packages' protocol types
    are distinct classes, their encodings must be identical."""
    return json.dumps(saved, sort_keys=True)


def test_flagship_graph_matches_bench():
    ws, mon = build_16_module_graph()
    ws_j, mon_j = jax_flagship()
    assert _wire(ws.to_persist()) == _wire(ws_j.to_persist())
    assert [m.value for m in ws.run_order()] == [m.value for m in ws_j.run_order()]
    assert mon.value == mon_j.value


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_project_files_interchange(tmp_path, direction):
    path = tmp_path / "flagship.mixlab"
    ws, _ = build_16_module_graph()
    saved = ws.to_persist()
    writer, reader = ((JaxProjectBase, ProjectBase) if direction == "jax_to_port"
                      else (ProjectBase, JaxProjectBase))
    w = writer(path)
    w.write_workspace(saved)
    w.close()
    r = reader(path)
    try:
        back = r.read_workspace()
        version = r._conn.execute("SELECT version FROM schema_migrations").fetchone()[0]
    finally:
        r.close()
    assert _wire(back) == _wire(saved) and version == 20200805
    assert _wire(Workspace.from_persist(back).to_persist()) == _wire(saved)


def test_flagship_48k_matches_oracle():
    """tests/test_whole_graph_oracle.py's check, through the port."""
    cfg = EngineConfig(sample_rate=48_000)
    ws, mon = build_16_module_graph()
    got = render(ws, n_ticks=6, cfg=cfg, block_ticks=3, device=CPU).monitor_audio(mon)
    want = oracle_16_module(6 * cfg.samples_per_tick)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-3)
    assert np.abs(got).max() > 0.5


def _flat_state(state):
    return {(k, n): v for k, st in state.items() if st for n, v in st.items()}


def _assert_state_close(got, want):
    got, want = _flat_state(to_numpy(got)), _flat_state(
        jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), key
        else:
            np.testing.assert_allclose(g, w, **STATE_TOL, err_msg=str(key))


def test_flagship_scanned_matches_jax_and_continues_from_jax_state():
    """Two 60-tick blocks at 44.1 kHz (the CLI's defaults: both kernels'
    gates are open) through render_scanned in both packages; then JAX's
    state after block 1, carried over by convert.py, continues in the port
    to JAX's block 2."""
    ws, mon = build_16_module_graph()
    ws_j, _ = jax_flagship()
    key = str(mon.value)

    _, (state, taps) = render_scanned(ws, 120, CFG44, block_ticks=60, device=CPU)
    _, (state_j, taps_j) = jax_render_scanned(ws_j, 120, CFG44_J, block_ticks=60)
    for got, want in zip(taps[key]["audio"], taps_j[key]["audio"]):
        assert tuple(got.shape) == np.asarray(want).shape == (2, 60, 735)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TAP_ATOL)
    _assert_state_close(state, state_j)
    assert float(taps[key]["audio"][0].abs().max()) > 0.5

    # JAX block 1 -> convert -> port block 2
    _, (state_j1, _) = jax_render_scanned(ws_j, 60, CFG44_J, block_ticks=60)
    patch = compile_patch(ws, CFG44, BlockSpec(60), CPU)
    state1 = to_torch(jax.tree.map(np.asarray, state_j1), CPU)
    state2, taps2 = scan_blocks(patch, patch.prepare_aux(ws), state1,
                                t0=60 * CFG44.samples_per_tick, n_blocks=1)
    for got, want in zip(taps2[key]["audio"], taps_j[key]["audio"]):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[1], atol=TAP_ATOL)
    _assert_state_close(state2, state_j)


@pytest.mark.parametrize("ext", ["wav", "flac"])
def test_render_cli_cpu_end_to_end(tmp_path, capsys, ext):
    ws, _ = build_16_module_graph()
    proj = tmp_path / "flagship.mixlab"
    with ProjectBase(proj) as base:
        base.write_workspace(ws.to_persist())
    out = tmp_path / f"out.{ext}"
    audio = render_cli.main([str(proj), str(out), "--seconds", "2",
                             "--device", "cpu"])
    assert audio.shape == (2 * 44_100, 2) and audio.dtype == np.float32
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.5
    data = out.read_bytes()
    if ext == "wav":
        fmt, body, size = parse_header(data)
        assert fmt.sample_rate == 44_100 and fmt.channels == 2
        pcm = decode_frames(fmt, data[body:body + size])
    else:
        pcm, rate, _ = decode_flac_file(data)
        assert rate == 44_100
    assert pcm.shape == audio.shape
    # 16-bit PCM of the clipped float render
    np.testing.assert_allclose(pcm / 32767.0, np.clip(audio, -1, 1), atol=1.0 / 32767)
    assert "wrote" in capsys.readouterr().out


def test_render_cli_writes_wav_for_any_other_extension(tmp_path):
    """As the JAX CLI: any extension but ``.flac`` and ``.mp4`` is a WAV
    file; a ``.pcm`` output has the ``.wav`` output's frames (1 s)."""
    ws, _ = build_16_module_graph()
    proj = tmp_path / "flagship.mixlab"
    with ProjectBase(proj) as base:
        base.write_workspace(ws.to_persist())
    frames = {}
    for name in ("out.wav", "out.pcm", "out.WAVE"):
        render_cli.main([str(proj), str(tmp_path / name), "--seconds", "1", "--device", "cpu"])
        with wave.open(str(tmp_path / name), "rb") as w:
            assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (2, 2, 44_100)
            assert w.getnframes() == 44_100
            frames[name] = w.readframes(w.getnframes())
    assert frames["out.pcm"] == frames["out.wav"] == frames["out.WAVE"]


def test_render_cli_refuses_mp4(tmp_path, monkeypatch):
    """An .mp4 export is refused where it cannot be made: a project without
    a Monitor, and the libavcodec shim tier forced where its libraries are
    absent."""
    from mixlab_tpu_torch.native import avshim

    ws = Workspace()
    ws.create_module(tp.ModuleParams("Oscillator", tp.OscillatorParams()), tp.WindowGeometry())
    proj = tmp_path / "no_monitor.mixlab"
    with ProjectBase(proj) as base:
        base.write_workspace(ws.to_persist())
    with pytest.raises(SystemExit, match="no Monitor module"):
        render_cli.main([str(proj), str(tmp_path / "x.mp4"), "--device", "cpu"])
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "shim")
    monkeypatch.setattr(avshim, "available", lambda: False)
    with pytest.raises(RuntimeError, match="shim is unavailable"):
        render_cli.main([str(proj), str(tmp_path / "x.MP4"), "--device", "cpu"])
    assert not (tmp_path / "x.mp4").exists() and not (tmp_path / "x.MP4").exists()


def test_render_cli_writes_mp4(tmp_path, monkeypatch):
    """The flagship with its Monitor exported to .mp4 on the CPU for 1 s in
    60-tick blocks: ``ftyp``, ``moov`` with ``avc1`` and ``mp4a``, then
    ``moof``/``mdat`` pairs, with 1 s's samples (43 AAC frames of 1,024,
    10 video frames at 60 / 6 fps), read back by the JAX package's demuxer;
    the AAC frames are those of the port's WAV render of the same second."""
    from mixlab_tpu.av.mp4read import Mp4Reader
    from mixlab_tpu_torch.av.codecs import PureAacStream
    from mixlab_tpu_torch.av.encode_stream import f32_to_i16

    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    ws, _ = build_16_module_graph()
    proj = tmp_path / "flagship.mixlab"
    with ProjectBase(proj) as base:
        base.write_workspace(ws.to_persist())
    out = tmp_path / "out.mp4"
    assert render_cli.main([str(proj), str(out), "--seconds", "1", "--device", "cpu"]) is None
    data = out.read_bytes()
    walk = parse_fmp4(data)
    assert sorted(walk["codecs"].values()) == ["avc1", "mp4a"]
    assert walk["samples"] == {"mp4a": 44_100 // 1024, "avc1": 10}
    reader = Mp4Reader(data)
    video, audio = reader.video_track(), reader.audio_track()
    assert (video.codec, video.width, video.height) == ("h264", 560, 350)
    assert (audio.codec, audio.sample_rate, audio.channels) == ("aac", 44_100, 2)
    assert len(video.samples) == 10 and all(s.key for s in video.samples)
    # the audio track is the AAC of the offline render of the same second
    wav = render_cli.main([str(proj), str(tmp_path / "out.wav"), "--seconds", "1",
                           "--device", "cpu"])
    aac = PureAacStream(44_100, 2)
    aac.feed(f32_to_i16(wav.reshape(-1)))
    want = [f[7:] for f in aac.poll_frames()]  # raw blocks: the ADTS header stripped
    assert [reader.sample_data(s) for s in audio.samples] == want


def test_render_cli_writes_mp4_through_the_shim(tmp_path, monkeypatch):
    """The same export on the libavcodec shim tier (x264 and libavcodec's
    AAC): ``avc1`` at 560x350, 10 key frames, and ``mp4a`` whose samples
    are the shim's AAC of the offline render of the same second."""
    from mixlab_tpu.av.mp4read import Mp4Reader
    from mixlab_tpu_torch.av.codecs import ShimAacStream
    from mixlab_tpu_torch.av.encode_stream import f32_to_i16
    from mixlab_tpu_torch.native import avshim

    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "shim")
    ws, _ = build_16_module_graph()
    proj = tmp_path / "flagship.mixlab"
    with ProjectBase(proj) as base:
        base.write_workspace(ws.to_persist())
    out = tmp_path / "out.mp4"
    assert render_cli.main([str(proj), str(out), "--seconds", "1", "--device", "cpu"]) is None
    data = out.read_bytes()
    assert sorted(parse_fmp4(data)["codecs"].values()) == ["avc1", "mp4a"]
    reader = Mp4Reader(data)
    video, audio = reader.video_track(), reader.audio_track()
    assert (video.codec, video.width, video.height) == ("h264", 560, 350)
    assert len(video.samples) == 10 and all(s.key for s in video.samples)
    wav = render_cli.main([str(proj), str(tmp_path / "out.wav"), "--seconds", "1",
                           "--device", "cpu"])
    aac = ShimAacStream(44_100, 2, bitrate=None)
    aac.feed(f32_to_i16(wav.reshape(-1)))
    want = [f[7:] for f in aac.poll_frames()]
    aac.close()
    got = [reader.sample_data(s) for s in audio.samples]
    assert len(got) >= 40 and got == want[:len(got)]


def test_render_cli_48k_runs_the_region_and_matches_oracle(tmp_path, monkeypatch):
    """The slice's entry point at 48 kHz on the CPU: 60-tick blocks of
    48,000 samples are whole 128-sample chunks, so the default
    ``compile_patch`` takes the region program (its plain twin here)."""
    ws, _ = build_16_module_graph()
    proj = tmp_path / "flagship.mixlab"
    with ProjectBase(proj) as base:
        base.write_workspace(ws.to_persist())
    patches = []
    real = scan_render.render_scanned

    def spy(*args, **kwargs):
        patch, out = real(*args, **kwargs)
        patches.append(patch)
        return patch, out

    monkeypatch.setattr(scan_render, "render_scanned", spy)
    audio = render_cli.main([str(proj), str(tmp_path / "out.wav"), "--seconds", "2",
                             "--sample-rate", "48000", "--device", "cpu"])
    assert len(patches) == 1 and patches[0]._mega
    assert patches[0].block.n_samples(patches[0].cfg) == 48_000
    want = oracle_16_module(2 * 48_000)
    assert audio.shape == want.shape == (96_000, 2)
    np.testing.assert_allclose(audio, want, atol=3e-3)
    assert np.abs(audio).max() > 0.5


@pytest.mark.parametrize("entry", ["render", "render_scanned"])
def test_library_entry_points_default_to_the_card(entry):
    """Without ``device`` the render entry points ask for the card; on a
    machine without one that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ws, _ = build_16_module_graph()
    fn = render if entry == "render" else render_scanned
    with pytest.raises(RuntimeError, match="cuda"):
        fn(ws, 3, EngineConfig(sample_rate=48_000), block_ticks=3)
