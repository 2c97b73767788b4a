"""The pure tier's AAC-LC encoder in its codec process (``av/codecs.py``
``PureAacStream``, ``av/aac_worker.py``), on the CPU.

Its ADTS frames are the in-process encoder's and the JAX package's
``PureAacStream``'s, byte for byte and in the same polls; no child outlives
its stream, its Monitor's codec thread or its project handle; a child that
dies raises in the codec thread.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mixlab_tpu.av import codecs as jcodecs
from mixlab_tpu.av.encode_stream import f32_to_i16 as jax_f32_to_i16
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.av import codecs
from mixlab_tpu_torch.av.aac import adts_frame
from mixlab_tpu_torch.av.aacenc import AacLcEncoder
from mixlab_tpu_torch.av.encode_stream import f32_to_i16
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import _MonitorPipe
from mixlab_tpu_torch.engine.project import open_or_create
from mixlab_tpu_torch.server.monitor import MonitorPipeline

ROOT = Path(__file__).resolve().parents[1]


def seeded_pcm(rate, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    sig = np.stack([np.sin(2 * np.pi * 330 * t), np.sin(2 * np.pi * 495 * t)], 1) * 0.5
    return (sig + rng.normal(0, 0.05, sig.shape)).astype(np.float32)


@pytest.mark.parametrize("bitrate", [None, 160_000])
def test_codec_process_frames_equal_in_process_and_jax(bitrate):
    """3 s fed in ticks of 735 frames, polled after each: the same frames in
    the same polls as the JAX package's in-process stream, and the frames
    of ``AacLcEncoder`` in this process."""
    pcm = seeded_pcm(44_100, 3.0, seed=0 if bitrate is None else 1)
    port = codecs.PureAacStream(44_100, 2, bitrate=bitrate)
    jax = jcodecs.PureAacStream(44_100, 2, bitrate=bitrate)
    try:
        polls_t, polls_j = [], []
        for i in range(0, len(pcm), 735):
            chunk = pcm[i:i + 735].reshape(-1)
            port.feed(f32_to_i16(chunk))
            jax.feed(jax_f32_to_i16(chunk))
            polls_t.append(port.poll_frames())
            polls_j.append(jax.poll_frames())
        assert polls_t == polls_j
        frames = [f for poll in polls_t for f in poll]
        assert len(frames) == len(pcm) // 1024
        enc = AacLcEncoder(44_100, 2, bitrate=bitrate)
        i16 = f32_to_i16(pcm.reshape(-1)).reshape(-1, 2)
        assert frames == [adts_frame(enc.encode_granule(i16[k * 1024:(k + 1) * 1024]), enc.asc)
                          for k in range(len(frames))]
        assert port.configuration_data() == jax.configuration_data() == enc.asc.to_bytes()
    finally:
        port.close()
    assert port.proc.poll() == 0


def test_codec_process_imports_no_torch():
    code = ("import sys, mixlab_tpu_torch.av.aac_worker; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_unsupported_rate_is_refused_before_a_child_starts():
    from mixlab_tpu_torch.av.aacenc import AacEncodeError

    with pytest.raises(AacEncodeError, match="unsupported sample rate"):
        codecs.PureAacStream(7_350, 2)


def _pipeline(monkeypatch, cfg):
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    pipe = _MonitorPipe()
    pipeline = MonitorPipeline(pipe, cfg)
    pipeline.start()
    assert pipeline._codecs_ready.wait(60)
    return pipe, pipeline


def _items(cfg, n, t0=0):
    spt = cfg.samples_per_tick
    pcm = seeded_pcm(cfg.sample_rate, n * spt / cfg.sample_rate)
    return [((t0 + k) * spt, pcm[k * spt:(k + 1) * spt], None) for k in range(n)]


def test_stopped_pipeline_leaves_no_child(monkeypatch):
    cfg = EngineConfig(sample_rate=44_100)
    pipe, pipeline = _pipeline(monkeypatch, cfg)
    sub = pipeline.broadcast.subscribe()
    for item in _items(cfg, 6):
        pipe.q.put(item, timeout=5)
    deadline = time.monotonic() + 30
    segments = 0
    while segments < 4 and time.monotonic() < deadline:
        try:
            segments += b'"segment"' in sub.get(timeout=1).partition(b"\n")[0]
        except Exception:
            pass
    assert segments >= 4  # 4,410 samples: four AAC frames
    proc = pipeline._aac.proc
    assert proc.poll() is None
    pipeline.stop()
    pipeline.join(timeout=10)
    assert not pipeline.is_alive() and proc.poll() == 0


def test_killed_child_raises_in_the_codec_thread(monkeypatch):
    cfg = EngineConfig(sample_rate=44_100)
    faults = []
    monkeypatch.setattr(threading, "excepthook", lambda args: faults.append(args.exc_value))
    pipe, pipeline = _pipeline(monkeypatch, cfg)
    pipeline._aac.proc.kill()
    pipeline._aac.proc.wait()
    for item in _items(cfg, 4):
        pipe.push(item)  # drops once the dead thread stops taking items
    pipeline.join(timeout=30)
    assert not pipeline.is_alive()
    assert len(faults) == 1 and isinstance(faults[0], RuntimeError)
    assert "AAC codec process has exited" in str(faults[0])


def test_closed_project_leaves_no_child(tmp_path, monkeypatch):
    """A ProjectHandle with a Monitor: its codec thread's AAC process ends
    when the handle closes."""
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    proj = open_or_create(tmp_path / "p.mixlab", EngineConfig(sample_rate=44_100),
                          device="cpu")
    eng = proj.engine
    sid, _, _ = eng.connect_session()
    eng.update(sid, tp.WorkspaceMessage(1, tp.CreateModule(
        tp.ModuleParams("Monitor", None), tp.WindowGeometry())))
    (pipeline,) = eng._monitor_pipelines.values()
    assert pipeline._codecs_ready.wait(60)
    proc = pipeline._aac.proc
    for _ in range(3):
        eng.tick_once()
    proj.close()
    assert not pipeline.is_alive() and proc.poll() == 0
