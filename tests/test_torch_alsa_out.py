"""The port's ALSA output backend (``mixlab_tpu_torch/io_host/alsa_out.py``)
and ``get_backend``, and its native banded host resize, on the CPU.

ALSA: ``tests/test_alsa_out.py``'s five cases against the port, on the JAX
package's fake libasound (``mixlab_tpu/native/fake_asound.cpp``, a test
fixture built here with the same ``g++`` line, not imported): enumeration
through name hints, S16_LE interleaved playback byte for byte, the underrun
recover and 3-silence-period backoff of the reference
(output_device.rs:106-137), the backend selection, and a short write
continued with its remainder; the PCM the port's backend hands the device
equals the JAX package's.

The host resize (``native/mixlab_native.cpp`` ``scale_plane_banded``, the
publish tier's scaler): byte-equal to the JAX package's C++ of the same
name, compiled here from its source alone, and within 1 u8 LSB of the
port's numpy path.
"""

import ctypes
import pathlib
import shutil
import subprocess
import time

import numpy as np
import pytest

from mixlab_tpu_torch import native
from mixlab_tpu_torch.video import scale_host
from mixlab_tpu_torch.video.frame import Picture, PictureSettings

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SRC = ROOT / "mixlab_tpu/native/fake_asound.cpp"


@pytest.fixture()
def fake_lib(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    so = tmp_path / "libfake_asound.so"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", str(so), str(_SRC)],
        check=True, capture_output=True, timeout=120)
    return so


def _make_backend(monkeypatch, so, log, epipe_at=None, package="torch"):
    if package == "torch":
        from mixlab_tpu_torch.io_host.alsa_out import AlsaAudioBackend
    else:
        from mixlab_tpu.io_host.alsa_out import AlsaAudioBackend

    monkeypatch.setenv("MIXLAB_ALSA_LIB", str(so))
    monkeypatch.setenv("FAKE_ASOUND_LOG", str(log))
    if epipe_at is not None:
        monkeypatch.setenv("FAKE_ASOUND_EPIPE_AT", str(epipe_at))
    else:
        monkeypatch.delenv("FAKE_ASOUND_EPIPE_AT", raising=False)
    return AlsaAudioBackend()


def _played(log, n_bytes, timeout=5.0) -> bytes:
    """The PCM the fake device has taken, once it has ``n_bytes``."""
    pcm_path = pathlib.Path(str(log) + ".pcm")
    deadline = time.time() + timeout
    got = b""
    while time.time() < deadline:
        got = pcm_path.read_bytes() if pcm_path.exists() else b""
        if len(got) >= n_bytes:
            break
        time.sleep(0.02)
    return got


def test_enumeration_filters_capture_devices(monkeypatch, tmp_path, fake_lib):
    backend = _make_backend(monkeypatch, fake_lib, tmp_path / "log")
    devs = backend.devices()
    names = [n for (n, ch) in devs]
    assert names == ["default", "null"]  # "mic" (IOID=Input) filtered out
    assert all(ch == 2 for (_, ch) in devs)
    assert backend.default_device() == "default"
    jax = _make_backend(monkeypatch, fake_lib, tmp_path / "jlog", package="jax")
    assert devs == jax.devices() and jax.default_device() == backend.default_device()


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_playback_pcm_bytes_exact(monkeypatch, tmp_path, fake_lib, package):
    """Two blocks of deterministic audio, out-of-range samples clamped: the
    bytes the device takes, the same from both packages' backends."""
    log = tmp_path / "log"
    backend = _make_backend(monkeypatch, fake_lib, log, package=package)
    stream = backend.open("default", 48000)
    assert stream is not None
    t = np.arange(2048, dtype=np.float32)
    left = np.sin(t * 0.01) * 1.5  # exceeds +-1: must clamp
    right = np.cos(t * 0.02) * 0.25
    frames = np.stack([left, right], axis=1)
    assert stream.write(frames)
    expect = (np.clip(frames, -1, 1) * 32767).astype("<i2").tobytes()
    got = _played(log, len(expect))
    stream.close()
    assert got[: len(expect)] == expect
    text = log.read_text()
    assert "open default" in text
    assert "set_params fmt=2 access=3 ch=2 rate=48000" in text
    assert "close" in text


def test_underrun_recover_and_silence_backoff(monkeypatch, tmp_path, fake_lib):
    log = tmp_path / "log"
    backend = _make_backend(monkeypatch, fake_lib, log, epipe_at=0)
    stream = backend.open("default", 44100)
    assert stream is not None
    frames = np.full((256, 2), 0.5, np.float32)
    assert stream.write(frames)
    deadline = time.time() + 5.0
    while time.time() < deadline:
        text = log.read_text() if log.exists() else ""
        if "recover" in text and text.count("writei 256") >= 4:
            break
        time.sleep(0.02)
    stream.close()
    text = log.read_text()
    # first writei hit -EPIPE, then recover, 3 silence periods, retry
    assert "-EPIPE" in text
    assert "recover err=-32" in text
    lines = [line for line in text.splitlines() if line.startswith("writei 256")]
    assert len(lines) >= 5  # failed + 3 silence + retry
    arr = np.frombuffer(pathlib.Path(str(log) + ".pcm").read_bytes(), "<i2").reshape(-1, 2)
    # 3 silence periods then the real data
    assert np.array_equal(arr[: 3 * 256], np.zeros((768, 2), "<i2"))
    assert (arr[3 * 256: 4 * 256] == int(0.5 * 32767)).all()


def test_get_backend_env_selection(monkeypatch, tmp_path, fake_lib):
    from mixlab_tpu_torch.io_host import audio_out

    saved = audio_out._BACKEND
    try:
        audio_out._BACKEND = None
        monkeypatch.setenv("MIXLAB_AUDIO_BACKEND", "alsa")
        monkeypatch.setenv("MIXLAB_ALSA_LIB", str(fake_lib))
        monkeypatch.setenv("FAKE_ASOUND_LOG", str(tmp_path / "log"))
        backend = audio_out.get_backend()
        assert backend.name == "alsa"
        # explicit "file" selection always yields the WAV spool backend
        audio_out._BACKEND = None
        monkeypatch.setenv("MIXLAB_AUDIO_BACKEND", "file")
        assert audio_out.get_backend().name == "file"
        # explicit "alsa" with a broken lib raises (no silent fallback)
        audio_out._BACKEND = None
        monkeypatch.setenv("MIXLAB_AUDIO_BACKEND", "alsa")
        monkeypatch.setenv("MIXLAB_ALSA_LIB", "/nonexistent/lib.so")
        with pytest.raises(RuntimeError):
            audio_out.get_backend()
    finally:
        audio_out._BACKEND = saved


def test_short_write_continues_with_remainder(monkeypatch, tmp_path, fake_lib):
    """A short writei (device accepted only part of the period) continues
    with the remainder in the bounded loop — the full PCM still lands, in
    order, with no dropped or duplicated frames."""
    log = tmp_path / "log"
    backend = _make_backend(monkeypatch, fake_lib, log)
    monkeypatch.setenv("FAKE_ASOUND_SHORT_AT", "0")
    stream = backend.open("default", 48000)
    assert stream is not None
    t = np.arange(1024, dtype=np.float32)
    frames = np.stack([np.sin(t * 0.013), np.cos(t * 0.007)], axis=1) * 0.8
    assert stream.write(frames)
    expect = (np.clip(frames, -1, 1) * 32767).astype("<i2").tobytes()
    got = _played(log, len(expect))
    stream.close()
    assert got[: len(expect)] == expect
    assert "-> short" in log.read_text()


# -- the banded host resize ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_scale_plane_banded(tmp_path_factory):
    """The JAX package's ``scale_plane_banded``, compiled here from its
    source's extern "C" block alone (so this never builds or loads the JAX
    package's native library)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    src = (ROOT / "mixlab_tpu/native/mixlab_native.cpp").read_text()
    at = src.index("void scale_plane_banded(")
    start = src.rindex('extern "C" {', 0, at)
    end = src.index('}  // extern "C"', at) + len('}  // extern "C"')
    cpp = tmp_path_factory.mktemp("jax_scale") / "scale.cpp"
    cpp.write_text("#include <cstdint>\n" + src[start:end] + "\n")
    so = cpp.with_suffix(".so")
    subprocess.run(["g++", *native.CXX_FLAGS, "-o", str(so), str(cpp)], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.scale_plane_banded.restype = None
    lib.scale_plane_banded.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] * 2 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] * 2 + [ctypes.c_void_p]

    def run(plane, out_h, out_w, yidx, yw, xidx, xw):
        out = np.empty((out_h, out_w), np.uint8)
        tmp = np.empty(plane.shape[1], np.float32)
        lib.scale_plane_banded(plane.ctypes.data, *plane.shape, out.ctypes.data, out_h, out_w,
                               yidx.ctypes.data, yw.ctypes.data, yidx.shape[1],
                               xidx.ctypes.data, xw.ctypes.data, xidx.shape[1], tmp.ctypes.data)
        return out

    return run


SCALES = [((720, 1280), (700, 1120)), ((1080, 1920), (630, 1120)), ((360, 640), (350, 560)),
          ((64, 96), (700, 1120)), ((37, 53), (19, 101))]


@pytest.mark.parametrize("src,dst", SCALES, ids=lambda s: "x".join(map(str, s)))
def test_scale_plane_banded_matches_the_jax_cpp_and_numpy(src, dst, jax_scale_plane_banded,
                                                          monkeypatch):
    rng = np.random.default_rng(sum(src))
    yy, xx = np.mgrid[0:src[0], 0:src[1]]
    plane = ((xx * 3 + yy * 2) % 256 + rng.integers(0, 40, src)).clip(0, 255).astype(np.uint8)
    yidx, yw = scale_host.banded_weights(src[0], dst[0])
    xidx, xw = scale_host.banded_weights(src[1], dst[1])
    assert native.available()
    got = scale_host.resize_plane_host(plane, *dst)  # the native tier
    assert np.array_equal(got, native.scale_plane_banded(plane, *dst, yidx, yw, xidx, xw))
    assert np.array_equal(got, jax_scale_plane_banded(plane, *dst, yidx, yw, xidx, xw))
    monkeypatch.setattr(native, "_load", lambda: None)  # the numpy tier
    assert native.scale_plane_banded(plane, *dst, yidx, yw, xidx, xw) is None
    lsb = np.abs(scale_host.resize_plane_host(plane, *dst).astype(int) - got).max()
    assert lsb <= 1


def test_scale_picture_host_takes_tensors_and_letterboxes():
    """A 1280x720 picture of CPU tensors to the broadcast's 1120x700: the
    content box of each plane is its banded resize, the bars black with
    0x80 chroma."""
    import torch

    rng = np.random.default_rng(1)
    planes = {"y": rng.integers(0, 256, (720, 1280), dtype=np.uint8),
              "u": rng.integers(0, 256, (360, 640), dtype=np.uint8),
              "v": rng.integers(0, 256, (360, 640), dtype=np.uint8)}
    pic = Picture(PictureSettings(1280, 720), {k: torch.from_numpy(v) for k, v in planes.items()})
    out = scale_host.scale_picture_host(pic, PictureSettings(1120, 700))
    x, y, sw, sh = scale_host.letterbox_geometry(pic.settings, out.settings)
    assert (x, sw) == (0, 1120) and y > 0
    assert np.array_equal(out.planes["y"][y:y + sh], scale_host.resize_plane_host(planes["y"],
                                                                                   sh, sw))
    assert not out.planes["y"][:y].any() and (out.planes["u"][:y // 2] == 0x80).all()
