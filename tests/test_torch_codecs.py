"""The port's codec stack against the JAX package's, byte for byte.

Seeded numpy input goes through both packages: the pure AAC-LC encoder's
ADTS frames, the CAVLC intra H.264 access units on a ``MONITOR_PICTURE``
picture (the JAX package on its numpy tier; the port on its numpy tier and
on its native C++ encoder), the fMP4 init segment and fragments, the PNG
preview, ``f32_to_i16`` and ``transform_quant`` against
``transform_quant_jax``, all exact.

The JAX package's CAVLC encoder is pinned to its numpy tier by patching its
``make_cavlc_encoder``, so these tests never build the JAX package's native
library (ROADMAP.md section 3).
"""

import numpy as np
import pytest
import torch

from mixlab_tpu.av import aac as jaac
from mixlab_tpu.av import codecs as jcodecs
from mixlab_tpu.av import encode_stream as jencode_stream
from mixlab_tpu.av import h264cavlc as jh264cavlc
from mixlab_tpu.av import h264cavlc_fast as jfast
from mixlab_tpu.av import h264enc as jh264enc
from mixlab_tpu.av import mp4 as jmp4
from mixlab_tpu.utils import mtime as jmtime
from mixlab_tpu.video import frame as jframe
from mixlab_tpu_torch import native
from mixlab_tpu_torch.av import aac, codecs, encode_stream, h264cavlc, h264enc, mp4
from mixlab_tpu_torch.av import h264cavlc_fast as tfast
from mixlab_tpu_torch.utils import mtime
from mixlab_tpu_torch.video import frame

W, H = codecs.MONITOR_PICTURE.width, codecs.MONITOR_PICTURE.height


@pytest.fixture(autouse=True)
def _jax_numpy_cavlc(monkeypatch):
    monkeypatch.setattr(jfast, "make_cavlc_encoder", jfast.FastCavlcIntraEncoder)


def seeded_audio(seed: int, n: int) -> np.ndarray:
    """Interleaved stereo f32 in [-1.2, 1.2]: two tones and noise (clipped
    by ``f32_to_i16`` where it overshoots)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44_100.0
    tone = 0.6 * np.sin(2 * np.pi * 440.0 * t) + 0.4 * np.sin(2 * np.pi * 3_000.0 * t)
    left = tone + 0.2 * rng.standard_normal(n)
    right = 0.5 * tone + 0.3 * rng.standard_normal(n)
    return np.stack([left, right], axis=1).astype(np.float32)


def seeded_planes(seed: int, w: int = W, h: int = H) -> dict:
    """yuv420p planes with gradients, edges and noise (every CAVLC path)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 255 // max(w - 1, 1) + 40 * ((yy // 24) % 2)
         + rng.integers(0, 24, (h, w))).clip(0, 255).astype(np.uint8)
    u = rng.integers(64, 192, (h // 2, w // 2)).astype(np.uint8)
    v = (yy[::2, ::2] * 255 // max(h - 1, 1)).astype(np.uint8)
    return {"y": y, "u": u, "v": v}


def test_f32_to_i16_is_identical():
    x = seeded_audio(1, 4_096).reshape(-1)
    x[:6] = [1.0, -1.0, 1.5, -1.5, 0.99999, -0.99999]
    got = encode_stream.f32_to_i16(x)
    want = jencode_stream.f32_to_i16(x)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sample_rate", [44_100, 48_000])
def test_pure_aac_adts_frames_are_identical(sample_rate):
    """0.3 s fed in ticks of 735 frames; every ADTS frame byte-identical."""
    pcm = seeded_audio(sample_rate, sample_rate * 3 // 10)
    t, j = codecs.PureAacStream(sample_rate, 2), jcodecs.PureAacStream(sample_rate, 2)
    frames_t, frames_j = [], []
    for i in range(0, len(pcm), 735):
        chunk = pcm[i:i + 735].reshape(-1)
        t.feed(encode_stream.f32_to_i16(chunk))
        j.feed(jencode_stream.f32_to_i16(chunk))
        frames_t += t.poll_frames()
        frames_j += j.poll_frames()
    assert len(frames_t) == len(pcm) // 1024 > 10
    assert frames_t == frames_j
    assert t.configuration_data() == j.configuration_data()
    assert aac.parse_adts_header(frames_t[0]) == jaac.parse_adts_header(frames_j[0])


@pytest.mark.parametrize("tier", ["numpy", "native"])
def test_pure_h264_access_units_are_identical(tier, monkeypatch):
    """Three MONITOR_PICTURE frames: the port's tier against the JAX
    package's numpy tier, access units and DCR byte for byte."""
    if tier == "numpy":
        monkeypatch.setattr(tfast, "make_cavlc_encoder", tfast.FastCavlcIntraEncoder)
    t = h264enc.PureH264Stream(codecs.MONITOR_PICTURE, fps=10, profile="monitor")
    j = jh264enc.PureH264Stream(jcodecs.MONITOR_PICTURE, fps=10, profile="monitor")
    want_cls = tfast.NativeCavlcIntraEncoder if tier == "native" else tfast.FastCavlcIntraEncoder
    assert type(t._cavlc) is want_cls and type(j._cavlc) is jfast.FastCavlcIntraEncoder
    assert t.dcr == j.dcr
    for seed in range(3):
        planes = seeded_planes(seed)
        t.feed(frame.Picture(codecs.MONITOR_PICTURE, {k: torch.from_numpy(v)
                                                      for k, v in planes.items()}))
        j.feed(jframe.Picture(jcodecs.MONITOR_PICTURE, planes))
    units_t, units_j = t.poll_access_units(), j.poll_access_units()
    assert len(units_t) == 3 and units_t == units_j


def test_native_cavlc_recon_matches_the_scalar_encoder():
    """The native encoder's reconstruction is the scalar oracle's (the
    JAX package's ``CavlcIntraEncoder``), on a picture with ragged MB
    padding."""
    planes = seeded_planes(7, 72, 40)
    settings = frame.PictureSettings(72, 40)
    enc = tfast.NativeCavlcIntraEncoder(qp=24)
    rbsp = enc.encode_frame(frame.Picture(settings, planes))
    oracle = jh264cavlc.CavlcIntraEncoder(qp=24)
    assert rbsp == oracle.encode_frame(jframe.Picture(jframe.PictureSettings(72, 40), planes))
    for got, want in zip(enc.last_recon, oracle.last_recon):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qp", [10, 28, 48])
def test_transform_quant_is_exact(qp):
    rng = np.random.default_rng(qp)
    blocks = rng.integers(-255, 256, (6, 16, 4, 4))
    got = h264cavlc.transform_quant(torch.from_numpy(blocks), qp)
    want = np.asarray(jh264cavlc.transform_quant_jax(blocks, qp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the numpy forward + quant of the scalar encoder
    np.testing.assert_array_equal(
        got.numpy(), h264cavlc.quant4x4(h264cavlc.forward4x4(blocks), qp))


def test_mp4_init_and_fragments_are_identical():
    """The init segment, then AAC and AVC fragments interleaved as the
    monitor writes them, byte for byte."""
    t_h264 = h264enc.PureH264Stream(codecs.MONITOR_PICTURE)
    j_h264 = jh264enc.PureH264Stream(jcodecs.MONITOR_PICTURE)
    params = dict(timescale=44_100, width=W, height=H, sample_rate=44_100, channels=2)
    t_mux, t_init = mp4.Mp4Mux.create(mp4.Mp4Params(dcr=t_h264.dcr, **params))
    j_mux, j_init = jmp4.Mp4Mux.create(jmp4.Mp4Params(dcr=j_h264.dcr, **params))
    assert t_init == j_init and t_init[4:8] == b"ftyp"

    t_aac = codecs.PureAacStream(44_100, 2)
    t_aac.feed(encode_stream.f32_to_i16(seeded_audio(3, 4_410).reshape(-1)))
    adts = t_aac.poll_frames()
    planes = seeded_planes(11)
    t_h264.feed(frame.Picture(codecs.MONITOR_PICTURE, planes))
    (is_key, avcc), = t_h264.poll_access_units()
    segs_t, segs_j = [], []
    for k, raw in enumerate(adts):
        segs_t.append(t_mux.write_track(mtime.MediaDuration.new(1024, 44_100),
                                        mp4.AdtsFrame(raw)))
        segs_j.append(j_mux.write_track(jmtime.MediaDuration.new(1024, 44_100),
                                        jmp4.AdtsFrame(raw)))
        if k % 2:
            segs_t.append(t_mux.write_track(
                mtime.MediaDuration.new(6, 60),
                mp4.AvcFrame(is_key, mtime.MediaDuration.zero(), avcc)))
            segs_j.append(j_mux.write_track(
                jmtime.MediaDuration.new(6, 60),
                jmp4.AvcFrame(is_key, jmtime.MediaDuration.zero(), avcc)))
    assert len(segs_t) > 4 and segs_t == segs_j
    assert all(s[4:8] == b"moof" for s in segs_t)


def test_png_preview_is_identical():
    planes = seeded_planes(5, 64, 48)
    pic_t = frame.Picture(frame.PictureSettings(64, 48),
                          {k: torch.from_numpy(v) for k, v in planes.items()})
    import jax.numpy as jnp

    pic_j = jframe.Picture(jframe.PictureSettings(64, 48),
                           {k: jnp.asarray(v) for k, v in planes.items()})
    got = codecs.PngVideoEncoder(pic_t.settings).encode(pic_t, pts=7)
    want = jcodecs.PngVideoEncoder(pic_j.settings).encode(pic_j, pts=7)
    assert got[0].data[:8] == b"\x89PNG\r\n\x1a\n"
    assert got == [codecs.VideoPacket(w.dts, w.pts, w.is_key, w.data) for w in want]
    pcm = encode_stream.f32_to_i16(seeded_audio(2, 735).reshape(-1))
    assert codecs.PcmAudioEncoder().encode(pcm) == jcodecs.PcmAudioEncoder().encode(pcm)


def test_codec_tier_without_the_shim(monkeypatch):
    """Without the libavcodec shim the port chooses ffmpeg, then pure, as the
    JAX package does; a forced ``shim`` raises, saying why it is absent."""
    from mixlab_tpu_torch.native import avshim

    monkeypatch.setattr(avshim, "available", lambda: False)
    monkeypatch.setattr(avshim, "unavailable_reason",
                        lambda: "g++ failed on avshim.cpp (the ffmpeg libraries ...)")
    monkeypatch.setattr(codecs.shutil, "which", lambda name: None)
    monkeypatch.delenv("MIXLAB_CODEC_TIER", raising=False)
    assert codecs.codec_tier() == "pure" and codecs.fmp4_capable()
    monkeypatch.setattr(codecs.shutil, "which", lambda name: "/usr/bin/" + name)
    assert codecs.codec_tier() == "ffmpeg"
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    assert codecs.codec_tier() == "pure"
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "shim")
    with pytest.raises(RuntimeError, match="shim is unavailable: g.. failed on avshim.cpp"):
        codecs.codec_tier()
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "x264")
    with pytest.raises(ValueError):
        codecs.codec_tier()


def test_codec_tier_with_the_shim(monkeypatch):
    """Where the libraries are, the shim comes first in both packages, and
    ``MIXLAB_CODEC_TIER`` pins a tier."""
    from mixlab_tpu.av import codecs as jcodecs
    from mixlab_tpu_torch.native import avshim

    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    from mixlab_tpu.native import avshim as jax_avshim

    if not jax_avshim.available():
        pytest.skip("the JAX package's libavcodec shim is unavailable")
    monkeypatch.delenv("MIXLAB_CODEC_TIER", raising=False)
    monkeypatch.setattr(codecs.shutil, "which", lambda name: None)
    assert codecs.codec_tier() == "shim" == jcodecs.codec_tier()
    for tier in ("shim", "pure"):
        monkeypatch.setenv("MIXLAB_CODEC_TIER", tier)
        assert codecs.codec_tier() == tier


def test_ws_unmask_matches_the_numpy_xor(monkeypatch):
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 1_037, dtype=np.uint8).tobytes()
    mask = b"\x12\x34\xab\xcd"
    want = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    assert native.available()
    assert native.ws_unmask(payload, mask) == want
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.ws_unmask(payload, mask) == want
