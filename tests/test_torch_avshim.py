"""The port's libavcodec shim (``mixlab_tpu_torch/native/avshim.py`` over its
copy of ``avshim.cpp``) against the JAX package's shim on the same bytes:
AAC and MP3 decode, H.264 decode, ``MediaReader`` over callback IO, and the
encoders (libavcodec's AAC, x264 at the monitor and stream operating points)
with the codec streams built on them.  Exact: both are the same C++ over the
same system libraries.  Every case skips, naming libavcodec, where the
libraries are absent; the build's failure path runs everywhere."""

import io

import numpy as np
import pytest

from mixlab_tpu.av import codecs as jcodecs
from mixlab_tpu.native import avshim as jshim
from mixlab_tpu.video import frame as jframe
from mixlab_tpu_torch.av import codecs
from mixlab_tpu_torch.native import avshim
from mixlab_tpu_torch.video.frame import Picture, PictureSettings


@pytest.fixture(scope="module")
def require_shim():
    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    if not jshim.available():
        pytest.skip("the JAX package's libavcodec shim (libavcodec) is unavailable")


def _pcm(seconds=0.5, rate=44_100, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 550 * t)], 1) * 0.4
    return (np.clip(x + rng.normal(0, 0.01, x.shape), -1, 1) * 32767).astype(np.int16)


def _planes(w, h, k):
    """A moving gradient picture's yuv420p planes."""
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    y = ((xx * 3 + yy * 2 + 7 * k) % 256).astype(np.uint8)
    u = np.full((h // 2, w // 2), 100 + k, np.uint8)
    v = np.full((h // 2, w // 2), 160 - k, np.uint8)
    return y, u, v


def _encode_audio(mod, codec, bitrate):
    enc = mod.AacEncoder(44_100, 2, bitrate, codec=codec)
    enc.send(_pcm())
    enc.flush()
    out = [frame for _pts, frame in enc.receive()]
    extradata = enc.extradata()
    enc.close()
    return out, extradata


def _encode_video(mod, w, h, profile, n=8):
    enc = mod.VideoEncoder(w, h, 30, profile)
    units = []
    for k in range(n):
        enc.send(*_planes(w, h, k), pts=k)
        units += enc.receive()
    enc.flush()
    units += enc.receive()
    extradata = enc.extradata()
    enc.close()
    return units, extradata


@pytest.mark.usefixtures("require_shim")
@pytest.mark.parametrize("codec,bitrate", [("aac", 128_000), ("libmp3lame", 128_000)])
def test_audio_encoder_and_decoder_match_jax(codec, bitrate):
    """The same PCM through both packages' encoders gives the same packets;
    the packets through both decoders (s16 and f32 output) the same PCM."""
    if not avshim.have_encoder(codec):
        pytest.skip(f"libavcodec has no {codec} encoder")
    got, extra = _encode_audio(avshim, codec, bitrate)
    want, extra_j = _encode_audio(jshim, codec, bitrate)
    assert got == want and extra == extra_j and len(got) >= 20
    dec_name = "aac" if codec == "aac" else "mp3"
    outs = []
    for mod in (avshim, jshim):
        ed = extra if dec_name == "aac" else b""
        dec, flt = mod.AudioDecoder(dec_name, ed), mod.AudioDecoder(dec_name, ed)
        pcm = [(pts, p, rate) for f in got for pts, p, rate in dec.decode(f)]
        pcm_f = [(pts, p, rate) for f in got for pts, p, rate in flt.decode_flt(f)]
        dec.close()
        flt.close()
        outs.append((pcm, pcm_f))
    (pcm, pcm_f), (jpcm, jpcm_f) = outs
    assert len(pcm) == len(jpcm) > 0 and len(pcm_f) == len(jpcm_f)
    for (pa, a, ra), (pb, b, rb) in zip(pcm + pcm_f, jpcm + jpcm_f):
        assert pa == pb and ra == rb == 44_100 and np.array_equal(a, b)
    heard = np.concatenate([p for _, p, _ in pcm])
    assert heard.dtype == np.int16 and np.abs(heard).max() > 5000


@pytest.mark.usefixtures("require_shim")
@pytest.mark.parametrize("profile,size", [("monitor", (560, 350)), ("stream", (1120, 700))])
def test_video_encoder_and_decoder_match_jax(profile, size):
    """x264 at the monitor (CRF 30, every frame a key frame) and the stream
    (CBR 1.5 Mbps, GOP 60) operating points: the same parameter sets, pts
    and key frames in both packages, and at the monitor point (one x264
    thread) the same access units; the stream point runs x264 on two
    threads, whose rate control may differ from run to run in either
    package.  The port's units decoded by both packages' H.264 decoders
    give the same pictures, close to the source."""
    w, h = size
    got, extra = _encode_video(avshim, w, h, profile)
    want, extra_j = _encode_video(jshim, w, h, profile)
    assert extra == extra_j and [u[:3] for u in got] == [u[:3] for u in want]
    assert len(got) == 8
    if profile == "monitor":
        assert [u[3] for u in got] == [u[3] for u in want]
    assert got[0][2] and (profile != "monitor" or all(u[2] for u in got))
    decoded = []
    for mod in (avshim, jshim):
        dec = mod.VideoDecoder("h264", extra)
        frames = [f for _, _, _, annexb in got for f in dec.decode(annexb)] + dec.flush()
        dec.close()
        decoded.append(frames)
    assert len(decoded[0]) == len(decoded[1]) == 8
    for (pa, *a), (pb, *b) in zip(*decoded):
        assert pa == pb and all(np.array_equal(x, y) for x, y in zip(a, b))
    y0 = decoded[0][0][1]
    assert y0.shape == (h, w)
    assert np.abs(y0.astype(int) - _planes(w, h, 0)[0].astype(int)).mean() < 12


@pytest.mark.usefixtures("require_shim")
def test_codec_streams_match_jax():
    """``ShimAacStream`` and ``ShimH264Stream`` of both packages on the same
    PCM and pictures: the same ADTS frames, DCR and avcc access units."""
    pcm = _pcm(0.3)
    a, ja = codecs.ShimAacStream(44_100, 2, 160_000), jcodecs.ShimAacStream(44_100, 2, 160_000)
    a.feed(pcm)
    ja.feed(pcm)
    assert a.poll_frames() == ja.poll_frames() and a.configuration_data() == ja.configuration_data()
    a.close()
    ja.close()
    pic = codecs.MONITOR_PICTURE
    v = codecs.ShimH264Stream(pic, fps=10, profile="monitor")
    jv = jcodecs.ShimH264Stream(jcodecs.MONITOR_PICTURE, fps=10, profile="monitor")
    assert v.dcr == jv.dcr
    for k in range(4):
        planes = dict(zip("yuv", _planes(pic.width, pic.height, k)))
        v.feed(Picture(pic, planes))
        jv.feed(jframe.Picture(jcodecs.MONITOR_PICTURE, planes))
    units = v.poll_access_units()
    assert units == jv.poll_access_units() and len(units) == 4
    v.close()
    jv.close()


@pytest.mark.usefixtures("require_shim")
def test_media_reader_from_reader_matches_jax(tmp_path):
    """An MP4 (H.264 and AAC-LC) and a WAV demuxed and decoded through
    callback IO by both packages: the same stream info and items."""
    from tests.test_torch_media import mp4_bytes, wav_bytes

    for blob in (mp4_bytes("aac"), mp4_bytes("flac"), wav_bytes(tmp_path)):
        items = []
        for mod in (avshim, jshim):
            r = mod.MediaReader.from_reader(io.BytesIO(blob))
            info = (r.audio, r.video)
            seq = []
            while (item := r.read()) is not None:
                seq.append(item)
            r.close()
            items.append((info, seq))
        (info, seq), (jinfo, jseq) = items
        assert info == jinfo and len(seq) == len(jseq) > 0
        for (k, pts, payload), (jk, jpts, jpayload) in zip(seq, jseq):
            assert (k, pts) == (jk, jpts)
            if k == "audio":
                assert np.array_equal(payload, jpayload)
            else:
                assert all(np.array_equal(x, y) for x, y in zip(payload, jpayload))


def test_unavailable_shim_says_why(monkeypatch, tmp_path):
    """A build that cannot link the libraries leaves the shim unavailable,
    the reason naming them, and the codec tier falls to the pure one."""
    monkeypatch.setattr(avshim, "_lib", None)
    monkeypatch.setattr(avshim, "_tried", False)
    monkeypatch.setattr(avshim, "_reason", None)
    monkeypatch.setattr(avshim, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(avshim, "LIBS", avshim.LIBS + ("-lmixlab_no_such_library",))
    monkeypatch.setattr(codecs.shutil, "which", lambda name: None)
    monkeypatch.delenv("MIXLAB_CODEC_TIER", raising=False)
    assert not avshim.available()
    assert "libavcodec" in avshim.unavailable_reason()
    assert "mixlab_no_such_library" in avshim.unavailable_reason()
    assert codecs.codec_tier() == "pure" and not codecs.avshim_codecs_available()
    with pytest.raises(avshim.ShimError, match="unavailable"):
        avshim.AudioDecoder("aac")
    assert not list(tmp_path.glob("*.so"))
