"""The port's copies of the media readers and audio decoders against the
JAX package's, on the CPU: the same bytes give the same samples, planes and
sample tables, exactly.  Inputs are made from a seed by the port's own
encoders (FLAC, AAC-LC, the fMP4 mux, WAV, Y4M) and by Pillow (JPEG); the
Ogg/Vorbis file is the one ``tests/test_stream_output_media.py`` plays.

Also the Vorbis IMDCT's matrix form, ``imdct_batch_torch`` (the JAX
package's ``imdct_batch_jax``), at ``tests/test_vorbis.py``'s tolerance.
"""

import io

import numpy as np
import pytest
import torch

from mixlab_tpu.av import aacdec as jaacdec
from mixlab_tpu.av import flacdec as jflacdec
from mixlab_tpu.av import jpeg as jjpeg
from mixlab_tpu.av import mp4read as jmp4read
from mixlab_tpu.av import vorbis as jvorbis
from mixlab_tpu.av import y4m as jy4m
from mixlab_tpu.av.aac import AudioSpecificConfiguration as JaxAsc
from mixlab_tpu.io_host import wav as jwav
from mixlab_tpu_torch.av import aacdec, flacdec, jpeg, mp4read, vorbis, y4m
from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration, adts_frame
from mixlab_tpu_torch.av.aacenc import AacLcEncoder
from mixlab_tpu_torch.av.flacenc import FlacEncoder
from mixlab_tpu_torch.io_host import wav
from tests.test_torch_media import OGG, jpeg_bytes, mp4_bytes, tone, y4m_bytes


@pytest.mark.parametrize("block", [1024, 4096])
def test_flac_frames_decode_as_in_the_jax_package(block):
    enc = FlacEncoder(44_100, 2, block)
    pcm = (tone(44_100, 0.3, seed=block) * 32767).astype(np.int16)
    data = enc.stream_header() + b"".join(
        enc.encode_frame(pcm[i:i + block]) for i in range(0, len(pcm), block))
    got, rate, bps = flacdec.decode_flac_file(data)
    want, jrate, jbps = jflacdec.decode_flac_file(data)
    assert (rate, bps) == (jrate, jbps) == (44_100, 16)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got[:len(pcm)], pcm)


@pytest.mark.parametrize("rate", [44_100, 48_000])
def test_aac_granules_decode_as_in_the_jax_package(rate):
    enc = AacLcEncoder(rate, 2)
    pcm = (tone(rate, 0.25, seed=rate) * 32767).astype(np.int16)
    raws = [enc.encode_granule(pcm[i:i + 1024]) for i in range(0, len(pcm) - 1023, 1024)]
    asc = AudioSpecificConfiguration.lc_stereo(rate)
    tdec = aacdec.AacLcDecoder(asc)
    jdec = jaacdec.AacLcDecoder(JaxAsc.lc_stereo(rate))
    for raw in raws:
        got = tdec.decode_raw(raw, asc.sampling_frequency_index)
        want = jdec.decode_raw(raw, asc.sampling_frequency_index)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert adts_frame(raws[0], asc)[:2] == b"\xff\xf1"


def test_ogg_vorbis_decodes_as_in_the_jax_package():
    if not OGG.exists():
        pytest.skip(f"{OGG} is absent")
    data = OGG.read_bytes()
    got, want = vorbis.OggVorbisStream(), jvorbis.OggVorbisStream()
    n = 0
    for i in range(0, len(data), 4096):
        a, b = got.feed(data[i:i + 4096]), want.feed(data[i:i + 4096])
        assert a.dtype == b.dtype and np.array_equal(a, b)
        n += len(a)
    assert n > 10_000 and got.info.sample_rate == want.info.sample_rate


def test_wav_header_and_frames_parse_as_in_the_jax_package(tmp_path):
    path = tmp_path / "t.wav"
    wav.write_wav(path, 48_000, tone(48_000, 0.05))
    data = path.read_bytes()
    fmt, off, size = wav.parse_header(data)
    jfmt, joff, jsize = jwav.parse_header(data)
    assert (fmt.channels, fmt.sample_rate, fmt.bits_per_sample, fmt.audio_format, off, size) == (
        jfmt.channels, jfmt.sample_rate, jfmt.bits_per_sample, jfmt.audio_format, joff, jsize)
    body = data[off:off + size]
    assert np.array_equal(wav.decode_frames(fmt, body), jwav.decode_frames(jfmt, body))
    with pytest.raises(wav.WavError):
        wav.parse_header(b"RIFX" + data[4:])


def test_y4m_frames_read_as_in_the_jax_package():
    data = y4m_bytes(w=80, h=64, n=3)
    got, want = y4m.Y4mReader(io.BytesIO(data)), jy4m.Y4mReader(io.BytesIO(data))
    assert got.info.fps == want.info.fps
    for _ in range(3):
        for a, b in zip(got.read_frame(), want.read_frame()):
            assert np.array_equal(a, b)
    assert got.read_frame() is None and want.read_frame() is None


def test_jpeg_decodes_as_in_the_jax_package():
    data = jpeg_bytes(w=72, h=56)
    for a, b in zip(jpeg.decode_jpeg(data), jjpeg.decode_jpeg(data)):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("audio_codec", ["flac", "aac"])
def test_mp4_demuxes_as_in_the_jax_package(audio_codec):
    data = mp4_bytes(audio_codec)
    got, want = mp4read.Mp4Reader(data), jmp4read.Mp4Reader(data)
    for track in ("video_track", "audio_track"):
        a, b = getattr(got, track)(), getattr(want, track)()
        assert (a.codec, a.timescale, a.edit_media_time) == (b.codec, b.timescale,
                                                           b.edit_media_time)
        assert [(s.dts, s.cts, s.key) for s in a.samples] == [
            (s.dts, s.cts, s.key) for s in b.samples]
        assert [got.sample_data(s) for s in a.samples] == [
            want.sample_data(s) for s in b.samples]
    assert got.audio_track().codec == audio_codec


# -- the Vorbis IMDCT as one matrix product ----------------------------------


def test_imdct_batch_torch_matches_the_jax_product_and_numpy():
    """``tests/test_vorbis.py:63-68``'s case and tolerance (2e-3), on the
    CPU: against the JAX package's ``imdct_batch_jax`` and the numpy
    ``imdct_batch``."""
    xs = np.random.default_rng(3).normal(size=(4, 128)).astype(np.float32)
    got = vorbis.imdct_batch_torch(xs, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4, 256) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jvorbis.imdct_batch_jax(xs)), atol=2e-3)
    np.testing.assert_allclose(got.numpy(), vorbis.imdct_batch(xs), atol=2e-3)
    basis = vorbis.imdct_matrix(256)
    assert torch.equal(vorbis.imdct_batch_torch(torch.from_numpy(xs), basis, "cpu"), got)


def test_imdct_batch_torch_refuses_reduced_precision():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="imdct_batch_torch"):
            vorbis.imdct_batch_torch(np.zeros((2, 64), np.float32), device="cpu")
    finally:
        torch.set_float32_matmul_precision(old)
