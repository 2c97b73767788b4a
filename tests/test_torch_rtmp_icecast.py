"""The port's RTMP and Icecast ingest (``mixlab_tpu_torch/io_host/``) against
the JAX package's, over loopback sockets on the CPU.

``tests/test_rtmp_icecast.py``'s twelve cases, run through the port and,
wherever both can run, held against the JAX package:

  * AMF0 values and RTMP chunk streams are the same bytes in both packages,
    and a port writer feeds a JAX reader and back;
  * a publisher of either package reaches the port's server; the unknown
    mountpoint is refused;
  * the Icecast WAV ingest gives the JAX package's PCM; the Ogg/Vorbis
    ingest is awaited by the count of its frames, not by wall time;
  * the x264 streams committed under ``tests/data/h264/`` (CAVLC and CABAC,
    P and B, the High profile's 8x8 transform), published in FLV tags over
    RTMP, reach the mountpoint as exactly the pictures of the port's and the
    JAX package's pure decoders fed the same tags; this replaces the JAX
    cases' x264 run through the libavcodec shim;
  * AAC-LC over RTMP gives the JAX package's PCM, decoded in the port's
    codec process;
  * MP3: the frame splitter runs on frames built here; MP3 sources, which
    need the JAX package's shim, are refused by the port naming the ROADMAP
    item, and skip without ``libmp3lame`` as the JAX cases do.

The port's server runs with ``device="cpu"``; the JAX server decodes on its
Python tier (``mixlab_tpu.native._load`` patched to None, as
``tests/test_torch_h264dec.py`` does).
"""

import asyncio

import numpy as np
import pytest
import torch

import mixlab_tpu.native as jax_native
from mixlab_tpu.av import mp3 as jmp3
from mixlab_tpu.io_host import icecast as jicecast
from mixlab_tpu.io_host import source as jsource
from mixlab_tpu.io_host.rtmp import amf0 as jamf0
from mixlab_tpu.io_host.rtmp import chunk as jchunk
from mixlab_tpu.io_host.rtmp import client as jclient
from mixlab_tpu.io_host.rtmp import server as jserver
from mixlab_tpu.io_host.throttle import AudioThrottle as JaxAudioThrottle
from mixlab_tpu_torch.av import flv, mp3
from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
from mixlab_tpu_torch.av.aacdec import AacLcDecoder
from mixlab_tpu_torch.av.aacenc import AacLcEncoder
from mixlab_tpu_torch.av.avc import (
    DecoderConfigurationRecord,
    NalUnit,
    UnitType,
    split_annexb,
    write_nal_units,
)
from mixlab_tpu_torch.av.h264dec import PureH264Decoder
from mixlab_tpu_torch.io_host import icecast, listen
from mixlab_tpu_torch.io_host import source as source_mod
from mixlab_tpu_torch.io_host.rtmp import amf0, chunk
from mixlab_tpu_torch.io_host.rtmp import client as rtmp_client
from mixlab_tpu_torch.io_host.rtmp import server as rtmp_server
from mixlab_tpu_torch.io_host.throttle import AudioThrottle
from mixlab_tpu_torch.io_host.wav import write_wav
from mixlab_tpu_torch.utils.mtime import MediaTime
from tests import torch_h264_streams as streams
from tests.test_torch_media import OGG  # pygame's house_lo.ogg, or a path that does not exist



@pytest.fixture(autouse=True)
def _jax_python_tier(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)


@pytest.fixture(scope="module", autouse=True)
def _port_native_built():
    """The port's host C++ (the decoders' native tier) built before any
    timed wait: in a fresh checkout the first load builds it."""
    from mixlab_tpu_torch import native

    assert native.available()


# -- loopback plumbing --------------------------------------------------------


async def _rtmp_server(package):
    """An RTMP server of ``package`` ("torch" or "jax") on an ephemeral port."""
    async def on_conn(reader, writer):
        try:
            if package == "torch":
                await rtmp_server.accept(reader, writer, "cpu")
            else:
                await jserver.accept(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


async def _icecast_server(module):
    async def on_conn(reader, writer):
        peek = await reader.readexactly(7)
        assert listen.classify(peek) == listen.Protocol.ICECAST
        await module.accept(listen.PeekStreamReader(peek, reader), writer)
        writer.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


def _drain(recv, kind="audio"):
    read = recv.read_audio if kind == "audio" else recv.read_video
    out = []
    while (f := read()) is not None:
        out.append(f)
    return out


def _publish(package, mount, tags, settle=0.3, client_mod=rtmp_client):
    """Publish ``tags`` ((kind, ms, body), ...) with ``client_mod`` to a
    server of ``package``; -> once the publisher has closed and the server
    has taken every tag."""
    async def go():
        server, port = await _rtmp_server(package)
        client = await client_mod.start("127.0.0.1", port, mount, "key")
        for kind, ms, body in tags:
            (client.publish_audio if kind == "audio" else client.publish_video)(ms, body)
            await asyncio.sleep(0)
        await asyncio.sleep(settle)
        await client.close()
        await asyncio.sleep(settle)
        server.close()
        await server.wait_closed()

    asyncio.run(go())


def _planes(frame):
    pic = frame.data.picture
    return [np.asarray(pic.planes[k].numpy() if isinstance(pic.planes[k], torch.Tensor)
                       else pic.planes[k]) for k in "yuv"]


# -- AMF0 and the chunk stream ------------------------------------------------

AMF0_VALUES = [
    ["connect", 1.0, {"app": "live", "flashVer": "x", "nested": {"a": 1.0, "b": True}},
     None, ["x", 2.0]],
    ["_result", 2.0, None, 1.0],
    ["onStatus", 0.0, None, {"level": "error", "code": "NetStream.Publish.BadName",
                             "description": "é" * 70_000}],
]


@pytest.mark.parametrize("values", AMF0_VALUES, ids=["connect", "result", "long-string"])
def test_amf0_roundtrip(values):
    data = amf0.encode_all(*values)
    assert data == jamf0.encode_all(*values)
    assert amf0.decode_all(data) == jamf0.decode_all(data) == values


class Pipe:
    def __init__(self):
        self.buf = bytearray()

    def write(self, data):
        self.buf += data

    async def readexactly(self, n):
        out = bytes(self.buf[:n])
        if len(out) < n:
            raise asyncio.IncompleteReadError(out, n)
        del self.buf[:n]
        return out


def _write_chunks(mod):
    """Messages larger than the chunk size, a Set Chunk Size, an extended
    timestamp, on two chunk streams -> the bytes ``mod``'s writer makes."""
    pipe = Pipe()
    cw = mod.ChunkWriter(pipe)
    payload = bytes(range(256)) * 40  # 10240 bytes >> 128 chunk size
    cw.write_message(mod.Message(1234, 8, 1, payload), csid=4)
    cw.set_chunk_size(4096)
    cw.write_message(mod.Message(0xFFFFFF + 5, 9, 1, payload), csid=6)
    cw.write_message(mod.Message(7, 20, 0, b"x"))
    return bytes(pipe.buf)


@pytest.mark.parametrize("writer,reader", [(chunk, jchunk), (jchunk, chunk), (chunk, chunk)],
                         ids=["port-to-jax", "jax-to-port", "port-to-port"])
def test_chunk_roundtrip_large_payload(writer, reader):
    """Both packages' writers make the same bytes, and each package's reader
    reassembles the other's messages exactly, a Set Chunk Size included."""
    data = _write_chunks(writer)
    assert data == _write_chunks(chunk) == _write_chunks(jchunk)
    pipe = Pipe()
    pipe.buf += data
    cr = reader.ChunkReader(pipe)

    async def go():
        return [await cr.read_message() for _ in range(3)]

    m1, m2, m3 = asyncio.run(go())
    payload = bytes(range(256)) * 40
    assert (m1.timestamp, m1.type_id, m1.payload) == (1234, 8, payload)
    assert m2.timestamp == 0xFFFFFF + 5 and m2.payload == payload
    assert (m3.type_id, m3.payload) == (20, b"x") and cr.chunk_size == 4096


# -- RTMP publish -----------------------------------------------------------


class FakeDecoder(rtmp_server.MediaDecoder):
    """Interprets 'raw AAC' payloads as little-endian i16 PCM directly."""

    def __init__(self, device):
        self.asc = None

    def set_audio_config(self, asc):
        self.asc = asc

    def decode_audio(self, raw):
        x = np.frombuffer(raw, dtype="<i2")
        return np.stack([x, x], axis=-1)


@pytest.mark.parametrize("client_mod", [rtmp_client, jclient], ids=["port-client", "jax-client"])
def test_rtmp_publish_loopback(client_mod, monkeypatch):
    """A publisher of either package reaches the port's server; PCM lands in
    the mountpoint ring with 1 kHz-timebase timestamps."""
    recv = source_mod.RTMP_MOUNTPOINTS.listen("looptest")
    monkeypatch.setattr(rtmp_server, "DECODER_FACTORY", FakeDecoder)
    asc = AudioSpecificConfiguration.lc_stereo(44100)
    pcm = np.arange(64, dtype="<i2").tobytes()
    try:
        _publish("torch", "looptest", [
            ("audio", 0, flv.AudioPacket(True, asc.to_bytes()).to_bytes()),
            ("audio", 10, flv.AudioPacket(False, pcm).to_bytes()),
            ("audio", 20, flv.AudioPacket(False, pcm).to_bytes()),
            ("audio", 30, flv.pcm_s16le_tag(pcm)),
        ], client_mod=client_mod)
        f1, f2, f3 = _drain(recv)
        assert f1.source_time == MediaTime.new(10, 1000)
        np.testing.assert_array_equal(f1.data[:, 0], np.arange(64, dtype=np.int16))
        assert f2.source_time == MediaTime.new(20, 1000)
        assert f3.source_time == MediaTime.new(30, 1000)
        np.testing.assert_array_equal(f3.data.reshape(-1), np.arange(64, dtype=np.int16))
    finally:
        recv.close()


def test_rtmp_publish_unknown_mountpoint_rejected():
    async def go():
        server, port = await _rtmp_server("torch")
        with pytest.raises(Exception):
            # publish fails -> NetStream.Publish.BadName -> connection closes
            client = await rtmp_client.start("127.0.0.1", port, "nosuch", "key")
            client.publish_audio(0, b"\xaf\x01\x00")
            await asyncio.sleep(0.2)
            raise RuntimeError("expected BadName")  # if start succeeded anyway
        server.close()
        await server.wait_closed()

    asyncio.run(go())


def _x264_tags(annexb: bytes):
    """An Annex B stream as FLV video tags, 100 ms apart: the DCR of its
    SPS and PPS, then one NALU tag a picture (a slice with the SEI before
    it); -> (tags, the DCR bytes, the access units)."""
    sps, pps, units, pending = [], [], [], []
    for raw in split_annexb(annexb):
        u = NalUnit.parse(raw)
        if u.kind == UnitType.SEQUENCE_PARAMETER_SET:
            sps.append(u)
        elif u.kind == UnitType.PICTURE_PARAMETER_SET:
            pps.append(u)
        elif u.kind in (UnitType.NON_IDR_PICTURE, UnitType.IDR_PICTURE):
            units.append((u.kind == UnitType.IDR_PICTURE, write_nal_units(pending + [u])))
            pending = []
        else:
            pending.append(u)
    s0 = sps[0].to_bytes()
    dcr = DecoderConfigurationRecord(1, s0[1], s0[2], s0[3], 4, sps, pps).to_bytes()
    tags = [("video", 0, flv.VideoPacket(flv.VideoFrameType.KEY_FRAME,
                                         flv.VideoPacketType.SEQUENCE_HEADER, 0, dcr).to_bytes())]
    for i, (key, avcc) in enumerate(units):
        kind = flv.VideoFrameType.KEY_FRAME if key else flv.VideoFrameType.INTER_FRAME
        tags.append(("video", 100 * (i + 1),
                     flv.VideoPacket(kind, flv.VideoPacketType.NALU, 0, avcc).to_bytes()))
    return tags, dcr, [avcc for _, avcc in units]


@pytest.mark.parametrize("name", sorted(streams.STREAMS))
def test_rtmp_pure_tier_x264_ingest(name, monkeypatch):
    """A committed x264 stream over RTMP into both packages' pure tiers: the
    port's mountpoint gets, tag by tag, the last picture the port's decoder
    returns for that tag, with the tag's time and a 100 ms duration hint,
    as CPU tensors; the JAX server's mountpoint the same planes."""
    monkeypatch.setattr(rtmp_server, "DECODER_FACTORY", rtmp_server.PureTierDecoder)
    monkeypatch.setattr(jserver, "DECODER_FACTORY", jserver.PureTierDecoder)
    tags, dcr, units = _x264_tags(streams.load(name))
    dec = PureH264Decoder(dcr)
    want = []
    for i, avcc in enumerate(units):
        frames = dec.decode(avcc)
        if frames:
            want.append((100 * (i + 1), frames[-1][1:]))
    assert len(want) >= len(units) - 3
    got = {}
    for package, reg in (("torch", source_mod.RTMP_MOUNTPOINTS),
                         ("jax", jsource.RTMP_MOUNTPOINTS)):
        recv = reg.listen(f"x264-{name}")
        try:
            _publish(package, f"x264-{name}", tags, settle=0.5)
            got[package] = _drain(recv, "video")
        finally:
            recv.close()
    assert len(got["torch"]) == len(got["jax"]) == len(want)
    for t, j, (ms, planes) in zip(got["torch"], got["jax"], want):
        assert t.source_time == MediaTime.new(ms, 1000)
        assert t.data.picture.planes["y"].device == torch.device("cpu")
        for a, b, c in zip(_planes(t), _planes(j), planes):
            assert np.array_equal(a, c) and np.array_equal(b, c)
    hints = {f.data.duration_hint.frac for f in got["torch"][1:]}
    assert hints == {MediaTime.new(100, 1000).frac}


def test_rtmp_pure_tier_video_loopback_no_shim(monkeypatch):
    """The port's CAVLC intra encoder over RTMP into the port's pure tier:
    the picture is the encoder's decoder-exact reconstruction."""
    from mixlab_tpu_torch.av.h264cavlc import CavlcIntraEncoder
    from mixlab_tpu_torch.av.h264enc import PureH264Stream
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings

    monkeypatch.setattr(rtmp_server, "DECODER_FACTORY", rtmp_server.PureTierDecoder)
    w, h = 96, 64
    ypl = np.zeros((h, w), np.uint8)
    ypl[:, : w // 2] = 220
    pic = Picture(PictureSettings(w, h), {
        "y": ypl, "u": np.full((h // 2, w // 2), 96, np.uint8),
        "v": np.full((h // 2, w // 2), 160, np.uint8)})
    enc = PureH264Stream(PictureSettings(w, h), mode="cavlc", qp=24)
    enc.feed(pic)
    ((key, avcc),) = enc.poll_access_units()
    assert key
    recv = source_mod.RTMP_MOUNTPOINTS.listen("pureonly")
    try:
        _publish("torch", "pureonly", [
            ("video", 0, flv.VideoPacket(flv.VideoFrameType.KEY_FRAME,
                                         flv.VideoPacketType.SEQUENCE_HEADER, 0,
                                         enc.dcr).to_bytes()),
            ("video", 40, flv.VideoPacket(flv.VideoFrameType.KEY_FRAME,
                                          flv.VideoPacketType.NALU, 0, avcc).to_bytes())])
        (frame,) = _drain(recv, "video")
    finally:
        recv.close()
    oracle = CavlcIntraEncoder(qp=24)
    oracle.encode_frame(pic)
    vy, vu, _ = _planes(frame)
    assert np.array_equal(vy, oracle.last_recon[0][:h, :w])
    assert np.array_equal(vu, oracle.last_recon[1][: h // 2, : w // 2])


def _aac_tags(seconds=1.0, seed=3):
    rate = 44_100
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    pcm = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)], 1) * 0.4
    pcm = (np.clip(pcm + rng.normal(0, 0.02, pcm.shape), -1, 1) * 32767).astype(np.int16)
    enc = AacLcEncoder(rate, 2)
    raws = [enc.encode_granule(pcm[k * 1024:(k + 1) * 1024]) for k in range(len(pcm) // 1024)]
    tags = [("audio", 0, flv.AudioPacket(True, enc.asc.to_bytes()).to_bytes())]
    tags += [("audio", k * 1024 * 1000 // rate, flv.AudioPacket(False, r).to_bytes())
             for k, r in enumerate(raws)]
    return tags, raws, enc.asc


def test_rtmp_aac_ingest_matches_jax(monkeypatch):
    """AAC-LC over RTMP: the port's pure tier, decoding in its codec
    process, gives the JAX package's PCM and timestamps, and the in-process
    decoder's PCM as i16."""
    monkeypatch.setattr(rtmp_server, "DECODER_FACTORY", rtmp_server.PureTierDecoder)
    monkeypatch.setattr(jserver, "DECODER_FACTORY", jserver.PureTierDecoder)
    tags, raws, asc = _aac_tags()
    got = {}
    for package, reg in (("torch", source_mod.RTMP_MOUNTPOINTS),
                         ("jax", jsource.RTMP_MOUNTPOINTS)):
        recv = reg.listen("aaccast")
        try:
            _publish(package, "aaccast", tags, settle=0.5)
            got[package] = _drain(recv)
        finally:
            recv.close()
    assert len(got["torch"]) == len(got["jax"]) == len(raws)
    dec = AacLcDecoder(asc)
    for t, j, raw, (_, ms, _) in zip(got["torch"], got["jax"], raws, tags[1:]):
        want = np.clip(dec.decode_raw(raw, asc.sampling_frequency_index) * 32768.0,
                       -32768, 32767).astype(np.int16)
        assert t.source_time.frac == j.source_time.frac == MediaTime.new(ms, 1000).frac
        assert np.array_equal(t.data, j.data) and np.array_equal(t.data, want)


# -- Icecast ------------------------------------------------------------------


def _icecast_source(module, mount, head: bytes, body: bytes, wait):
    """SOURCE ``body`` to ``module``'s listener; ``wait()`` -> True once the
    test has what it waits for (polled until 30 s)."""
    async def go():
        server, port = await _icecast_server(module)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(head + body)
        await writer.drain()
        writer.write_eof()
        status = await reader.read(64)
        for _ in range(3000):
            if wait():
                break
            await asyncio.sleep(0.01)
        writer.close()
        server.close()
        await server.wait_closed()
        return status

    return asyncio.run(go())


def test_icecast_wav_ingest(tmp_path):
    """SOURCE a 48 kHz WAV into a 44.1 kHz engine mountpoint: the port's
    resampled PCM equals the JAX package's, frame for frame."""
    t = np.arange(9600) / 48000
    pcm = (np.sin(2 * np.pi * 1000 * t) * 20000).astype(np.int16)
    wav_path = tmp_path / "in.wav"
    write_wav(wav_path, 48000, np.stack([pcm, pcm], -1))
    head = b"SOURCE /radio HTTP/1.0\r\nContent-Type: audio/wav\r\n\r\n"
    got = {}
    for module, reg in ((icecast, source_mod.ICECAST_MOUNTPOINTS),
                        (jicecast, jsource.ICECAST_MOUNTPOINTS)):
        recv = reg.listen("radio")
        frames = []

        def wait():
            frames.extend(_drain(recv))
            # 9600 samples at 48k -> 8820 at 44.1k less the resampler's carry
            return sum(len(f.data) for f in frames) >= 8000

        try:
            assert b"200 OK" in _icecast_source(module, "radio", head, wav_path.read_bytes(), wait)
            frames.extend(_drain(recv))
        finally:
            recv.close()
        got[module.__name__] = frames
    port, jax = got["mixlab_tpu_torch.io_host.icecast"], got["mixlab_tpu.io_host.icecast"]
    assert [f.source_time.frac for f in port] == [f.source_time.frac for f in jax]
    assert all(np.array_equal(a.data, b.data) for a, b in zip(port, jax))
    total = sum(len(f.data) for f in port)
    assert 8000 <= total <= 8820
    assert np.abs(np.concatenate([f.data for f in port])).max() > 15000


@pytest.mark.skipif(not OGG.exists(), reason="pygame's house_lo.ogg is not installed")
def test_icecast_ogg_vorbis_ingest(monkeypatch):
    """SOURCE the first 8 KiB of an 11,025 Hz mono Ogg/Vorbis stream: the
    ingest is awaited until it has delivered every sample the decoder makes
    of those bytes (not for a span of wall time), mono upmixed to stereo
    and resampled to 44.1 kHz, equal to the JAX package's decoder."""
    body = OGG.read_bytes()[:8192]
    with monkeypatch.context() as m:  # the references, made without pacing
        m.setattr(AudioThrottle, "send_samples", lambda self, n: None)
        m.setattr(JaxAudioThrottle, "send_samples", lambda self, n: None)
        want = icecast._OggVorbisDecoder("application/ogg", 44_100).feed(body)
        jax_want = jicecast._OggVorbisDecoder("application/ogg", 44_100).feed(body)
    assert np.array_equal(want, jax_want) and want.shape[1] == 2 and len(want) > 4000
    recv = source_mod.ICECAST_MOUNTPOINTS.listen("oggradio")
    frames = []

    def wait():
        frames.extend(_drain(recv))
        return sum(len(f.data) for f in frames) >= len(want)

    try:
        head = b"SOURCE /oggradio HTTP/1.0\r\nContent-Type: application/ogg\r\n\r\n"
        assert b"200 OK" in _icecast_source(icecast, "oggradio", head, body, wait)
    finally:
        recv.close()
    got = np.concatenate([f.data for f in frames])
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])
    assert np.abs(got).max() > 5000


def test_icecast_unknown_mountpoint_is_refused():
    async def go():
        server, port = await _icecast_server(icecast)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"SOURCE /nobody HTTP/1.0\r\nContent-Type: audio/wav\r\n\r\n")
        await writer.drain()
        data = await asyncio.wait_for(reader.read(-1), 10)
        writer.close()
        server.close()
        await server.wait_closed()
        return data

    assert asyncio.run(go()).startswith(b"HTTP/1.1 403 Forbidden")


# -- MP3 ---------------------------------------------------------------------


def _mp3_frames(n=40):
    """MPEG-1 layer III frames made here: valid headers (128 kb/s, 44.1
    kHz, joint stereo, every third one padded) over seeded bytes."""
    rng = np.random.default_rng(5)
    frames = []
    for i in range(n):
        pad = int(i % 3 == 0)
        head = bytes([0xFF, 0xFB, 0x90 | (pad << 1), 0x64])
        length = 144 * 128_000 // 44_100 + pad
        frames.append(head + rng.integers(0, 256, length - 4, dtype=np.uint8).tobytes())
    return frames


def test_mp3_frame_parsing_and_splitting():
    """Header math and the dribble-fed splitter on frames built here, equal
    across packages; an ID3v2 tag up front is skipped."""
    frames = _mp3_frames()
    blob = b"".join(frames)
    assert mp3.looks_like_mp3(blob[:10]) and jmp3.looks_like_mp3(blob[:10])
    info = mp3.parse_frame_header(blob[:4])
    assert info == mp3.Mp3FrameInfo(3, 3, 128_000, 44_100, 2, 418, 1152)
    for f in frames:
        a, b = mp3.parse_frame_header(f[:4]), jmp3.parse_frame_header(f[:4])
        assert a.frame_length == len(f) and vars(a) == vars(b)
    for splitter in (mp3.Mp3FrameSplitter(), jmp3.Mp3FrameSplitter()):
        out = []
        for i in range(0, len(blob), 777):
            out.extend(splitter.feed(blob[i:i + 777]))
        assert out == frames[:-1] or out == frames
    tag = b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"x" * 10
    assert mp3.Mp3FrameSplitter().feed(tag + blob[:2000])[0] == frames[0]
    with pytest.raises(mp3.Mp3Error):
        mp3.parse_frame_header(b"\xff\xf1\x50\x80")  # ADTS: layer bits 00


def _lame_mp3():
    from mixlab_tpu.native import avshim

    if not (avshim.available() and avshim.have_encoder("libmp3lame")):
        pytest.skip("libmp3lame unavailable")
    t = np.arange(44_100) / 44_100
    pcm = (np.stack([np.sin(2 * np.pi * 440 * t)] * 2, 1) * 12000).astype(np.int16)
    enc = avshim.AacEncoder(44100, 2, 128_000, codec="libmp3lame")
    enc.send(pcm)
    enc.flush()
    frames = [frame for _pts, frame in enc.receive()]
    enc.close()
    return frames


def _shim():
    from mixlab_tpu.native import avshim as jax_avshim
    from mixlab_tpu_torch.native import avshim

    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    if not jax_avshim.available():
        pytest.skip("the JAX package's libavcodec shim is unavailable")
    return avshim


def _icecast_body(kind):
    """An MP3 (libmp3lame) or ADTS-AAC SOURCE body and its content type."""
    if kind == "mp3":
        return b"".join(_lame_mp3()[:20]), b"audio/mpeg"
    _, raws, asc = _aac_tags(0.2)
    from mixlab_tpu_torch.av.aac import adts_frame

    return b"".join(adts_frame(r, asc) for r in raws), b"audio/aac"


@pytest.mark.parametrize("kind", ["mp3", "adts"])
def test_icecast_mp3_ingest(kind, caplog, monkeypatch):
    """An MP3 (libmp3lame) or ADTS-AAC SOURCE where the libavcodec shim's
    libraries are absent: the port refuses it, saying so, and the mount
    closes with no audio."""
    from mixlab_tpu_torch.native import avshim

    body, ctype = _icecast_body(kind)
    monkeypatch.setattr(avshim, "available", lambda: False)
    recv = source_mod.ICECAST_MOUNTPOINTS.listen("mp3radio")
    try:
        with caplog.at_level("WARNING", logger="mixlab_tpu_torch.io_host.icecast"):
            head = b"SOURCE /mp3radio HTTP/1.0\r\nContent-Type: " + ctype + b"\r\n\r\n"
            assert b"200 OK" in _icecast_source(icecast, "mp3radio", head, body,
                                                lambda: "refused" in caplog.text)
        assert _drain(recv) == []
        assert "refused" in caplog.text and "ffmpeg libraries" in caplog.text
    finally:
        recv.close()


@pytest.mark.parametrize("kind", ["mp3", "adts"])
def test_icecast_mp3_ingest_through_the_shim(kind):
    """The same SOURCE bodies where the shim is: both packages' Icecast
    ingest decode them through libavcodec into the mountpoint a StreamInput
    reads, the same i16 PCM at the same times, equal to the port shim's
    own decode of the frames."""
    avshim = _shim()
    body, ctype = _icecast_body(kind)
    dec = avshim.AudioDecoder("mp3" if kind == "mp3" else "aac")
    if kind == "mp3":
        frames = mp3.Mp3FrameSplitter().feed(body)
    else:
        frames = icecast._ShimAudioDecoder("audio/aac", 44_100, "aac")._split_adts(body)
    want = np.concatenate([pcm for f in frames for _, pcm, _ in dec.decode(f)])
    dec.close()
    head = b"SOURCE /shimradio HTTP/1.0\r\nContent-Type: " + ctype + b"\r\n\r\n"
    got = {}
    for module, reg in ((icecast, source_mod.ICECAST_MOUNTPOINTS),
                        (jicecast, jsource.ICECAST_MOUNTPOINTS)):
        recv = reg.listen("shimradio")
        out = []

        def wait():
            out.extend(_drain(recv))
            return sum(len(f.data) for f in out) >= len(want)

        try:
            assert b"200 OK" in _icecast_source(module, "shimradio", head, body, wait)
            out.extend(_drain(recv))
        finally:
            recv.close()
        got[module] = out
    port, jax = got[icecast], got[jicecast]
    assert len(port) == len(jax) > 0
    for a, b in zip(port, jax):
        assert a.source_time.frac == b.source_time.frac and np.array_equal(a.data, b.data)
    pcm = np.concatenate([f.data for f in port])
    assert np.array_equal(pcm, want) and np.abs(pcm).max() > 1000


def test_rtmp_mp3_audio_ingest(monkeypatch, caplog):
    """FLV sound format 2 (MP3) over RTMP on the pure tier: it has no MP3
    decoder (the JAX package's pure tier has none either); the audio is
    dropped with one warning, which says that the shim's libraries are
    absent."""
    frames = _lame_mp3()
    monkeypatch.setattr(rtmp_server, "DECODER_FACTORY", rtmp_server.PureTierDecoder)
    recv = source_mod.RTMP_MOUNTPOINTS.listen("mp3cast")
    try:
        with caplog.at_level("WARNING", logger="mixlab_tpu_torch.io_host.rtmp.server"):
            _publish("torch", "mp3cast", [("audio", k * 26, bytes([0x2F]) + f)
                                          for k, f in enumerate(frames[:10])])
        assert _drain(recv) == []
        assert caplog.text.count("has no MP3 decoder") == 1
        assert "ffmpeg libraries" in caplog.text
    finally:
        recv.close()


def test_rtmp_mp3_audio_ingest_through_the_shim():
    """The same MP3 tags over RTMP into both packages' default decoder (the
    shim's): the same i16 PCM at the same times, equal to the port shim's
    own decode of the frames."""
    avshim = _shim()
    frames = _lame_mp3()[:10]
    assert isinstance(rtmp_server.DECODER_FACTORY("cpu"), rtmp_server.ShimDecoder)
    dec = avshim.AudioDecoder("mp3")
    want = np.concatenate([pcm for f in frames for _, pcm, _ in dec.decode(f)])
    dec.close()
    tags = [("audio", k * 26, bytes([0x2F]) + f) for k, f in enumerate(frames)]
    got = {}
    for package, reg in (("torch", source_mod.RTMP_MOUNTPOINTS),
                         ("jax", jsource.RTMP_MOUNTPOINTS)):
        recv = reg.listen("shimmp3cast")
        try:
            _publish(package, "shimmp3cast", tags, settle=0.5)
            got[package] = _drain(recv)
        finally:
            recv.close()
    assert len(got["torch"]) == len(got["jax"]) > 0
    for a, b in zip(got["torch"], got["jax"]):
        assert a.source_time.frac == b.source_time.frac and np.array_equal(a.data, b.data)
    pcm = np.concatenate([f.data for f in got["torch"]])
    assert np.array_equal(pcm, want) and np.abs(pcm).max() > 1000


def test_shim_decoder_is_refused(monkeypatch):
    """Where the shim's libraries are absent (and no ffmpeg CLI) the default
    decoder is the pure tier's; where they are, the shim's, as in the JAX
    package."""
    from mixlab_tpu_torch.av import codecs
    from mixlab_tpu_torch.native import avshim

    if avshim.available():
        assert isinstance(rtmp_server.default_decoder_factory("cpu"), rtmp_server.ShimDecoder)
        dec = rtmp_server.ShimDecoder("cpu")
        assert dec.device == torch.device("cpu") and dec.decode_audio(b"") is None
        dec.close()
    monkeypatch.setattr(avshim, "available", lambda: False)
    monkeypatch.setattr(codecs.shutil, "which", lambda name: None)
    assert isinstance(rtmp_server.default_decoder_factory("cpu"), rtmp_server.PureTierDecoder)
