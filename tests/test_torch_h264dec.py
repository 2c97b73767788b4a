"""The port's H.264 decoder (``mixlab_tpu_torch/av/h264dec.py`` and its native
tier in ``mixlab_tpu_torch/native/``) against the JAX package's, on the CPU.

Every stream decodes to the JAX decoder's planes, bit for bit, on both of
the port's tiers: the native tier (the port's C++ library) and the Python
tier (the port's native library patched away).  The JAX side runs its Python
tier (``mixlab_tpu.native._load`` patched to ``None``), so these tests never
build the JAX package's native library.  Streams: the port's own CAVLC intra
encoder; the x264 streams committed under ``tests/data/h264/``
(``tests/torch_h264_streams.py`` says how they were made); more x264 streams
made here by the JAX package's shim where it is available.

Then the faults of the JAX decoder that the port does not carry: a size
change through a new SPS, a reference of the wrong shape, an Exp-Golomb code
of more than 15 leading zeros on the native tier, and a B stream without the
VUI reorder bound.
"""

import numpy as np
import pytest

import mixlab_tpu.native as jax_native
from mixlab_tpu.av.h264dec import PureH264Decoder as JaxDecoder
from mixlab_tpu_torch import native
from mixlab_tpu_torch.av import h264dec
from mixlab_tpu_torch.av.h264cavlc import CavlcIntraEncoder
from mixlab_tpu_torch.av.h264dec import H264DecodeError, PureH264Decoder, split_annexb
from mixlab_tpu_torch.av.h264enc import BitWriter, make_pps, make_sps, nal
from mixlab_tpu_torch.av.sps import _BitReader
from mixlab_tpu_torch.video.frame import Picture, PictureSettings
from tests import torch_h264_streams as streams

TIERS = ["native", "python"]


@pytest.fixture(autouse=True)
def _jax_python_tier(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)


@pytest.fixture
def tier(request, monkeypatch):
    """``native``: the port's C++ tier, which must build here; ``python``:
    the port's native library patched away."""
    if request.param == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


def decode(cls, data: bytes):
    dec = cls()
    return dec.decode_annexb(data) + dec.flush()


def assert_same_frames(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"frame {i}: pts {g[0]} != {w[0]}"
        for name, a, b in zip("yuv", g[1:], w[1:]):
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, (i, name)
            assert np.array_equal(a, b), (
                f"frame {i} plane {name}: {int((a != b).sum())} samples differ")


def annexb(units):
    return b"".join(b"\x00\x00\x00\x01" + u for u in units)


def intra_units(w, h, qp=26, seed=0):
    """SPS, PPS and one IDR picture of seeded content by the port's CAVLC
    intra encoder."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 255 // max(w - 1, 1)) // 2 + (yy * 100 // max(h - 1, 1))
         + rng.integers(0, 24, (h, w))).astype(np.uint8)
    u = rng.integers(90, 170, (h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(90, 170, (h // 2, w // 2), dtype=np.uint8)
    pic = Picture(PictureSettings(w, h), {"y": y, "u": u, "v": v})
    return [nal(7, make_sps(w, h)), nal(8, make_pps()),
            nal(5, CavlcIntraEncoder(qp=qp).encode_frame(pic))]


def p_slice(mbw, mbh, mvd=(0, 0), frame_num=1):
    """A CAVLC P slice for ``make_sps``/``make_pps``'s parameters: the first
    macroblock P_L0_16x16 with ``mvd`` and no residual, the rest skipped."""
    w = BitWriter()
    w.ue(0)             # first_mb_in_slice
    w.ue(5)             # slice_type: P (all slices)
    w.ue(0)             # pic_parameter_set_id
    w.u(frame_num, 4)   # frame_num (log2_max_frame_num = 4; POC type 2)
    w.u(0, 1)           # num_ref_idx_active_override_flag
    w.u(0, 1)           # ref_pic_list_modification_flag_l0
    w.u(0, 1)           # adaptive_ref_pic_marking_mode_flag
    w.se(0)             # slice_qp_delta
    w.ue(1)             # disable_deblocking_filter_idc
    w.ue(0)             # mb_skip_run
    w.ue(0)             # mb_type P_L0_16x16 (one reference: no ref_idx)
    w.se(mvd[0])
    w.se(mvd[1])
    w.ue(0)             # coded_block_pattern 0 (inter)
    if mbw * mbh > 1:
        w.ue(mbw * mbh - 1)
    w.rbsp_trailing()
    return nal(1, w.getvalue())


# -- streams of the port's own encoder ---------------------------------------


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("size,qp", [((64, 48), 18), ((176, 144), 34), ((120, 84), 26)])
def test_port_intra_stream_matches_jax(tier, size, qp):
    data = annexb(intra_units(*size, qp=qp, seed=qp))
    assert_same_frames(decode(PureH264Decoder, data), decode(JaxDecoder, data))


# -- third-party streams: x264 ----------------------------------------------


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("name", sorted(streams.STREAMS))
def test_committed_x264_stream_matches_jax(tier, name):
    data = streams.load(name)
    want = decode(JaxDecoder, data)
    assert len(want) == streams.STREAMS[name][3]
    assert_same_frames(decode(PureH264Decoder, data), want)


def _shim():
    from mixlab_tpu.native import avshim

    if not avshim.available():
        pytest.skip("the JAX package's libavcodec shim is unavailable")
    return avshim


# classes the committed streams leave out: a scene cut (intra macroblocks in
# P pictures), weighted prediction with several references, temporal direct
GENERATED = {
    "cavlc_p_weightp_multiref": (128, 96, "preset=veryfast,profile=main,g=250,threads=1,"
                                 "qp=22,x264-params=cabac=0:weightp=2:ref=3:bframes=0", 6),
    "cabac_p_cut": (96, 64, "preset=veryfast,profile=main,tune=zerolatency,g=250,"
                    "threads=1,qp=26,x264-params=scenecut=0", 6),
    "cabac_b_temporal": (96, 64, "preset=veryfast,profile=main,g=250,threads=1,qp=28,"
                         "x264-params=scenecut=0:bframes=2:b-adapt=0:direct=temporal", 7),
}


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_x264_stream_matches_jax(tier, name, monkeypatch):
    avshim = _shim()
    w, h, opts, n = GENERATED[name]
    frames = streams.content(w, h, n, seed=5)
    if name.endswith("_cut"):
        frames = frames[:n // 2] + [tuple(255 - p for p in f) for f in frames[n // 2:]]
    enc = avshim.VideoEncoder(w, h, fps=30, opts=opts)
    for i, (y, u, v) in enumerate(frames):
        enc.send(y, u, v, i)
    enc.flush()
    packets = enc.receive()
    data = enc.extradata() + b"".join(p[3] for p in packets)
    enc.close()
    assert_same_frames(decode(PureH264Decoder, data), decode(JaxDecoder, data))


# -- the JAX decoder's faults, repaired in the port ---------------------------


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_sps_size_change_raises_typed_error(tier):
    """A 64x48 stream, then an SPS for 320x240 and a P slice: the port clears
    its DPB at the new size and raises ``H264DecodeError`` on both tiers;
    the JAX decoder keeps its behaviour (it decodes the P slice against the
    64x48 reference, on its native tier past the reference's planes)."""
    data = annexb(intra_units(64, 48) + [nal(7, make_sps(320, 240)), p_slice(20, 15)])
    with pytest.raises(H264DecodeError, match="empty reference list"):
        decode(PureH264Decoder, data)
    assert [f[1].shape for f in decode(JaxDecoder, data)] == [(48, 64), (240, 320)]


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_reference_of_another_shape_raises_before_any_tier_reads_it(tier, monkeypatch):
    """A stored reference whose planes do not fit the active SPS is refused
    when the slice's lists are built, before the native tier gets its
    buffers."""
    calls = []
    monkeypatch.setattr(native, "h264_decode_inter",
                        lambda *a, **k: calls.append(1) or 0)
    dec = PureH264Decoder()
    assert len(dec.decode_annexb(annexb(intra_units(64, 48)))) == 1
    ref = dec.dpb.pics[0]
    ref.y = ref.y[:32]
    with pytest.raises(H264DecodeError, match="reference picture of 64x32"):
        dec.decode_annexb(annexb([p_slice(4, 3)]))
    assert calls == []


@pytest.mark.parametrize("tier", TIERS, indirect=True)
def test_mvd_of_code_num_65536_decodes_on_both_tiers(tier, monkeypatch):
    """An mvd of -32,768 is Exp-Golomb codeNum 65,536: 16 leading zeros.  The
    JAX native tier refuses more than 15; the port's native tier takes up
    to 31, as the Python tiers do, and decodes the slice itself."""
    calls = []
    real = native.h264_decode_inter

    def spy(*args, **kwargs):
        rc = real(*args, **kwargs)
        calls.append(rc)
        return rc

    monkeypatch.setattr(native, "h264_decode_inter", spy)
    data = annexb(intra_units(64, 48) + [p_slice(4, 3, mvd=(-32768, 0))])
    got = decode(PureH264Decoder, data)
    assert_same_frames(got, decode(JaxDecoder, data))
    assert calls == ([0] if tier == "native" else [None])
    assert not np.array_equal(got[0][1], got[1][1])  # the far-off block moved


def _strip_vui(unit: bytes) -> bytes:
    """The SPS NAL ``unit`` rewritten with vui_parameters_present_flag 0."""
    r = _BitReader(unit[1:])
    profile = r.bits(8)
    r.bits(16)
    r.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        if r.ue() == 3:
            r.bit()
        r.ue()
        r.ue()
        r.bit()
        assert r.bit() == 0  # no scaling matrices
    r.ue()
    poc_type = r.ue()
    assert poc_type in (0, 2)
    if poc_type == 0:
        r.ue()
    r.ue()
    r.bit()
    r.ue()
    r.ue()
    if r.bit() == 0:
        r.bit()
    r.bit()
    if r.bit():
        for _ in range(4):
            r.ue()
    assert r.bit() == 1  # the VUI is present
    bits = np.unpackbits(np.frombuffer(r.data, np.uint8))[:r.pos - 1]
    bits = np.concatenate([bits, [0, 1], np.zeros(-(len(bits) + 2) % 8)]).astype(np.uint8)
    return nal(7, np.packbits(bits).tobytes(), ref_idc=(unit[0] >> 5) & 3)


@pytest.mark.parametrize("tier", TIERS, indirect=True)
@pytest.mark.parametrize("name", ["cavlc_b", "cabac_b"])
def test_b_stream_without_vui_reorder_bound_is_in_display_order(tier, name):
    """x264's B streams with the SPS rewritten without its VUI: the port
    emits the frames the JAX decoder emits for the stream with its VUI, in
    the same display order; the JAX decoder emits the first GOP's P picture
    before the B pictures that precede it."""
    data = streams.load(name)
    novui = annexb([_strip_vui(u) if u[0] & 0x1F == 7 else u for u in split_annexb(data)])
    assert novui != data
    want = decode(JaxDecoder, data)
    assert_same_frames(decode(PureH264Decoder, novui), want)
    jax_order = [f[1] for f in decode(JaxDecoder, novui)]
    assert not all(np.array_equal(a, f[1]) for a, f in zip(jax_order, want))


def test_docstring_states_the_scope():
    """The module says what it decodes (B slices, the 8x8 transform) and
    what it refuses, not the JAX copy's stale list."""
    doc = h264dec.__doc__
    assert "B slices with spatial and temporal direct modes" in doc
    assert "8x8 transform" in doc
    assert "Out of scope (rejected with a typed error, never mis-decoded): B slices" not in doc
