"""The port's video path against the JAX package on the CPU: the crossfade
twin, the resample tables and resize, letterbox geometry, colorspace and
patterns, scale_picture and the video mixer tick.  Inputs are numpy arrays
from seeds, handed to both packages.

Tolerances: the crossfade is exact integer math (exact); the resample
tables come from the same float64 numpy code (bit-identical); the int8
resize is an exact integer product followed by the same f32 epilogue
(exact); everything else rounds f32 sums to u8, and the two packages may
sum in another order (XLA on the CPU may also contract a*b + c into one
FMA), so a pixel may differ by 1 LSB (``tests/test_video.py:197``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.protocol import VideoMixerParams as JaxVideoMixerParams
from mixlab_tpu.utils.mtime import MediaDuration as JaxMediaDuration
from mixlab_tpu.video import blend as jblend
from mixlab_tpu.video import colorspace as jcs
from mixlab_tpu.video import engine as jengine
from mixlab_tpu.video import frame as jframe
from mixlab_tpu.video import pattern as jpattern
from mixlab_tpu.video import scale as jscale
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.protocol import VideoMixerParams
from mixlab_tpu_torch.utils.mtime import MediaDuration
from mixlab_tpu_torch.video import blend, colorspace, engine, frame, pattern, scale

CPU = torch.device("cpu")
CFG = EngineConfig(sample_rate=44_100)
CFG_J = JaxEngineConfig(sample_rate=44_100)
FADES = [0, 1, 127, 128, 254, 255]
# planes of a 1080p picture, a non-lane-multiple one, the smallest, and one
# whose size is not a multiple of 16 (the kernel's vector width)
PLANE_SHAPES = [(1080, 1920), (540, 960), (36, 100), (1, 1), (7, 13)]


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _lsb(got, want):
    return int(np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int)).max())


def _pics(planes: dict, settings):
    """The same numpy planes as a JAX-package Picture and a port Picture."""
    s_j = jframe.PictureSettings(settings.width, settings.height, settings.pixel_format)
    return (jframe.Picture(s_j, {k: jnp.asarray(v) for k, v in planes.items()}),
            frame.Picture(settings, {k: torch.from_numpy(v.copy()) for k, v in planes.items()}))


def _yuv_planes(rng, w, h):
    return {"y": _u8(rng, (h, w)), "u": _u8(rng, (h // 2, w // 2)),
            "v": _u8(rng, (h // 2, w // 2))}


# -- crossfade -----------------------------------------------------------------


@pytest.mark.parametrize("shape", PLANE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_crossfade_twin_matches_xla_and_pallas(shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    a, b = _u8(rng, shape), _u8(rng, shape)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fade in FADES:
        got = blend.crossfade_torch(ta, tb, fade).numpy()
        np.testing.assert_array_equal(got, np.asarray(jblend.crossfade_xla(a, b, fade)))
    # the Pallas kernel in interpret mode, as tests/test_video.py:41 runs it
    for fade in (0, 128, 255):
        got = blend.crossfade_torch(ta, tb, fade).numpy()
        np.testing.assert_array_equal(got, np.asarray(jblend.crossfade_pallas(a, b, fade)))


def test_crossfade_picture_takes_the_twin_only_on_the_cpu():
    rng = np.random.default_rng(3)
    planes = _yuv_planes(rng, 64, 48)
    other = _yuv_planes(rng, 64, 48)
    pa = {k: torch.from_numpy(v) for k, v in planes.items()}
    pb = {k: torch.from_numpy(v) for k, v in other.items()}
    n = blend.crossfade_cuda.launches
    out = blend.crossfade_picture(pa, pb, 153)
    want = jblend.crossfade_picture(planes, other, 153, use_pallas=False)
    for k in planes:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
    assert blend.crossfade_cuda.launches == n
    # any other device goes to the kernel's wrapper, which refuses it here
    meta = {k: torch.empty(v.shape, dtype=torch.uint8, device="meta") for k, v in planes.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        blend.crossfade_picture(meta, meta, 153)
    with pytest.raises(ValueError, match="unsupported device"):
        blend.crossfade_picture({**pa, "y": meta["y"]}, pb, 153)  # a mix of devices
    with pytest.raises(ValueError, match="fade"):
        blend.crossfade_cuda([meta["y"]], [meta["y"]], 256)
    assert blend.crossfade_cuda.launches == n


# -- resample tables and resize ------------------------------------------------------

SIZE_PAIRS = [(720, 1080), (1280, 1920), (36, 72), (1080, 540), (72, 108), (350, 720)]


@pytest.mark.parametrize("n_in,n_out", SIZE_PAIRS)
def test_resize_tables_bit_identical(n_in, n_out):
    np.testing.assert_array_equal(scale.resize_matrix(n_in, n_out),
                                  jscale.resize_matrix(n_in, n_out))
    for got, want in zip(scale._resize_matrix_i8(n_in, n_out),
                         jscale._resize_matrix_i8(n_in, n_out)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


RESIZES = [((36, 52), (72, 104)), ((72, 128), (108, 192)), ((48, 64), (36, 64)),
           ((36, 52), (36, 100)), ((54, 96), (27, 48))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_plane_matches_jax(src, dst):
    rng = np.random.default_rng(src[0] + dst[1])
    plane = _u8(rng, src)
    t = torch.from_numpy(plane)
    f32 = scale.resize_plane(t, *dst, method="f32").numpy()
    assert _lsb(f32, jscale.resize_plane(jnp.asarray(plane), *dst, method="f32")) <= 1
    np.testing.assert_array_equal(scale.resize_plane(t, *dst).numpy(), f32)  # auto = f32
    i8 = scale.resize_plane(t, *dst, method="int8").numpy()
    np.testing.assert_array_equal(
        i8, np.asarray(jscale.resize_plane(jnp.asarray(plane), *dst, method="int8")))
    with pytest.raises(ValueError, match="method"):
        scale.resize_plane(t, *dst, method="bf16")


def test_int_matmul_pads_exactly():
    rng = np.random.default_rng(11)
    a = rng.integers(-127, 128, (5, 13), dtype=np.int8)
    b = rng.integers(-127, 128, (13, 7), dtype=np.int8)
    got = scale.int_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    padded = scale._pad_to(torch.from_numpy(a), 1, 8)
    assert padded.shape == (5, 16) and not padded[:, 13:].any()
    assert scale._pad_to(torch.from_numpy(a), 0, 1, minimum=17).shape == (17, 13)


SETTINGS_PAIRS = [((1280, 720), (1920, 1080)), ((1280, 720), (640, 480)),
                  ((639, 360), (320, 481)), ((64, 48), (192, 108)), ((100, 100), (64, 36)),
                  ((1920, 1080), (1280, 720))]


@pytest.mark.parametrize("a,b", SETTINGS_PAIRS)
def test_letterbox_and_unify_equal(a, b):
    sa, sb = frame.PictureSettings(*a), frame.PictureSettings(*b)
    ja, jb = jframe.PictureSettings(*a), jframe.PictureSettings(*b)
    assert scale.letterbox_geometry(sa, sb) == jscale.letterbox_geometry(ja, jb)
    u, ju = frame.unify_picture_settings(sa, sb), jframe.unify_picture_settings(ja, jb)
    assert (u.width, u.height, u.pixel_format) == (ju.width, ju.height, ju.pixel_format)


# -- colorspace and patterns --------------------------------------------------------


def test_colorspace_matches_jax():
    rng = np.random.default_rng(21)
    rgb = _u8(rng, (48, 64, 3))
    got = colorspace.rgb_to_yuv420(torch.from_numpy(rgb))
    for g, w in zip(got, jcs.rgb_to_yuv420(jnp.asarray(rgb))):
        assert g.dtype == torch.uint8 and _lsb(g.numpy(), w) <= 1
    planes = [torch.from_numpy(rgb[..., c].copy()) for c in range(3)]
    for g, w in zip(colorspace.rgb_planes_to_yuv420(*planes), got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    y, u, v = (_u8(rng, s) for s in ((48, 64), (24, 32), (24, 32)))
    back = colorspace.yuv420_to_rgb(*(torch.from_numpy(x) for x in (y, u, v)))
    assert back.shape == (48, 64, 3)
    assert _lsb(back.numpy(), jcs.yuv420_to_rgb(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))) <= 1
    pic = frame.Picture(frame.PictureSettings(64, 48, frame.RGB24), {"rgb": torch.from_numpy(rgb)})
    yuv = colorspace.picture_rgb_to_yuv420(pic)
    assert yuv.settings.pixel_format == frame.YUV420P
    assert colorspace.picture_yuv420_to_rgb(yuv).planes["rgb"].shape == (48, 64, 3)


@pytest.mark.parametrize("kind", ["bars", "gradient"])
@pytest.mark.parametrize("fmt", [frame.YUV420P, frame.RGB24])
def test_pattern_picture_matches_jax(kind, fmt):
    for t in (0, 5, 300):
        got = pattern.pattern_picture(kind, 96, 54, t, fmt, device="cpu")
        want = jpattern.pattern_picture(kind, 96, 54, t, fmt)
        assert got.settings.width == 96 and got.settings.pixel_format == fmt
        assert sorted(got.planes) == sorted(want.planes)
        for k in want.planes:
            assert tuple(got.planes[k].shape) == want.planes[k].shape
            assert _lsb(got.planes[k].numpy(), want.planes[k]) <= 1


# -- scale_picture --------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((128, 72), (192, 108)), ((1280, 720), (1920, 1080)),
                                     ((64, 48), (192, 108)), ((128, 72), (128, 128))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_scale_picture_matches_jax(src, dst):
    rng = np.random.default_rng(src[0])
    pj, pt = _pics(_yuv_planes(rng, *src), frame.PictureSettings(*src))
    out = frame.PictureSettings(*dst)
    got = scale.scale_picture(pt, out)
    want = jscale.scale_picture(pj, jframe.PictureSettings(*dst))
    assert got.settings == out
    for k in ("y", "u", "v"):
        assert tuple(got.planes[k].shape) == want.planes[k].shape
        assert _lsb(got.planes[k].numpy(), want.planes[k]) <= 1
    # the cached blank stays blank after a letterbox wrote around it
    blank = frame.Picture.blank(out, CPU)
    assert not blank.planes["y"].any() and bool((blank.planes["u"] == 0x80).all())
    assert scale.scale_picture(pt, pt.settings) is pt


def test_blank_cache_is_per_device():
    s = frame.PictureSettings(64, 48)
    assert frame.Picture.blank(s, CPU) is frame.Picture.blank(s, "cpu")
    meta = frame.Picture.blank(s, torch.device("meta"))
    assert meta.planes["y"].device.type == "meta"


# -- the video mixer tick -------------------------------------------------------------


def _frame_pair(rng, w, h, ticks):
    planes = _yuv_planes(rng, w, h)
    pj, pt = _pics(planes, frame.PictureSettings(w, h))
    return (jframe.VideoFrame(pj, duration_hint=JaxMediaDuration.new(ticks, 60)),
            frame.VideoFrame(pt, duration_hint=MediaDuration.new(ticks, 60)))


def test_video_mixer_tick_matches_jax():
    """One script through both mixers: compose, passthrough, a size change,
    expiry, a halfway fade, ticks with no inputs and an unset channel."""
    rng = np.random.default_rng(42)
    spt = CFG.samples_per_tick
    fa = _frame_pair(rng, 64, 48, 3)
    fb = _frame_pair(rng, 48, 32, 1)
    fc = _frame_pair(rng, 96, 54, 2)
    none = (None, None)
    script = [  # (fader, a, b, [inputs per channel])
        (0.6, 0, 1, [fa, fb, none, none]),   # compose two sizes
        (0.6, 0, 1, [none, none, none, none]),  # b expired, a stored
        (0.5, 0, 1, [none, fc, none, none]),   # size change, halfway fade
        (0.5, 0, 3, [none, none, none, none]),  # b on an empty channel
        (0.5, 0, None, [none, none, none, none]),  # unset channel
        (1.0, 2, 1, [none, none, none, none]),   # everything expired
        (0.0, 0, 1, [fa, none, none, none]),
    ]
    st_j, st_t = jengine.VideoMixerState(), engine.VideoMixerState()
    for tick, (fader, a, b, ins) in enumerate(script):
        outs_j = jengine.video_mixer_tick(
            st_j, JaxVideoMixerParams(a=a, b=b, fader=fader), [x[0] for x in ins],
            tick * spt, CFG_J)
        outs_t = engine.video_mixer_tick(
            st_t, VideoMixerParams(a=a, b=b, fader=fader), [x[1] for x in ins],
            tick * spt, CFG, CPU)
        assert len(outs_t) == 3
        # passthroughs are the input frames themselves
        for (fj, ft), oj, ot in ((ins[a] if a is not None else none, outs_j[1], outs_t[1]),
                                 (ins[b] if b is not None and b < 4 else none, outs_j[2],
                                  outs_t[2])):
            assert (ot is ft) and (oj is fj)
        oj, ot = outs_j[0], outs_t[0]
        assert (oj is None) == (ot is None), tick
        if ot is None:
            continue
        s = ot.picture.settings
        assert (s.width, s.height) == (oj.picture.settings.width, oj.picture.settings.height)
        assert ot.duration_hint == MediaDuration.new(1, 60)
        for k in ("y", "u", "v"):
            assert _lsb(ot.picture.planes[k].numpy(), oj.picture.planes[k]) <= 1, (tick, k)
        for cj, ct in zip(st_j.channels, st_t.channels):
            assert (cj.stored is None) == (ct.stored is None), tick
            assert str(cj.active_until) == str(ct.active_until)
