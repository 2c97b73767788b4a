"""The port's video scale family against the JAX package on the CPU: the
polyphase plan and resize (``video/resize_cuda.py``, whose plain twin runs
here), the integer-ratio upscale, the banded int8 products, the folded
composite (``video/fused.py``) and the host scale (``video/scale_host.py``).
Inputs are numpy arrays from seeds, handed to both packages.

Tolerances: the plans and tables come from the same float64 numpy code
(identical); the polyphase twin rounds each ``acc + w·x`` once, as XLA's
CPU backend evaluates the JAX kernel in interpret mode (bit-exact); the
int8 paths are exact integer products with the same f32 epilogue (exact);
the dense f32 resize sums in another order (1 LSB, ``tests/test_video.py:215``);
the fold's bounds are ``tests/test_video.py:259-334``'s and the host scale's
``tests/test_video.py:444``'s.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixlab_tpu.video import colorspace as jcs
from mixlab_tpu.video import fused as jfused
from mixlab_tpu.video import pattern as jpattern
from mixlab_tpu.video import resize_pallas as jresize
from mixlab_tpu.video import scale as jscale
from mixlab_tpu.video import scale_host as jscale_host
from mixlab_tpu_torch.video import blend, colorspace, frame, fused, pattern, resize_cuda, scale
from mixlab_tpu_torch.video import scale_host


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _lsb(got, want):
    return int(np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int)).max())


# -- the polyphase plan -------------------------------------------------------------

# (n_in, n_out): the card check's geometries (720p->1080p and its chroma,
# 540p->1080p and its chroma, 1080p->720p, 1080->540, 240->256 with 16
# phases, ragged widths), then ratios with no plan (J > 12, L > 16)
PLAN_PAIRS = [(720, 1080), (1280, 1920), (360, 540), (640, 960), (540, 1080), (960, 1920),
              (270, 540), (480, 960), (1080, 720), (1920, 1280), (1080, 540), (240, 256),
              (98, 147), (174, 261), (1080, 560), (1920, 352), (100, 117), (64, 64)]


@pytest.mark.parametrize("n_in,n_out", PLAN_PAIRS)
def test_phase_plan_equals_jax(n_in, n_out):
    got, want = resize_cuda._phase_plan(n_in, n_out), jresize._phase_plan(n_in, n_out)
    assert (got is None) == (want is None)
    if got is not None:
        L, M, J, bases, W, pad_lo, pad_hi, Q = got
        assert (L, M, J, bases, pad_lo, pad_hi, Q) == (
            want[0], want[1], want[2], want[3], want[5], want[6], want[7])
        assert W.dtype == np.float32
        np.testing.assert_array_equal(W, want[4])
        assert L <= resize_cuda.MAX_PHASES and J <= resize_cuda.MAX_TAPS
    for other in (n_in, 2 * n_in):
        assert resize_cuda.can_resize_polyphase(n_in, other, n_out, other) == \
            jresize.can_resize_pallas(n_in, other, n_out, other)
    assert resize_cuda.can_resize_polyphase(n_in, 1920, n_out, 352) is False


def test_phase_plan_cases_without_a_plan():
    assert resize_cuda._phase_plan(1920, 352) is None   # 11 phases, 23 taps
    assert resize_cuda._phase_plan(100, 117) is None    # 117 phases
    assert resize_cuda._phase_plan(64, 64) is None      # nothing to resize
    assert resize_cuda._phase_plan(240, 256)[0] == 16   # the most phases
    assert not resize_cuda.can_resize_polyphase(1080, 1920, 560, 352)  # as test_video.py:216
    with pytest.raises(ValueError, match="no polyphase plan"):
        resize_cuda.resize_plane_polyphase(torch.zeros((64, 1920), dtype=torch.uint8), 64, 352)


# -- the polyphase resize -----------------------------------------------------------

# the three shapes of tests/test_video.py:210, 90x160 -> 135x240, and one
# axis only (rows; columns; a 2x upscale of a ragged width)
POLY_CASES = [(72, 128, 108, 192), (54, 96, 108, 192), (64, 96, 48, 64), (90, 160, 135, 240),
              (64, 96, 64, 48), (60, 64, 90, 64), (48, 30, 96, 60)]


@pytest.mark.parametrize("case", POLY_CASES, ids=lambda c: "{}x{}-{}x{}".format(*c))
def test_polyphase_twin_bit_exact_vs_pallas_interpret(case):
    h1, w1, h2, w2 = case
    rng = np.random.default_rng(h1 * 31 + w2)
    x = _u8(rng, (h1, w1))
    n = resize_cuda.resize_picture_polyphase.launches
    got = resize_cuda.resize_plane_polyphase(torch.from_numpy(x), h2, w2)
    assert resize_cuda.resize_picture_polyphase.launches == n  # CPU tensors take the twin
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h2, w2)
    want = np.asarray(jresize.resize_plane_pallas(jnp.asarray(x), h2, w2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert _lsb(got.numpy(), scale.resize_plane(torch.from_numpy(x), h2, w2).numpy()) <= 1


def test_polyphase_passes_keep_bf16_between_axes():
    """The row pass returns bf16 (the JAX kernel's intermediate), the
    column pass u8; the twin equals the JAX axis-0 kernel pass by pass."""
    rng = np.random.default_rng(2)
    x = _u8(rng, (54, 96))
    rows = resize_cuda.resize_axis_torch(torch.from_numpy(x), 108, 0)
    assert rows.dtype == torch.bfloat16 and tuple(rows.shape) == (108, 96)
    want = np.asarray(jresize._resize_axis0(jnp.asarray(x), 108, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(rows.float().numpy(), want)
    cols = resize_cuda.resize_axis_torch(rows, 192, 1, torch.uint8)
    np.testing.assert_array_equal(
        cols.numpy(), np.asarray(jresize.resize_plane_pallas(jnp.asarray(x), 108, 192)))
    same = torch.from_numpy(x)
    assert torch.equal(resize_cuda.resize_plane_polyphase(same, 54, 96), same)
    with pytest.raises(ValueError, match="out_dtype"):
        resize_cuda.resize_axis_torch(same, 108, 0, torch.float32)


# one picture's planes (luma and two chroma), each to its own size
PICTURES = [
    ("yuv420p up", [(36, 64), (18, 32), (18, 32)], [(54, 96), (27, 48), (27, 48)]),
    ("yuv420p down", [(54, 96), (27, 48), (27, 48)], [(36, 64), (18, 32), (18, 32)]),
]


@pytest.mark.parametrize("what,src,dst", PICTURES, ids=[p[0] for p in PICTURES])
def test_picture_equals_plane_twin_and_pallas_interpret(what, src, dst):
    """``resize_picture_polyphase`` on the CPU: three planes of one picture,
    equal to the per-plane twin and to the JAX ``resize_plane_pallas`` in
    interpret mode, with no launch."""
    rng = np.random.default_rng(len(what))
    planes = [_u8(rng, s) for s in src]
    n = resize_cuda.resize_picture_polyphase.launches
    got = resize_cuda.resize_picture_polyphase([torch.from_numpy(x) for x in planes], dst)
    assert resize_cuda.resize_picture_polyphase.launches == n
    for x, (h, w), g in zip(planes, dst, got):
        assert g.dtype == torch.uint8 and tuple(g.shape) == (h, w)
        np.testing.assert_array_equal(
            g.numpy(), resize_cuda.resize_plane_polyphase(torch.from_numpy(x), h, w).numpy())
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jresize.resize_plane_pallas(jnp.asarray(x), h, w)))


def test_picture_unchanged_plane_and_one_axis():
    """A plane that keeps its size comes back as an equal copy; a plane
    with one resized axis runs that axis's pass alone (the twin's u8
    epilogue), as the JAX kernel does."""
    rng = np.random.default_rng(8)
    y, u, v = _u8(rng, (36, 64)), _u8(rng, (18, 32)), _u8(rng, (30, 48))
    ts = [torch.from_numpy(a) for a in (y, u, v)]
    got = resize_cuda.resize_picture_polyphase(ts, [(54, 64), (18, 32), (30, 72)])
    assert torch.equal(got[1], ts[1]) and got[1].data_ptr() != ts[1].data_ptr()
    for g, x, (h, w) in ((got[0], y, (54, 64)), (got[2], v, (30, 72))):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jresize.resize_plane_pallas(jnp.asarray(x), h, w)))
    # a strided plane is resized as its contiguous copy
    wide = torch.from_numpy(_u8(rng, (36, 128)))
    (got,) = resize_cuda.resize_picture_polyphase([wide[:, ::2]], [(54, 96)])
    assert torch.equal(got, resize_cuda.resize_plane_polyphase(wide[:, ::2].contiguous(), 54, 96))


def test_picture_wrapper_raises():
    y = torch.zeros((36, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="no polyphase plan"):
        resize_cuda.resize_picture_polyphase([y, torch.zeros((64, 1920), dtype=torch.uint8)],
                                             [(54, 96), (64, 352)])
    with pytest.raises(ValueError, match="1 to 3 planes"):
        resize_cuda.resize_picture_polyphase([y] * 4, [(54, 96)] * 4)
    with pytest.raises(ValueError, match="1 to 3 planes"):
        resize_cuda.resize_picture_polyphase([y, y], [(54, 96)])
    with pytest.raises(ValueError, match="2-D"):
        resize_cuda.resize_picture_polyphase([y[None]], [(54, 96)])
    with pytest.raises(ValueError, match="the others on cpu"):
        resize_cuda.resize_picture_polyphase([y, y.to("meta")], [(54, 96), (54, 96)])
    with pytest.raises(ValueError, match="unsupported device"):
        resize_cuda.resize_picture_polyphase([y.to("meta")], [(54, 96)])


def test_picture_table_windows_hold_every_tile():
    """The launch's plan: tiles per plane, and a staged window large enough
    for the tile that reads the most, as the kernel sizes it; the steepest
    ratio (2.75:1, 12 taps) needs more than 48 KB of shared memory."""
    geometry = ((720, 1280, 1080, 1920), (360, 640, 540, 960), (360, 640, 540, 960))
    table, firsts, window_bytes = resize_cuda._picture_table(geometry)
    assert table.shape == (3, resize_cuda.PLANE_WORDS) and table.dtype == np.int32
    assert firsts == (0, 34 * 15, 34 * 15 + 17 * 8, 34 * 15 + 2 * 17 * 8)
    assert list(table[0, :6]) == [720, 1280, 1080, 1920, 3, 15]
    assert window_bytes < 32 * 1024
    _, _, steep = resize_cuda._picture_table(((110, 330, 40, 120),))
    assert steep > 48 * 1024
    L, M, J, bases, W = resize_cuda._phase_plan(720, 1080)[:5]
    words = table[0, resize_cuda._HEADER:resize_cuda._HEADER + resize_cuda._AXIS_WORDS]
    count = words[16:32]
    offsets = words[32:32 + 192].reshape(16, 12)
    weights = words[32 + 192:].view(np.float32).reshape(16, 12)
    for p in range(L):
        nz = np.flatnonzero(W[p])
        assert count[p] == len(nz) and words[p] == bases[p]
        assert list(offsets[p, :len(nz)]) == list(nz)
        np.testing.assert_array_equal(weights[p, :len(nz)], W[p, nz])


def _f32_round(v: Fraction) -> float:
    """The f32 nearest to ``v``, ties to even, by exact comparison."""
    lo = np.float32(float(v))
    if Fraction(float(lo)) > v:
        lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    d_lo, d_hi = v - Fraction(float(lo)), Fraction(float(hi)) - v
    if d_lo != d_hi:
        return float(lo if d_lo < d_hi else hi)
    return float(lo if (np.float32(lo).view(np.uint32) & 1) == 0 else hi)


def test_twin_fused_step_rounds_once():
    """``_fma_f32`` is acc + prod with one rounding: on sums whose float64
    value falls on an f32 midpoint (where float64-then-f32 would round
    twice) and on random weights times u8 and bf16 inputs."""
    acc = [1.0, 1.0, -3.0, 200.0]
    prod = [2.0 ** -24 + 2.0 ** -60, 2.0 ** -24 - 2.0 ** -60, -(2.0 ** -23) - 2.0 ** -70, 0.0]
    rng = np.random.default_rng(4)
    w = rng.uniform(-0.2, 1.1, 400).astype(np.float32)
    xs = np.concatenate([rng.integers(0, 256, 200).astype(np.float32),
                         torch.from_numpy(rng.uniform(-40, 300, 200).astype(np.float32))
                         .to(torch.bfloat16).float().numpy()])
    a = rng.uniform(-300, 300, 400).astype(np.float32)
    acc += a.tolist()
    prod += (w.astype(np.float64) * xs.astype(np.float64)).tolist()  # exact
    got = resize_cuda._fma_f32(torch.tensor(acc, dtype=torch.float32),
                               torch.tensor(prod, dtype=torch.float64)).numpy()
    want = [_f32_round(Fraction(float(np.float32(x))) + Fraction(y)) for x, y in zip(acc, prod)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert got[0] == 1.0 + 2.0 ** -23 and got[1] == 1.0  # the two midpoint cases


# -- the integer-ratio upscale and the banded int8 products ----------------------------


@pytest.mark.parametrize("out_h,out_w", [(72, 104), (108, 156), (72, 52)])
def test_upscale_axis_matches_jax_and_dense(out_h, out_w):
    rng = np.random.default_rng(9)
    plane = _u8(rng, (36, 52))
    x, xj = torch.from_numpy(plane).float(), jnp.asarray(plane).astype(jnp.float32)
    if out_h != 36:
        x, xj = scale._upscale_axis(x, out_h, 0), jscale._upscale_axis(xj, out_h, axis=0)
    if out_w != 52:
        x, xj = scale._upscale_axis(x, out_w, 1), jscale._upscale_axis(xj, out_w, axis=1)
    got = torch.clamp(torch.round(x), 0, 255).to(torch.uint8).numpy()
    assert _lsb(got, np.clip(np.round(np.asarray(xj)), 0, 255)) <= 1
    dense = scale.resize_plane(torch.from_numpy(plane), out_h, out_w, method="f32").numpy()
    assert _lsb(got, dense) <= 1
    assert scale._phase_taps(36, 36) is None and scale._phase_taps(36, 54) is None


BANDED = [(540, 960, 1080, 1920), (353, 561, 700, 1120), (270, 480, 540, 960)]


@pytest.mark.parametrize("n_in,n_out", [(540, 1080), (960, 1920), (353, 700), (561, 1120),
                                        (270, 540), (1080, 350), (64, 64)])
def test_banded_blocks_equal_jax(n_in, n_out):
    got, want = scale._banded_blocks_i8(n_in, n_out), jscale._banded_blocks_i8(n_in, n_out)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[1:] == want[1:]
        assert got[0].dtype == np.int8
        np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(scale._resize_matrix_i8_from(scale.resize_matrix(n_in, n_out)),
                    jscale._resize_matrix_i8_from(jscale.resize_matrix(n_in, n_out))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", BANDED, ids=lambda c: "{}x{}-{}x{}".format(*c))
def test_banded_int8_bit_identical(monkeypatch, case):
    """``MIXLAB_RESIZE_BANDED=1`` in both packages: the port's banded int8
    equals its dense int8 and the JAX package's banded output."""
    ih, iw, oh, ow = case
    rng = np.random.default_rng(11 + ih)
    x = _u8(rng, (ih, iw))
    monkeypatch.setenv("MIXLAB_RESIZE_BANDED", "0")
    assert not scale._banded_enabled()
    dense = scale._resize_plane_int8(torch.from_numpy(x), oh, ow).numpy()
    monkeypatch.setenv("MIXLAB_RESIZE_BANDED", "1")
    assert scale._banded_enabled()
    banded = scale.resize_plane(torch.from_numpy(x), oh, ow, method="int8").numpy()
    np.testing.assert_array_equal(banded, dense)
    np.testing.assert_array_equal(banded, np.asarray(jscale._resize_plane_int8(jnp.asarray(x),
                                                                                 oh, ow)))
    assert (scale._banded_blocks_i8(ih, oh) is not None
            or scale._banded_blocks_i8(iw, ow) is not None)
    # one axis only: rows, then columns
    for h, w in ((oh, iw), (ih, ow)):
        np.testing.assert_array_equal(
            scale._resize_plane_int8(torch.from_numpy(x), h, w).numpy(),
            np.asarray(jscale._resize_plane_int8(jnp.asarray(x), h, w)))


# -- the folded composite -------------------------------------------------------------


@pytest.mark.parametrize("fade", [0, 67, 128, 255])
def test_fused_matches_jax(fade):
    rng = np.random.default_rng(5)
    plane = _u8(rng, (54, 96))
    t = torch.from_numpy(plane)
    for method, limit in (("f32", 1), ("int8", 0)):
        got = fused.resize_crossfade_roll(t, 108, 192, fade, method=method).numpy()
        want = np.asarray(jfused.resize_crossfade_roll(plane, 108, 192, fade, method=method))
        assert _lsb(got, want) <= limit, method
    np.testing.assert_array_equal(  # "auto" is "f32"
        fused.resize_crossfade_roll(t, 108, 192, fade).numpy(),
        fused.resize_crossfade_roll(t, 108, 192, fade, method="f32").numpy())
    # rows only, int8 (the single-pass epilogue)
    np.testing.assert_array_equal(
        fused.resize_crossfade_roll(t, 108, 96, fade, method="int8").numpy(),
        np.asarray(jfused.resize_crossfade_roll(plane, 108, 96, fade, method="int8")))
    with pytest.raises(ValueError, match="fade"):
        fused.resize_crossfade_roll(t, 108, 192, 256)


def _sequential(plane: torch.Tensor, fade: int) -> np.ndarray:
    y = scale.resize_plane(plane, 108, 192, method="f32")
    return blend.crossfade_torch(y, torch.roll(y, 1, dims=0), fade).numpy()


@pytest.mark.parametrize("fade", [0, 67, 128, 255])
def test_fused_within_bounds_of_sequential(fade):
    """tests/test_video.py:259-296's bounds for the port's own pipelines:
    2 LSB off the overshoot pixels, 48 everywhere, 6 for int8."""
    rng = np.random.default_rng(5)
    plane = _u8(rng, (54, 96))
    Wh = scale.resize_matrix(54, 108).astype(np.float64)
    Ww = scale.resize_matrix(96, 192).astype(np.float64)
    ref = Wh @ plane.astype(np.float64) @ Ww.T
    overshoot = (ref < 0.5) | (ref > 254.5)
    overshoot = overshoot | np.roll(overshoot, 1, axis=0)
    t = torch.from_numpy(plane)
    seq = _sequential(t, fade).astype(int)
    err = np.abs(seq - fused.resize_crossfade_roll(t, 108, 192, fade, method="f32").numpy())
    assert err[~overshoot].max() <= 2 and err.max() <= 48
    err8 = np.abs(seq - fused.resize_crossfade_roll(t, 108, 192, fade, method="int8").numpy())
    assert err8[~overshoot].max() <= 6


def test_fused_tight_on_smooth_content_and_pure_at_the_ends():
    """tests/test_video.py:298-334: on a gradient the fold is within 2 LSB
    of the sequential pipeline everywhere; fade 255 is the plain resize and
    fade 0 its roll."""
    y, _, _ = colorspace.rgb_to_yuv420(pattern.gradient_rgb(96, 54, t=3, device="cpu"))
    yj, _, _ = jcs.rgb_to_yuv420(jpattern.gradient_rgb(96, 54, t=3))
    assert _lsb(y.numpy(), yj) <= 1  # the same content as the JAX test's
    for fade in (40, 128, 220):
        err = _lsb(_sequential(y, fade), fused.resize_crossfade_roll(y, 108, 192, fade).numpy())
        assert err <= 2, fade
    rng = np.random.default_rng(6)
    plane = torch.from_numpy(_u8(rng, (32, 64)))
    plain = scale.resize_plane(plane, 64, 128, method="f32")
    assert torch.equal(fused.resize_crossfade_roll(plane, 64, 128, 255, method="f32"), plain)
    assert torch.equal(fused.resize_crossfade_roll(plane, 64, 128, 0, method="f32"),
                       torch.roll(plain, 1, dims=0))


# -- the host scale --------------------------------------------------------------------


def test_resize_plane_host_equals_jax_numpy_path(monkeypatch):
    """The JAX package's numpy path and the port's, each with its C++ twin
    switched off (the port's is its first choice since it was ported;
    ``tests/test_torch_alsa_out.py`` holds the two C++ twins to each
    other), on the same weights: exact."""
    from mixlab_tpu import native
    from mixlab_tpu_torch import native as tnative

    monkeypatch.setattr(native, "scale_plane_banded", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    rng = np.random.default_rng(3)
    for (h, w), (oh, ow) in (((200, 320), (700, 1120)), ((72, 128), (54, 96)),
                             ((36, 52), (36, 104))):
        plane = _u8(rng, (h, w))
        np.testing.assert_array_equal(scale_host.resize_plane_host(plane, oh, ow),
                                      jscale_host.resize_plane_host(plane, oh, ow))
        for got, want in zip(scale_host.banded_weights(h, oh), jscale_host.banded_weights(h, oh)):
            np.testing.assert_array_equal(got, want)
    same = _u8(rng, (8, 8))
    assert scale_host.resize_plane_host(same, 8, 8) is not None


@pytest.mark.parametrize("w,h", [(1280, 720), (320, 200), (640, 480)])
def test_scale_picture_host_matches_device_scaler(w, h):
    """tests/test_video.py:420-444: within 3 LSB of the port's dense
    ``scale_picture`` with the same letterbox; numpy or tensor planes."""
    rng = np.random.default_rng(w)
    planes = {"y": _u8(rng, (h, w)), "u": _u8(rng, (h // 2, w // 2)),
              "v": _u8(rng, (h // 2, w // 2))}
    out = frame.PictureSettings(1120, 700)
    pic = frame.Picture(frame.PictureSettings(w, h), {k: torch.from_numpy(v) for k, v in
                                                      planes.items()})
    a = scale.scale_picture(pic, out)
    b = scale_host.scale_picture_host(pic, out)
    c = scale_host.scale_picture_host(frame.Picture(frame.PictureSettings(w, h), planes), out)
    assert b.settings == out
    for k in planes:
        assert isinstance(b.planes[k], np.ndarray) and b.planes[k].shape == tuple(a.planes[k].shape)
        assert _lsb(a.planes[k].numpy(), b.planes[k]) <= 3, k
        np.testing.assert_array_equal(b.planes[k], c.planes[k])
    assert scale_host.scale_picture_host(pic, pic.settings) is pic
