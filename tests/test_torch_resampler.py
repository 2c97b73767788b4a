"""The port's polyphase resampler (``mixlab_tpu_torch/dsp/resampler.py``)
against the JAX package's on the CPU: the filter design bit for bit, the
strided-conv block over carried blocks (mono and stereo) against JAX's conv
and against ``resample_block_np``, the tone test of
``tests/test_dsp_kernels.py``, and the precision guard refusing TF32 and
bf16 convolution settings."""

import math

import numpy as np
import pytest
import torch

from mixlab_tpu.dsp import resampler as jr
from mixlab_tpu_torch.dsp import resampler as tr
from mixlab_tpu_torch.precision import reduced_conv_setting

ATOL = 1e-6
RATES = [(44_100, 48_000), (48_000, 44_100), (32_000, 48_000)]


@pytest.mark.parametrize("src,dst", RATES)
def test_design_equals_jax(src, dst):
    L, M, W2 = tr.design(src, dst)
    Lj, Mj, W2j = jr.design(src, dst)
    assert (L, M) == (Lj, Mj) and W2.dtype == np.float32
    assert np.array_equal(W2, np.asarray(W2j))
    assert tr.context_len(src, dst) == jr.context_len(src, dst) == 31


@pytest.mark.parametrize("channels", [None, 2])
@pytest.mark.parametrize("src,dst", RATES)
def test_resample_block_matches_jax_over_carried_blocks(src, dst, channels):
    L, M, _ = tr.design(src, dst)
    rng = np.random.default_rng(src + dst + (channels or 0))
    shape = lambda n: (n,) if channels is None else (n, channels)
    S_in = M * 8
    ctx = np.zeros(shape(31), np.float32)
    ctx_j, ctx_np = ctx, ctx
    ctx_t = torch.from_numpy(ctx)
    for _ in range(3):
        x = rng.uniform(-1, 1, shape(S_in)).astype(np.float32)
        y, ctx_t = tr.resample_block(torch.from_numpy(x), ctx_t, src, dst)
        yj, ctx_j = jr.resample_block(x, ctx_j, src, dst)
        yn, ctx_np = jr.resample_block_np(x, ctx_np, src, dst)
        assert tuple(y.shape) == shape(S_in * L // M)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        np.testing.assert_allclose(y.numpy(), yn, rtol=0, atol=ATOL)
        assert np.array_equal(ctx_t.numpy(), np.asarray(ctx_j))


@pytest.mark.parametrize("src,dst", RATES)
def test_numpy_twin_equals_jax_numpy_twin(src, dst):
    L, M, _ = tr.design(src, dst)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (M * 5, 2)).astype(np.float32)
    ctx = rng.uniform(-1, 1, (31, 2)).astype(np.float32)
    y, c = tr.resample_block_np(x, ctx, src, dst)
    yj, cj = jr.resample_block_np(x, ctx, src, dst)
    assert np.array_equal(y, yj) and np.array_equal(c, cj)


def test_resampler_tone():
    """tests/test_dsp_kernels.py:149 through the port."""
    src, dst = 44_100, 48_000
    n_in = 735 * 40
    x = np.sin(2 * np.pi * 1000.0 * np.arange(n_in) / src).astype(np.float32)
    y, _ = tr.resample_block(torch.from_numpy(x), torch.zeros(tr.context_len(src, dst)), src, dst)
    assert y.shape[0] == 800 * 40
    L = dst // math.gcd(src, dst)
    delay = (32 * L - 1) / 2 / (src * L)
    want = np.sin(2 * np.pi * 1000.0 * (np.arange(y.shape[0]) / dst - delay))
    seg = slice(2000, y.shape[0] - 2000)
    assert np.abs(y.numpy()[seg] - want[seg]).max() < 1e-3


def test_refuses_a_block_that_is_not_a_multiple_of_m():
    with pytest.raises(ValueError, match="multiple of 147"):
        tr.resample_block(torch.zeros(100), torch.zeros(31), 44_100, 48_000)


def _conv_flags():
    """Every convolution precision flag that a test may set, to restore."""
    out = {(torch.backends.cudnn, "allow_tf32"): torch.backends.cudnn.allow_tf32}
    for obj in (getattr(torch.backends.cudnn, "conv", None),
                getattr(torch.backends.mkldnn, "conv", None), torch.backends.cudnn,
                torch.backends.mkldnn, torch.backends):
        if obj is not None and hasattr(obj, "fp32_precision"):
            out[(obj, "fp32_precision")] = obj.fp32_precision
    return out


@pytest.fixture
def conv_flags():
    saved = _conv_flags()
    yield
    for (obj, attr), value in saved.items():
        setattr(obj, attr, value)


def test_guard_refuses_tf32_on_the_card_and_bf16_on_the_cpu(conv_flags):
    """cuDNN's TF32 (True by default) is named for the card and leaves the
    CPU's conv alone; oneDNN's bf16 is named for the CPU and refused."""
    x, ctx = torch.ones(147 * 2), torch.zeros(31)
    torch.backends.cudnn.allow_tf32 = True
    assert reduced_conv_setting("cuda") is not None
    want, _ = tr.resample_block(x, ctx, 44_100, 48_000)
    torch.backends.cudnn.allow_tf32 = False
    assert reduced_conv_setting("cuda") is None
    conv = getattr(torch.backends.mkldnn, "conv", None)
    if conv is None or not hasattr(conv, "fp32_precision"):
        pytest.skip("this PyTorch has no torch.backends.mkldnn.conv.fp32_precision")
    conv.fp32_precision = "bf16"
    setting = reduced_conv_setting("cpu")
    assert setting and "bf16" in setting
    with pytest.raises(RuntimeError, match="IEEE f32") as err:
        tr.resample_block(x, ctx, 44_100, 48_000)
    assert setting in str(err.value)
    conv.fp32_precision = "ieee"
    got, _ = tr.resample_block(x, ctx, 44_100, 48_000)
    assert torch.equal(got, want)
