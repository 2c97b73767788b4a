"""The port's precision guard (``mixlab_tpu_torch/precision.py``) on the
CPU: each way of asking for TF32 or bf16 products is named for the backend
it reaches, a product on a CPU tensor ignores the flags that reach only the
card and refuses those that reach the CPU, and ``switch_tf32_off`` clears
them all.  The card-only half is in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_torch
from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff
from mixlab_tpu_torch.precision import (
    reduced_precision_setting,
    require_ieee_f32,
    switch_tf32_off,
)
from mixlab_tpu_torch.video.fused import resize_crossfade_roll
from mixlab_tpu_torch.video.scale import resize_plane


def _set(obj, attr, value):
    if not hasattr(obj, attr):
        pytest.skip(f"this PyTorch has no {attr}")
    setattr(obj, attr, value)


def _fresh_then_global():
    """``torch.backends.fp32_precision = "tf32"`` in a process that set no
    backend's own precision."""
    _set(torch.backends.cuda.matmul, "fp32_precision", "none")
    _set(torch.backends.mkldnn.matmul, "fp32_precision", "none")
    torch.backends.fp32_precision = "tf32"


# each way a host process may ask for reduced f32 products:
# name -> (the code that sets it, reaches the card, reaches the CPU)
SWITCHES = {
    "allow_tf32": (lambda: _set(torch.backends.cuda.matmul, "allow_tf32", True), True, False),
    "cuda_fp32_precision": (
        lambda: _set(torch.backends.cuda.matmul, "fp32_precision", "tf32"), True, False),
    "matmul_precision_high": (lambda: torch.set_float32_matmul_precision("high"), True, True),
    "matmul_precision_medium": (lambda: torch.set_float32_matmul_precision("medium"), True,
                                True),
    "global_fp32_precision": (_fresh_then_global, True, True),
    "mkldnn_fp32_precision": (
        lambda: _set(torch.backends.mkldnn.matmul, "fp32_precision", "bf16"), False, True),
}


@pytest.fixture
def flags():
    """Start from IEEE products; restore the process's flags after the test."""
    saved = {(obj, attr): getattr(obj, attr) for obj, attr in (
        (torch.backends.cuda.matmul, "fp32_precision"),
        (torch.backends.mkldnn.matmul, "fp32_precision"),
        (torch.backends, "fp32_precision")) if hasattr(obj, attr)}
    precision = torch.get_float32_matmul_precision()
    switch_tf32_off()
    yield
    torch.set_float32_matmul_precision(precision)
    for (obj, attr), value in saved.items():
        setattr(obj, attr, value)


def _eq_block():
    rng = np.random.default_rng(735)
    x = torch.from_numpy(rng.uniform(-1, 1, 735).astype(np.float32))
    xd = torch.cat([torch.zeros(3), x])[:735]
    poles = torch.from_numpy(rng.uniform(-0.1, 0.1, (4, 2)).astype(np.float32))
    gains = torch.tensor([1.6, 0.8, 1.4])
    return eq_cascade_torch(x, xd, poles, gains, _filter_coeff(FREQ_LO, 44_100),
                            _filter_coeff(FREQ_HI, 44_100), VSA)


def _products(plane):
    """EqThree on a 735-sample block (its Toeplitz products), the f32
    resize and the f32 fold of a plane, all on the CPU."""
    return [*_eq_block(), resize_plane(plane, 108, 192, "f32"),
            resize_crossfade_roll(plane, 108, 192, 128, "f32")]


def test_default_flags_are_ieee(flags):
    assert reduced_precision_setting("cuda") is None
    assert reduced_precision_setting("cpu") is None
    require_ieee_f32(torch.zeros(1), "cpu")


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_each_switch_is_named_for_its_backends_and_cleared(flags, switch):
    set_it, card, cpu = SWITCHES[switch]
    set_it()
    for device_type, reached in (("cuda", card), ("cpu", cpu)):
        setting = reduced_precision_setting(device_type)
        assert (setting is not None) == reached, (device_type, setting)
        if reached:
            assert setting.startswith("torch.") and ("tf32" in setting or "bf16" in setting
                                                     or "precision" in setting)
    switch_tf32_off()
    assert reduced_precision_setting("cuda") is None
    assert reduced_precision_setting("cpu") is None


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_cpu_products_under_each_switch(flags, switch):
    """Under a switch that reaches only the card, the CPU products run and
    equal their IEEE result bit for bit; under one that reaches the CPU,
    each raises a RuntimeError naming the setting."""
    rng = np.random.default_rng(9)
    plane = torch.from_numpy(rng.integers(0, 256, (72, 128), dtype=np.uint8))
    want = _products(plane)
    set_it, _, cpu = SWITCHES[switch]
    set_it()
    if cpu:
        setting = reduced_precision_setting("cpu")
        for run in (_eq_block, lambda: resize_plane(plane, 108, 192, "f32"),
                    lambda: resize_crossfade_roll(plane, 108, 192, 128, "f32")):
            with pytest.raises(RuntimeError, match="IEEE f32") as err:
                run()
            assert setting in str(err.value)
    else:
        for g, w in zip(_products(plane), want):
            assert torch.equal(g, w)
    assert torch.equal(resize_plane(plane, 108, 192, "int8"),
                       resize_plane(plane, 108, 192, "int8"))  # integer products run
