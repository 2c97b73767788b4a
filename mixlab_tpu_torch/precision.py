"""IEEE f32 matrix products and convolutions, whatever the process's
precision flags.

The JAX package pins ``Precision.HIGHEST`` at each f32 product
(``mixlab_tpu/dsp/eq_three.py:116``).  PyTorch has no per-call precision:
the product reads process-wide flags, which any code in the process may set
and which the realtime engine's tick and feeder threads share.  So the port
does not flip them; each f32 product it runs calls ``require_ieee_f32``
first, which raises while the flags of the tensor's backend ask for less
than IEEE f32: TF32 for cuBLAS on the card, bf16 (or TF32) for oneDNN on the
CPU.  The flags that concern only the card (``allow_tf32``,
``torch.backends.cuda.matmul.fp32_precision``) leave CPU tensors alone;
``torch.set_float32_matmul_precision("high")`` and ``"medium"`` reach both
backends (on a CPU with bf16 instructions ``"medium"`` changes the CPU's
products too).

Convolutions (the resampler's strided ``conv1d``, ``dsp/resampler.py``) read
flags of their own: cuDNN's on the card, where ``torch.backends.cudnn.allow_tf32``
is True by default, and oneDNN's on the CPU.  ``require_ieee_f32(t, what,
conv=True)`` checks those.
"""

from __future__ import annotations

from typing import Optional

import torch

_REDUCED = ("tf32", "bf16")


def reduced_precision_setting(device_type: str) -> Optional[str]:
    """The setting, as read, under which PyTorch may run an f32 matrix
    product on a ``device_type`` ("cuda" or "cpu") tensor in less than IEEE
    f32; ``None`` when none does."""
    name = "cuda" if device_type == "cuda" else "mkldnn"
    backend = getattr(torch.backends, name)
    op = getattr(getattr(backend, "matmul", None), "fp32_precision", None)
    if op is not None:  # PyTorch 2.9 and later: the first value not "none" decides
        for setting, value in ((f"torch.backends.{name}.matmul.fp32_precision", op),
                               (f"torch.backends.{name}.fp32_precision",
                                getattr(backend, "fp32_precision", "none")),
                               ("torch.backends.fp32_precision", torch.backends.fp32_precision)):
            if value != "none":
                return f'{setting} is "{value}"' if value in _REDUCED else None
        return None
    if device_type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        return "torch.backends.cuda.matmul.allow_tf32 is True"
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        return f'torch.get_float32_matmul_precision() is "{precision}"'
    return None


def reduced_conv_setting(device_type: str) -> Optional[str]:
    """The setting under which PyTorch may run an f32 convolution on a
    ``device_type`` tensor in less than IEEE f32 (cuDNN on "cuda", oneDNN on
    "cpu"); ``None`` when none does."""
    name = "cudnn" if device_type == "cuda" else "mkldnn"
    backend = getattr(torch.backends, name)
    op = getattr(getattr(backend, "conv", None), "fp32_precision", None)
    if op is not None:  # PyTorch 2.9 and later: the first value not "none" decides
        for setting, value in ((f"torch.backends.{name}.conv.fp32_precision", op),
                               (f"torch.backends.{name}.fp32_precision",
                                getattr(backend, "fp32_precision", "none")),
                               ("torch.backends.fp32_precision", torch.backends.fp32_precision)):
            if value != "none":
                return f'{setting} is "{value}"' if value in _REDUCED else None
        return None
    if device_type == "cuda" and torch.backends.cudnn.allow_tf32:
        return "torch.backends.cudnn.allow_tf32 is True"
    return None


def require_ieee_f32(t: torch.Tensor, what: str, conv: bool = False) -> None:
    """Raise ``RuntimeError`` naming the setting if an f32 product on ``t``
    (a convolution if ``conv``) could run in less than IEEE f32."""
    if conv:
        setting = reduced_conv_setting(t.device.type)
        if setting is not None:
            raise RuntimeError(
                f"{what}: f32 convolutions must be IEEE f32, as the reference's "
                f"Precision.HIGHEST, but {setting}; switch it off "
                "(torch.backends.cudnn.allow_tf32 = False)")
        return
    setting = reduced_precision_setting(t.device.type)
    if setting is not None:
        raise RuntimeError(
            f"{what}: f32 matrix products must be IEEE f32, as the reference's "
            f"Precision.HIGHEST, but {setting}; switch it off "
            f'(torch.set_float32_matmul_precision("highest"))')


def switch_tf32_off() -> None:
    """Set the process's f32 matrix products, on the card and the CPU, and
    cuDNN's f32 convolutions to IEEE f32: for an entry point that owns its
    process (``render_cli``, the profiling tool), never for library code."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
