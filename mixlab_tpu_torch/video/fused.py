"""Fused composite operator: the row-roll and crossfade folded into the
resize (port of ``mixlab_tpu/video/fused.py``).

The row-roll is a cyclic permutation matrix R, the crossfade a scalar
convex combination and the resize a matrix product, all linear in the
source plane, so

    crossfade(resize(x), roll(resize(x), 1), fade)
      = ((fade * Wh + (255-fade) * roll(Wh, 1, axis=0)) / 255) @ x @ Ww

is ONE resize through a pre-blended row matrix.  It rides the same products
as the plain resize (``video/scale.py``: f32, or the exact int8 path).

Semantics (a documented deviation, bounded in the tests): the exact
pipeline rounds and clips the resized plane to u8 BEFORE the integer
crossfade (src/module/video_mixer.rs:210-235); the fold blends the
unrounded values and rounds once.  Where the bicubic resize does not
overshoot [0, 255] the two differ by at most ~1 LSB plus the resize's own
envelope; at overshoot pixels by up to the overshoot.  So the engine's
exact u8 blend (``video/blend.py``) stays the module path; the JAX package
measured the fold performance-neutral on its TPU and keeps it as an opt-in
of its composite benchmark.

``"auto"`` is ``"f32"`` on every device, as in ``video/scale.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mixlab_tpu_torch.precision import require_ieee_f32
from mixlab_tpu_torch.video.scale import (
    METHODS,
    _device_table,
    _resize_matrix_i8,
    _resize_matrix_i8_from,
    int_matmul,
    resize_matrix,
)


@functools.lru_cache(maxsize=64)
def _blended_row_matrix(in_h: int, out_h: int, fade: int) -> np.ndarray:
    Wh = resize_matrix(in_h, out_h).astype(np.float64)
    f = fade / 255.0
    Wb = f * Wh + (1.0 - f) * np.roll(Wh, 1, axis=0)
    return Wb.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_rows(kind: str, in_h: int, out_h: int, fade: int, device: torch.device):
    """The blended row matrix on ``device``, uploaded once: ``"f32"`` as it
    is, ``"i8"`` quantized."""
    Wb = _blended_row_matrix(in_h, out_h, fade)
    return torch.from_numpy(Wb if kind == "f32" else _resize_matrix_i8_from(Wb)[0]).to(device)


def resize_crossfade_roll(plane: torch.Tensor, out_h: int, out_w: int, fade: int,
                          method: str = "auto") -> torch.Tensor:
    """resize + roll(1 row) + crossfade(fade) in ONE pass, on the plane's
    device.  Equivalent (within the tolerance documented above) to::

        y = resize_plane(plane, out_h, out_w)
        out = crossfade_torch(y, torch.roll(y, 1, dims=0), fade)

    ``fade``: int 0..255 (folded into the weights)."""
    fade = int(fade)
    if not 0 <= fade <= 255:
        raise ValueError(f"fade out of range: {fade}")
    if method not in METHODS:
        raise ValueError(f"resize method {method!r}: use one of {METHODS}")
    in_h, in_w = plane.shape
    if method == "int8":
        return _resize_int8_with_rows(plane, _blended_row_matrix(in_h, out_h, fade), fade,
                                      out_w)
    dev = plane.device
    require_ieee_f32(plane, "resize_crossfade_roll (f32)")
    x = _device_rows("f32", in_h, out_h, fade, dev) @ plane.to(torch.float32)
    if in_w != out_w:
        x = x @ _device_table("f32", in_w, out_w, dev).t()
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _resize_int8_with_rows(plane: torch.Tensor, W_rows: np.ndarray, fade: int,
                           out_w: int) -> torch.Tensor:
    """The exact int8 two-pass resize of ``video/scale.py`` with the
    pre-blended row matrix ``W_rows`` (of ``fade``) in place of the plain
    one."""
    in_h, in_w = plane.shape
    out_h = W_rows.shape[0]
    dev = plane.device
    xc = (plane.to(torch.int16) - 128).to(torch.int8)
    _, dq, off, bound = _resize_matrix_i8_from(W_rows)
    acc = int_matmul(_device_rows("i8", in_h, out_h, fade, dev), xc)
    y = (acc.to(torch.float32) * torch.from_numpy(dq[:, None]).to(dev)
         + torch.from_numpy(off[:, None] - np.float32(128.0)).to(dev))
    if in_w == out_w:
        return torch.clamp(torch.round(y) + 128.0, 0, 255).to(torch.uint8)
    mid_scale = 127.0 / bound
    xc2 = torch.clamp(torch.round(y * float(np.float32(mid_scale))), -127, 127).to(torch.int8)
    _, dq2, off2, _ = _resize_matrix_i8(in_w, out_w)
    acc2 = int_matmul(xc2, _device_table("i8", in_w, out_w, dev).t())
    y2 = (acc2.to(torch.float32) * torch.from_numpy(dq2[None, :] / np.float32(mid_scale)).to(dev)
          + torch.from_numpy(off2[None, :]).to(dev))
    return torch.clamp(torch.round(y2), 0, 255).to(torch.uint8)
