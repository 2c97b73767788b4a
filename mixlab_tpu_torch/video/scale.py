"""Separable bicubic rescale as two dense matrix products + letterbox compose
(port of ``mixlab_tpu/video/scale.py``).

Reference: ``DynamicScaler`` (``src/video/encode.rs:310-398``) wraps
swscale's BICUBIC with aspect-preserving letterbox into a chroma-aligned
subframe.  As in the JAX package, the resample is a Mitchell–Netravali
bicubic (B=0, C=0.6) written as a dense separable product

    out = clip(round(W_h @ in @ W_w^T))

with W_h [H_out, H_in] and W_w [W_out, W_in] built on the host in float64 by
this module's copy of the JAX package's table code (``_mitchell``,
``resize_matrix``: the tables are bit-identical), cached per (in, out) size
pair and kept on the device per device.

Two methods:
  * ``"f32"``: two f32 matrix products (``torch.matmul``; they raise while
    the process asks for TF32 on the card or bf16 on the CPU,
    ``precision.require_ieee_f32``, so they are IEEE f32 or refused).  The JAX package leaves these products to
    XLA outside any Pallas kernel.
  * ``"int8"``: the JAX package's quantized path (``scale.py:237-263``): the
    centered plane and per-row-scaled int8 tables in an exact integer
    product (int32 on the CPU, ``torch._int_mm`` on the card, the
    contraction and output widths zero-padded to the multiples of 8 that
    ``_int_mm`` demands — the padding adds exact zeros), then the same f32
    epilogue in the same order.  With ``MIXLAB_RESIZE_BANDED=1`` (off by
    default, a measured negative result in the JAX package) each product
    runs block-banded (``_banded_blocks_i8``): one exact integer product per
    output block against its input window, bit-identical to the dense one.
``"auto"`` is ``"f32"`` on every device (the JAX package's int8 default is
for the TPU's double-rate s8 MXU; on the card int8 measured 3.6-3.9x slower
than f32 per 720p→1080p picture, PERF.md).

Also here, as in the JAX package: the polyphase integer-ratio upscale
``_upscale_axis`` (shifted multiply-adds, no product).  The polyphase resize
through a hand-written kernel is ``video/resize_cuda.py``.

Letterbox geometry matches encode.rs:354-396: integer scale ratio
min(w_ratio, h_ratio) (exact rational compare), chroma-aligned scaled size
and offsets, surrounding pixels black/0x80.
"""

from __future__ import annotations

import functools
import os
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from mixlab_tpu_torch.precision import require_ieee_f32
from mixlab_tpu_torch.video.frame import YUV420P, Picture, PictureSettings

METHODS = ("auto", "f32", "int8")


def _mitchell(x: np.ndarray, B: float = 0.0, C: float = 0.6) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax < 1.0,
        ((12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2 + (6 - 2 * B)) / 6.0,
        np.where(
            ax < 2.0,
            ((-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2 + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6.0,
            0.0,
        ),
    )
    return w


@functools.lru_cache(maxsize=256)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 bicubic resample matrix (edge-clamped, rows
    normalized to sum 1)."""
    scale = n_in / n_out
    # source center positions for each output pixel
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    # widen the kernel when minifying (standard anti-aliased resample)
    support = 2.0 * max(scale, 1.0)
    kscale = min(1.0, 1.0 / scale) if scale > 1.0 else 1.0
    W = np.zeros((n_out, n_in), dtype=np.float64)
    for o in range(n_out):
        lo = int(np.floor(pos[o] - support)) + 1
        hi = int(np.ceil(pos[o] + support))
        idx = np.arange(lo, hi + 1)
        w = _mitchell((idx - pos[o]) * kscale)
        cidx = np.clip(idx, 0, n_in - 1)
        for i, wi in zip(cidx, w):
            W[o, i] += wi
    W /= W.sum(axis=1, keepdims=True)
    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _phase_taps(n_in: int, n_out: int):
    """For exact integer upscales (n_out = r*n_in) the dense resize matrix is
    r shifted copies of per-phase tap vectors.  Returns (r, lo, taps[r, J])
    or None when not an integer upscale.  Edge clamping in the dense matrix
    equals replicate padding here, so results match."""
    if n_out % n_in != 0 or n_out == n_in:
        return None
    r = n_out // n_in
    scale = n_in / n_out
    pos0 = (np.arange(r, dtype=np.float64) + 0.5) * scale - 0.5  # phase offsets
    lo = int(np.floor(pos0.min())) - 1
    hi = int(np.ceil(pos0.max())) + 2
    offsets = np.arange(lo, hi + 1)
    taps = _mitchell(offsets[None, :] - pos0[:, None])
    taps /= taps.sum(axis=1, keepdims=True)
    return r, lo, taps.astype(np.float32)


def _upscale_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """Polyphase integer-ratio upscale of an f32 tensor along ``axis``: per
    phase, J shifted multiply-adds in f32 in the JAX package's order (edge
    rows repeated past the ends), the phases interleaved."""
    n_in = x.shape[axis]
    r, lo, taps = _phase_taps(n_in, n_out)
    J = taps.shape[1]
    src = torch.arange(n_in, device=x.device)
    phases = []
    for p in range(r):
        acc = None
        for j in range(J):
            rows = x.index_select(axis, torch.clamp(src + (lo + j), 0, n_in - 1))
            term = float(taps[p, j]) * rows
            acc = term if acc is None else acc + term
        phases.append(acc)
    stacked = torch.stack(phases, dim=axis + 1)  # n_in then r on that axis
    new_shape = list(x.shape)
    new_shape[axis] = n_out
    return stacked.reshape(new_shape)


@functools.lru_cache(maxsize=256)
def _resize_matrix_i8(n_in: int, n_out: int):
    """int8 quantization of the bicubic resample matrix with per-row scales:
    (Wq int8 [n_out, n_in], dequant f32 [n_out], offset f32 [n_out], bound)
    such that W @ x ≈ (Wq @ (x - 128)) * dequant + offset."""
    return _resize_matrix_i8_from(resize_matrix(n_in, n_out))


def _resize_matrix_i8_from(W: np.ndarray):
    """Quantize any resample-style matrix (rows summing ~1) for the exact
    int8 path; also used for the folded matrices of ``video/fused.py``."""
    W = np.asarray(W, dtype=np.float64)
    s = 127.0 / np.maximum(np.abs(W).max(axis=1, keepdims=True), 1e-12)
    Wq = np.clip(np.round(W * s), -127, 127).astype(np.int8)
    dequant = (1.0 / s[:, 0]).astype(np.float32)
    # exact center restore: W @ x = W @ (x-128) + 128 * rowsum(W); use the
    # QUANTIZED row sums so the +128 path carries no quantization error
    rowsum_q = Wq.astype(np.float64).sum(axis=1) / s[:, 0]
    offset = (128.0 * rowsum_q).astype(np.float32)
    # exact output bound for a centered input (|x-128| <= 128): bicubic
    # overshoot makes |W @ (x-128)| exceed 128, so the separable-pass
    # intermediate must be RANGE-SCALED into int8, never clipped
    bound = float(128.0 * np.abs(W).sum(axis=1).max())
    return Wq, dequant, offset, bound


@functools.lru_cache(maxsize=256)
def _banded_blocks_i8(n_in: int, n_out: int, block: int = 0):
    """Block-banded form of the quantized resize matrix (the JAX package's
    ``_banded_blocks_i8``): an output block of ``block`` rows reads only a
    window of K inputs, and the window's zero columns add exact zeros, so
    the banded products are bit-identical to the dense one.

    Returns (Wb int8 [nb, block, K], starts tuple, K) or None when the band
    is too wide to save meaningful work (e.g. heavy minification)."""
    Wq, _, _, _ = _resize_matrix_i8(n_in, n_out)
    if block == 0:  # small outputs waste less on last-block padding at 128
        block = 256 if n_out >= 1024 else 128
    nb = -(-n_out // block)
    starts = []
    K = 0
    for b in range(nb):
        rows = Wq[b * block : min((b + 1) * block, n_out)]
        nz = np.nonzero((rows != 0).any(axis=0))[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1)
        starts.append(lo)
        K = max(K, hi - lo)
    K = min(n_in, -(-K // 8) * 8)  # a multiple of 8, as the int8 product wants
    if nb * block * K >= 0.6 * n_out * n_in:
        return None  # band too wide: dense is at least as good
    starts = [min(s, n_in - K) for s in starts]
    Wb = np.zeros((nb, block, K), np.int8)
    for b, s in enumerate(starts):
        rows = Wq[b * block : min((b + 1) * block, n_out)]
        Wb[b, : rows.shape[0]] = rows[:, s : s + K]
    return Wb, tuple(starts), K


def _banded_enabled() -> bool:
    # default OFF, as in the JAX package (measured 6x slower than dense on
    # its TPU); opt-in for re-measurement
    return os.environ.get("MIXLAB_RESIZE_BANDED", "0") == "1"


@functools.lru_cache(maxsize=64)
def _device_table(kind: str, n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """One (in, out) pair's table on ``device``, uploaded once: ``"f32"`` the
    resample matrix W, ``"i8"`` its quantization Wq, both [n_out, n_in]
    (the column pass multiplies by the transposed view), ``"i8_banded"``
    the banded blocks Wb [nb, block, K]."""
    if kind == "f32":
        W = resize_matrix(n_in, n_out)
    elif kind == "i8":
        W = _resize_matrix_i8(n_in, n_out)[0]
    else:
        W = _banded_blocks_i8(n_in, n_out)[0]
    return torch.from_numpy(W).to(device)


def _pad_to(x: torch.Tensor, dim: int, multiple: int, minimum: int = 0) -> torch.Tensor:
    n = x.shape[dim]
    want = max(-(-n // multiple) * multiple, minimum)
    if want == n:
        return x
    shape = list(x.shape)
    shape[dim] = want - n
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] -> int32 [M, N].

    CPU: an int32 product.  CUDA: ``torch._int_mm``, which needs M > 16, K
    and N multiples of 8, ``a`` row-major and ``b`` column-major: rows, the
    contraction and columns are zero-padded there (exact) and the result
    cut back."""
    M, N = a.shape[0], b.shape[1]
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    a = _pad_to(_pad_to(a, 1, 8), 0, 1, minimum=17).contiguous()
    b = _pad_to(_pad_to(b, 0, 8), 1, 8)
    return torch._int_mm(a, b.t().contiguous().t())[:M, :N]


def _int8_rows_matmul(xc: torch.Tensor, n_out: int) -> torch.Tensor:
    """Row-pass accumulator [n_out, W] int32 of the centered int8 plane:
    banded when enabled and profitable.  The banded form is one exact
    ``int_matmul`` per output block against its window: ``torch._int_mm``
    is 2-D only and the card has no integer batched product, and a loop of
    exact integer products stays bit-identical to the dense one at any
    window width (an f32 batched product would be exact only while every
    sum stays under 2^24)."""
    n_in = xc.shape[0]
    banded = _banded_blocks_i8(n_in, n_out) if _banded_enabled() else None
    if banded is None:
        return int_matmul(_device_table("i8", n_in, n_out, xc.device), xc)
    _, starts, K = banded
    Wb = _device_table("i8_banded", n_in, n_out, xc.device)
    acc = torch.cat([int_matmul(Wb[b], xc[s : s + K]) for b, s in enumerate(starts)])
    return acc[:n_out]


def _int8_cols_matmul(xc: torch.Tensor, n_out: int) -> torch.Tensor:
    """Column-pass accumulator [H, n_out] int32: banded when enabled and
    profitable (one exact product per output block, as the row pass)."""
    n_in = xc.shape[1]
    banded = _banded_blocks_i8(n_in, n_out) if _banded_enabled() else None
    if banded is None:
        return int_matmul(xc, _device_table("i8", n_in, n_out, xc.device).t())
    _, starts, K = banded
    Wb = _device_table("i8_banded", n_in, n_out, xc.device)
    acc = torch.cat([int_matmul(xc[:, s : s + K], Wb[b].t()) for b, s in enumerate(starts)],
                    dim=1)
    return acc[:, :n_out]


def _resize_plane_int8(plane: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The JAX package's ``_resize_plane_int8``: centered int8 plane, exact
    integer products, requantized centered intermediate between passes."""
    in_h, in_w = plane.shape
    dev = plane.device
    xc = (plane.to(torch.int16) - 128).to(torch.int8)  # exact centering
    mid_scale = 1.0  # intermediate units per original pixel unit
    if in_h != out_h:
        _, dq, off, bound = _resize_matrix_i8(in_h, out_h)
        acc = _int8_rows_matmul(xc, out_h)
        dq_t = torch.from_numpy(dq[:, None]).to(dev)
        off_t = torch.from_numpy(off[:, None] - np.float32(128.0)).to(dev)
        y = acc.to(torch.float32) * dq_t + off_t
        if in_w == out_w:
            return torch.clamp(torch.round(y) + 128.0, 0, 255).to(torch.uint8)
        # range-scale the centered intermediate into int8 (|y| <= bound for
        # the unquantized W; clamp for the quantized rows' slight excess)
        mid_scale = 127.0 / bound
        xc = torch.clamp(torch.round(y * float(np.float32(mid_scale))), -127, 127).to(torch.int8)
    _, dq, off, _ = _resize_matrix_i8(in_w, out_w)
    acc = _int8_cols_matmul(xc, out_w)
    scale = torch.from_numpy(dq[None, :] / np.float32(mid_scale)).to(dev)
    y = acc.to(torch.float32) * scale + torch.from_numpy(off[None, :]).to(dev)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def resize_plane(plane: torch.Tensor, out_h: int, out_w: int, method: str = "auto"):
    """Bicubic resize of a [H, W] u8 plane by two dense products, on the
    plane's device.  ``method``: "auto" (= "f32"), "f32" or "int8"."""
    if method not in METHODS:
        raise ValueError(f"resize method {method!r}: use one of {METHODS}")
    in_h, in_w = plane.shape
    if method == "int8" and (in_h != out_h or in_w != out_w):
        return _resize_plane_int8(plane, out_h, out_w)
    dev = plane.device
    if in_h != out_h or in_w != out_w:
        require_ieee_f32(plane, "resize_plane (f32)")
    x = plane.to(torch.float32)
    if in_h != out_h:
        x = _device_table("f32", in_h, out_h, dev) @ x
    if in_w != out_w:
        x = x @ _device_table("f32", in_w, out_w, dev).t()
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def letterbox_geometry(
    inp: PictureSettings, out: PictureSettings
) -> Tuple[int, int, int, int]:
    """(x, y, scaled_w, scaled_h) of the content box (encode.rs:354-377)."""
    width_ratio = Fraction(out.width, inp.width)
    height_ratio = Fraction(out.height, inp.height)
    scale = min(width_ratio, height_ratio)
    scaled_w = out.align_horizontal(int(scale * inp.width))
    scaled_h = out.align_vertical(int(scale * inp.height))
    x = out.align_horizontal((out.width - scaled_w) // 2)
    y = out.align_vertical((out.height - scaled_h) // 2)
    return x, y, scaled_w, scaled_h


def _scale_planes(planes, inp: PictureSettings, out: PictureSettings,
                  method: str = "auto"):
    """Scale + letterbox a yuv420p plane dict into ``out`` (on the planes'
    device).  The letterbox writes into a CLONE of the cached blank: the
    blank is shared by every tick."""
    x, y, sw, sh = letterbox_geometry(inp, out)
    base = Picture.blank(out, planes["y"].device)
    scaled = {}
    for name, (sub_x, sub_y) in (("y", (0, 0)), ("u", (1, 1)), ("v", (1, 1))):
        ph = sh >> sub_y
        pw = sw >> sub_x
        plane = resize_plane(planes[name], ph, pw, method)
        canvas = base.planes[name]
        if tuple(canvas.shape) == (ph, pw):
            scaled[name] = plane  # the content fills the frame: no border
            continue
        canvas = canvas.clone()
        py, px = y >> sub_y, x >> sub_x
        canvas[py : py + ph, px : px + pw] = plane
        scaled[name] = canvas
    return scaled


def scale_picture(pic: Picture, out: PictureSettings, method: str = "auto") -> Picture:
    """Scale + letterbox a yuv420p picture into ``out`` settings, on the
    device its planes live on (numpy planes are uploaded to the card
    first)."""
    if pic.settings == out:
        return pic
    assert pic.settings.pixel_format == YUV420P == out.pixel_format
    if not all(isinstance(v, torch.Tensor) for v in pic.planes.values()):
        from mixlab_tpu_torch.device import resolve_device

        pic = pic.to(resolve_device("cuda"))
    return Picture(out, _scale_planes(pic.planes, pic.settings, out, method))
