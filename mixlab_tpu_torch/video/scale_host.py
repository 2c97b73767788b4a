"""Host-rate scale + letterbox in numpy (port of
``mixlab_tpu/video/scale_host.py``).

The dense resize is the right form on a device, but ~99% of its matrix is
zeros, which a host CPU pays for.  This module applies the SAME weights
(``scale.resize_matrix`` stays the single source of truth) as two banded
separable passes: per output sample, only its K nonzero source taps.

Paths: the port's C++ twin (``native/mixlab_native.cpp``
``scale_plane_banded``, the JAX package's copy) first, with this vectorized
numpy path as its fallback where the native library cannot be built; the
C++ rounds half away from zero and sums in its own order, so the two agree
within 1 u8 LSB (``tests/test_torch_alsa_out.py`` holds the C++ to the JAX
package's C++, byte for byte).  The publish tier
(``server/stream_output.py``) is the caller.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mixlab_tpu_torch.video.frame import YUV420P, Picture, PictureSettings
from mixlab_tpu_torch.video.scale import letterbox_geometry, resize_matrix


@functools.lru_cache(maxsize=256)
def banded_weights(n_in: int, n_out: int):
    """(idx [n_out, K] int32, w [n_out, K] f32) banded form of
    resize_matrix — per output sample, the nonzero source taps (padded
    with weight-0 index-0 entries to the max bandwidth K)."""
    W = resize_matrix(n_in, n_out)
    nz = [np.nonzero(W[o])[0] for o in range(n_out)]
    K = max(len(z) for z in nz)
    idx = np.zeros((n_out, K), dtype=np.int32)
    w = np.zeros((n_out, K), dtype=np.float32)
    for o, z in enumerate(nz):
        idx[o, : len(z)] = z
        w[o, : len(z)] = W[o, z]
    return idx, w


def resize_plane_host(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W] u8 -> [out_h, out_w] u8 on the host CPU (banded bicubic, K
    gather-multiply-add passes per axis in f32: the C++ twin, else numpy)."""
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    in_h, in_w = plane.shape
    if (in_h, in_w) == (out_h, out_w):
        return plane
    yidx, yw = banded_weights(in_h, out_h)
    xidx, xw = banded_weights(in_w, out_w)

    from mixlab_tpu_torch import native

    out = native.scale_plane_banded(plane, out_h, out_w, yidx, yw, xidx, xw)
    if out is not None:
        return out
    tmp = np.zeros((out_h, in_w), dtype=np.float32)
    for k in range(yidx.shape[1]):
        tmp += yw[:, k:k + 1] * plane[yidx[:, k], :]
    acc = np.zeros((out_h, out_w), dtype=np.float32)
    for k in range(xidx.shape[1]):
        acc += xw[None, :, k] * tmp[:, xidx[:, k]]
    return np.clip(np.round(acc), 0, 255).astype(np.uint8)


_BLANK = {}


def _host(plane) -> np.ndarray:
    if isinstance(plane, torch.Tensor):
        return plane.detach().cpu().numpy()
    return np.asarray(plane)


def scale_picture_host(pic: Picture, out: PictureSettings) -> Picture:
    """Scale + letterbox on the host CPU; same geometry as scale_picture
    (aspect-preserving, chroma-aligned content box, 0x80-chroma bars).
    Planes may be numpy arrays or tensors; the result's are numpy."""
    if pic.settings == out:
        return pic
    assert pic.settings.pixel_format == YUV420P == out.pixel_format
    x, y, sw, sh = letterbox_geometry(pic.settings, out)
    blank = _BLANK.get(out)
    if blank is None:
        blank = _BLANK[out] = {
            "y": np.zeros((out.height, out.width), np.uint8),
            "u": np.full((out.height // 2, out.width // 2), 0x80, np.uint8),
            "v": np.full((out.height // 2, out.width // 2), 0x80, np.uint8),
        }
    planes = {}
    for name, (sub_x, sub_y) in (("y", (0, 0)), ("u", (1, 1)), ("v", (1, 1))):
        ph, pw = sh >> sub_y, sw >> sub_x
        canvas = blank[name].copy()
        canvas[y >> sub_y: (y >> sub_y) + ph,
               x >> sub_x: (x >> sub_x) + pw] = resize_plane_host(_host(pic.planes[name]), ph, pw)
        planes[name] = canvas
    return Picture(out, planes)
