"""RGB <-> YUV420p colorspace conversion, BT.601 limited range
(port of ``mixlab_tpu/video/colorspace.py``).

Math: ITU-R BT.601 "studio swing":
    Y = 16 + 65.481 R' + 128.553 G' + 24.966 B'   (R',G',B' in [0,1])
    U = 128 - 37.797 R' - 74.203 G' + 112.0  B'
    V = 128 + 112.0  R' - 93.786 G' - 18.214 B'
Chroma is 2x2 box-averaged for 4:2:0, computed in f32 and rounded to u8
(round half to even, as ``jnp.round``).  Elementwise f32 on any device; the
constants are the JAX package's f32 matrix entries.
"""

from __future__ import annotations

import numpy as np
import torch

from mixlab_tpu_torch.video.frame import RGB24, YUV420P, Picture, PictureSettings

_RGB2YUV = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float32,
) / 255.0  # applied to 0..255 RGB directly

_YUV2RGB = np.linalg.inv(_RGB2YUV).astype(np.float32)

_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float32)


def _q(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(p), 0, 255).to(torch.uint8)


def _f(x) -> float:
    """An f32 constant as the Python float torch multiplies an f32 tensor by
    (exact: the value is already an f32)."""
    return float(np.float32(x))


def _combine(row, r, g, b, offset):
    return row[0] * r + row[1] * g + row[2] * b + offset


def _box_mean(p: torch.Tensor) -> torch.Tensor:
    H, W = p.shape
    return p.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))


def rgb_planes_to_yuv420(r, g, b):
    """Channel-major RGB -> YUV420: three u8 planes [H, W] in, (y, u, v)
    out.  H and W must be even."""
    rf, gf, bf = (x.to(torch.float32) for x in (r, g, b))
    M = [[_f(v) for v in row] for row in _RGB2YUV]
    y = _combine(M[0], rf, gf, bf, _f(_OFFSET[0]))
    u = _box_mean(_combine(M[1], rf, gf, bf, _f(_OFFSET[1])))
    v = _box_mean(_combine(M[2], rf, gf, bf, _f(_OFFSET[2])))
    return _q(y), _q(u), _q(v)


def rgb_to_yuv420(rgb):
    """[H, W, 3] u8 -> (y [H,W], u [H/2,W/2], v [H/2,W/2]) u8."""
    return rgb_planes_to_yuv420(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def yuv420_to_rgb(y, u, v):
    """(y, u, v) u8 planes -> [H, W, 3] u8; chroma nearest-upsampled 2x."""
    H, W = y.shape
    yf = y.to(torch.float32) - _f(_OFFSET[0])

    def up(c, off):
        c = c.to(torch.float32).repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        return c[:H, :W] - _f(off)

    uf, vf = up(u, _OFFSET[1]), up(v, _OFFSET[2])
    M = [[_f(x) for x in row] for row in _YUV2RGB]
    rgb = torch.stack([M[i][0] * yf + M[i][1] * uf + M[i][2] * vf for i in range(3)],
                      dim=-1)
    return _q(rgb)


def picture_rgb_to_yuv420(pic: Picture) -> Picture:
    assert pic.settings.pixel_format == RGB24
    y, u, v = rgb_to_yuv420(pic.planes["rgb"])
    return Picture(
        PictureSettings(pic.settings.width, pic.settings.height, YUV420P),
        {"y": y, "u": u, "v": v},
    )


def picture_yuv420_to_rgb(pic: Picture) -> Picture:
    assert pic.settings.pixel_format == YUV420P
    rgb = yuv420_to_rgb(pic.planes["y"], pic.planes["u"], pic.planes["v"])
    return Picture(
        PictureSettings(pic.settings.width, pic.settings.height, RGB24),
        {"rgb": rgb},
    )
