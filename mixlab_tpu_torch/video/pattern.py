"""Test-pattern video sources, generated on the device
(port of ``mixlab_tpu/video/pattern.py``).

The reference has no built-in pattern generator (sources are ingest/media);
the benchmark configs call for synthetic sources (BASELINE config 4: "two
720p test-pattern sources alpha-composited").  These are elementwise
integer math on ``device`` followed by the colorspace conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from mixlab_tpu_torch.video.colorspace import rgb_to_yuv420
from mixlab_tpu_torch.video.frame import RGB24, YUV420P, Picture, PictureSettings

# classic 75% SMPTE bar colors (RGB)
_BARS = np.array(
    [
        [191, 191, 191],
        [191, 191, 0],
        [0, 191, 191],
        [0, 191, 0],
        [191, 0, 191],
        [191, 0, 0],
        [0, 0, 191],
    ],
    dtype=np.uint8,
)


def smpte_bars_rgb(width: int, height: int, phase: int = 0, device="cuda"):
    """[H, W, 3] u8 color bars, horizontally rotated by ``phase`` pixels."""
    col = (torch.arange(width, device=device) + phase) % width
    bar = (col * 7) // width
    rgb = torch.from_numpy(_BARS).to(device)[bar]  # [W, 3]
    return rgb[None, :, :].expand(height, width, 3)


def gradient_planes(width: int, height: int, t: int = 0, device="cuda"):
    """Moving diagonal gradient as channel-major (r, g, b) u8 planes."""
    xx = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    yy = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    r = ((xx + t) % 256).to(torch.uint8)
    g = ((yy + 2 * t) % 256).to(torch.uint8)
    b = ((xx + yy + 3 * t) % 256).to(torch.uint8)
    return r.expand(height, width), g.expand(height, width), b


def gradient_rgb(width: int, height: int, t: int = 0, device="cuda"):
    """Moving diagonal gradient; ``t`` animates it."""
    return torch.stack(gradient_planes(width, height, t, device), dim=-1)


def pattern_picture(
    kind: str, width: int, height: int, t: int = 0, pixel_format: str = YUV420P,
    device="cuda",
) -> Picture:
    if kind == "bars":
        rgb = smpte_bars_rgb(width, height, phase=t, device=device)
    elif kind == "gradient":
        rgb = gradient_rgb(width, height, t=t, device=device)
    else:
        raise ValueError(kind)
    if pixel_format == RGB24:
        return Picture(PictureSettings(width, height, RGB24), {"rgb": rgb.contiguous()})
    y, u, v = rgb_to_yuv420(rgb)
    return Picture(
        PictureSettings(width, height, YUV420P), {"y": y, "u": u, "v": v}
    )
