"""Video frame representation (port of ``mixlab_tpu/video/frame.py``).

Rebuild of the reference's frame plumbing: ``video::Frame`` wraps a decoded
ffmpeg AvFrame plus a duration hint (``src/video.rs:7-14``), and the engine
payload adds a tick offset (``src/engine/io.rs:11-17``).  Pixels are planar
uint8 YUV420 (or interleaved uint8 RGB) torch tensors on an explicit device.

``PictureSettings`` mirrors ``codec/src/ffmpeg/frame.rs`` PictureSettings
{width, height, pixel_format}; ``unify_picture_settings`` reproduces the
video mixer's max-box chroma-aligned target computation
(``src/module/video_mixer.rs:276-297``).

Pictures are immutable by convention, as JAX arrays are: every pixel
operation writes new tensors, so a stored picture may be shared between
ticks and modules.  The blank pictures are cached per (settings, device)
and shared by every tick; nothing may write into them (``scale.py`` clones
the canvas before it letterboxes into it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from mixlab_tpu_torch.utils.mtime import MediaDuration

# (settings, device) -> blank Picture (see Picture.blank)
_BLANK_CACHE: Dict[Tuple["PictureSettings", torch.device], "Picture"] = {}

YUV420P = "yuv420p"
RGB24 = "rgb24"


@dataclass(frozen=True)
class PictureSettings:
    width: int
    height: int
    pixel_format: str = YUV420P

    # chroma subsampling (log2) per format
    @property
    def log2_chroma_w(self) -> int:
        return 1 if self.pixel_format == YUV420P else 0

    @property
    def log2_chroma_h(self) -> int:
        return 1 if self.pixel_format == YUV420P else 0

    def align_horizontal(self, x: int) -> int:
        mask = (1 << self.log2_chroma_w) - 1
        return (x + mask) & ~mask

    def align_vertical(self, y: int) -> int:
        mask = (1 << self.log2_chroma_h) - 1
        return (y + mask) & ~mask


def unify_picture_settings(a: PictureSettings, b: PictureSettings) -> PictureSettings:
    """Max box, chroma-aligned, forced yuv420p (video_mixer.rs:276-297)."""
    target = PictureSettings(
        max(a.width, b.width), max(a.height, b.height), YUV420P
    )
    return PictureSettings(
        target.align_horizontal(target.width),
        target.align_vertical(target.height),
        YUV420P,
    )


@dataclass
class Picture:
    """Planar pixel data.

    yuv420p: planes {"y": [H, W] u8, "u": [H/2, W/2] u8, "v": [H/2, W/2] u8}
    rgb24:   planes {"rgb": [H, W, 3] u8}

    Planes are torch tensors on one device; an ingest source may hand in
    numpy planes, which :meth:`to` uploads.
    """

    settings: PictureSettings
    planes: Dict[str, torch.Tensor]

    @staticmethod
    def blank(settings: PictureSettings, device: torch.device) -> "Picture":
        """Black frame; chroma planes at 0x80 (frame.rs:76-138 blank()).
        Cached per (settings, device): the realtime tick asks for one every
        frame.  Shared: never write into its planes."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:  # one entry per card
            device = torch.device("cuda", torch.cuda.current_device())
        key = (settings, device)
        cached = _BLANK_CACHE.get(key)
        if cached is not None:
            return cached
        w, h = settings.width, settings.height
        if settings.pixel_format == YUV420P:
            planes = {
                "y": torch.zeros((h, w), dtype=torch.uint8, device=device),
                "u": torch.full((h >> 1, w >> 1), 0x80, dtype=torch.uint8, device=device),
                "v": torch.full((h >> 1, w >> 1), 0x80, dtype=torch.uint8, device=device),
            }
        elif settings.pixel_format == RGB24:
            planes = {"rgb": torch.zeros((h, w, 3), dtype=torch.uint8, device=device)}
        else:
            raise ValueError(settings.pixel_format)
        pic = Picture(settings, planes)
        _BLANK_CACHE[key] = pic
        return pic

    def to(self, device: torch.device) -> "Picture":
        """The same picture with every plane a contiguous tensor on
        ``device`` (numpy planes are uploaded; contiguous planes already
        there are kept, not copied)."""
        device = torch.device(device)
        planes = {}
        for k, v in self.planes.items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v, dtype=np.uint8))
            planes[k] = v.to(device).contiguous()
        return Picture(self.settings, planes)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in self.planes.items()}


@dataclass
class VideoFrame:
    """Engine video payload (io.rs:11-17 + video.rs:7-14)."""

    picture: Picture
    duration_hint: MediaDuration = field(default_factory=MediaDuration.zero)
    tick_offset: MediaDuration = field(default_factory=MediaDuration.zero)
