"""Host-side video tick engine: video_mixer control flow
(port of ``mixlab_tpu/video/engine.py``).

Reference: ``src/module/video_mixer.rs:70-208`` — per tick the mixer

  1. passes A/B channel inputs through to the A/B outputs,
  2. expires stored frames whose ``active_until`` has passed,
  3. unifies the target picture settings over live + stored frames,
  4. stores (rescaled) incoming frames with expiry
     ``now + tick_offset + duration_hint``,
  5. composes output = crossfade(A, B) with missing channels reading the
     blank output frame.

Option-valued per-tick plumbing is host control flow (frames arrive
irregularly); the pixel work (scale_picture / crossfade_picture) runs on
``device``.  An incoming picture is uploaded to ``device`` once, when its
channel stores it (ingest hands in numpy or host planes).  The output frame
advertises duration 1/TICKS_PER_SECOND and tick_offset 0
(video_mixer.rs:241-248).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.protocol import VIDEO_MIXER_CHANNELS, VideoMixerParams
from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
from mixlab_tpu_torch.video.blend import crossfade_picture
from mixlab_tpu_torch.video.frame import (
    Picture,
    PictureSettings,
    VideoFrame,
    unify_picture_settings,
)
from mixlab_tpu_torch.video.scale import scale_picture


@dataclass
class _Channel:
    stored: Optional[Picture] = None
    stored_input_settings: Optional[PictureSettings] = None
    active_until: Optional[MediaTime] = None
    target: Optional[PictureSettings] = None

    def rescale(self, target: PictureSettings):
        if self.target != target:
            self.target = target
            if self.stored is not None:
                self.stored = scale_picture(self.stored, target)


@dataclass
class VideoMixerState:
    channels: List[_Channel] = field(
        default_factory=lambda: [_Channel() for _ in range(VIDEO_MIXER_CHANNELS)]
    )


def video_mixer_tick(
    state: VideoMixerState,
    params: VideoMixerParams,
    inputs: List[Optional[VideoFrame]],
    t: int,
    cfg: EngineConfig,
    device: torch.device,
) -> List[Optional[VideoFrame]]:
    """One tick; returns [output, a_passthrough, b_passthrough]."""
    out_a = inputs[params.a] if params.a is not None and params.a < len(inputs) else None
    out_b = inputs[params.b] if params.b is not None and params.b < len(inputs) else None

    now = MediaTime.new(t, cfg.sample_rate)

    # expire stored frames
    for ch in state.channels:
        if ch.active_until is not None and now >= ch.active_until:
            ch.stored = None
            ch.active_until = None

    # unified target settings over live inputs and stored frames
    settings = []
    for idx in range(VIDEO_MIXER_CHANNELS):
        frame = inputs[idx] if idx < len(inputs) else None
        if frame is not None:
            settings.append(frame.picture.settings)
        elif state.channels[idx].stored is not None:
            settings.append(state.channels[idx].stored.settings)
    if not settings:
        return [None, out_a, out_b]
    target = settings[0]
    for s in settings[1:]:
        target = unify_picture_settings(target, s)
    if len(settings) == 1:
        target = unify_picture_settings(target, target)  # force align + yuv420p

    # receive frames / rescale stored
    for idx in range(VIDEO_MIXER_CHANNELS):
        ch = state.channels[idx]
        frame = inputs[idx] if idx < len(inputs) else None
        if frame is not None:
            ch.stored = None
            ch.rescale(target)
            ch.stored_input_settings = frame.picture.settings
            ch.stored = scale_picture(frame.picture.to(device), target)
            ch.active_until = now + frame.tick_offset + frame.duration_hint
        else:
            ch.rescale(target)

    # compose
    blank = Picture.blank(target, device)

    def stored(sel) -> Picture:
        if sel is None or sel >= VIDEO_MIXER_CHANNELS:
            return blank
        return state.channels[sel].stored or blank

    a_pic = stored(params.a)
    b_pic = stored(params.b)
    fade = int(params.fader * 255.0)  # (video_mixer.rs:166 truncating cast)
    planes = crossfade_picture(a_pic.planes, b_pic.planes, fade)

    out = VideoFrame(
        picture=Picture(target, planes),
        duration_hint=MediaDuration.new(1, cfg.ticks_per_second),
        tick_offset=MediaDuration.zero(),
    )
    return [out, out_a, out_b]
