"""VideoMixer graph definition (port of ``mixlab_tpu/dsp/video_mixer.py``).

Reference: ``src/module/video_mixer.rs`` — a 4-input video crossfader with
A/B channel select and a fader.  The pixel work (crossfade, rescale, picture
unification) runs on the device through :mod:`mixlab_tpu_torch.video`; the
Option-valued per-tick frame plumbing (stored-frame expiry, channel select)
is host control flow in :mod:`mixlab_tpu_torch.video.engine`, driven by the
realtime engine's video pass.

This class only contributes graph structure (terminals); it has no audio
terminals, so its ``run_block`` does nothing.
"""

from __future__ import annotations

from mixlab_tpu_torch.dsp.base import ModuleDef
from mixlab_tpu_torch.protocol import VIDEO_MIXER_CHANNELS, LineType, VideoMixerParams


class VideoMixerDef(ModuleDef):
    kind = "VideoMixer"

    def terminals(self, params: VideoMixerParams):
        ins = [
            LineType.VIDEO.labeled(str(i + 1)) for i in range(VIDEO_MIXER_CHANNELS)
        ]
        outs = [
            LineType.VIDEO.labeled("Output"),
            LineType.VIDEO.labeled("A"),
            LineType.VIDEO.labeled("B"),
        ]
        return ins, outs

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        # no audio terminals; nothing to do in the audio block program
        return state, [None, None, None], {}
