"""Sink / tap / feed modules (port of ``mixlab_tpu/dsp/sinks.py``).

These bridge the block program to the host:

  * Plotter      — src/module/plotter.rs:38-59 (oscilloscope tap)
  * Monitor      — src/module/monitor.rs (A/V preview sink: audio tap)
  * OutputDevice — src/module/output_device.rs (soundcard sink: audio tap and
                   a clip flag, any |sample| > 1 in the block)
  * StreamInput  — src/module/stream_input.rs (live ingest feed: the host
                   fills a per-block i16 ``[2, S]`` buffer; i16 -> f32 / 32768
                   on the device, stream_input.rs:167-173)
  * StreamOutput — src/module/stream_output.rs (RTMP egress: audio tap)
  * MediaSource  — src/module/media_source.rs (file playback feed: the host
                   fills a per-block f32 ``[2, S]`` buffer)

Feeds declare their per-block host buffers with ``ext_spec``; the compiler's
``host_aux`` zero-fills the ones the caller does not supply.  Every kind
also runs inside the region program (``mega_spec``): the feeds as operands,
the taps as tap ops, the clip flag as a peak whose ``tap_post`` turns it
back into the regular program's bool.
"""

from __future__ import annotations

import numpy as np
import torch

from mixlab_tpu_torch.dsp.base import (
    OP_I16,
    MegaSpec,
    ModuleDef,
    Peak,
    expect_stereo,
)
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.protocol import LineType

_I16_SCALE = 1.0 / 32768.0  # convert_sample (stream_input.rs:167-173)


def _tap_shape(cfg, block):
    return (block.n_ticks, cfg.samples_per_tick)


def _stereo_tap_spec():
    """Region spec of the pure audio-tap sinks (Monitor, StreamOutput): the
    input pair goes to the tap, nothing else."""

    def emit(ctx, ins):
        # audio is the LAST input terminal (video precedes it where present)
        return [], {"audio": ctx.expect_stereo(ins[-1])}

    return MegaSpec(emit=emit, declare={"taps": [("audio", 2)],
                                        "exit_f": 0, "exit_i": 0})


class PlotterDef(ModuleDef):
    kind = "Plotter"

    def terminals(self, params):
        return [LineType.STEREO.unlabeled()], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        taps = {}
        if inputs[0] is not None:
            # the host slices every 6th tick out of this (plotter.rs:40-42)
            l, r = inputs[0]
            shape = _tap_shape(cfg, block)
            taps["audio"] = (l.reshape(shape), r.reshape(shape))
        return state, [], taps

    def mega_spec(self, params, cfg, block, connected):
        if not connected[0]:
            return MegaSpec(emit=lambda ctx, ins: ([], {}))
        return MegaSpec(emit=lambda ctx, ins: ([], {"audio": ctx.expect_stereo(ins[0])}),
                        declare={"taps": [("audio", 2)], "exit_f": 0, "exit_i": 0})


class MonitorDef(ModuleDef):
    kind = "Monitor"

    def terminals(self, params):
        # video first, audio second (monitor.rs:97-100)
        return [
            LineType.VIDEO.labeled("Video"),
            LineType.STEREO.labeled("Audio"),
        ], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        l, r = expect_stereo(inputs[1], block.n_samples(cfg), device)  # zeros if unpatched
        shape = _tap_shape(cfg, block)
        return state, [], {"audio": (l.reshape(shape), r.reshape(shape))}

    def mega_spec(self, params, cfg, block, connected):
        return _stereo_tap_spec()


class OutputDeviceDef(ModuleDef):
    kind = "OutputDevice"

    def terminals(self, params):
        return [LineType.STEREO.unlabeled()], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        l, r = expect_stereo(inputs[0], block.n_samples(cfg), device)
        # clip detection: any |sample| > 1.0 in the block, one bool per block
        # (output_device.rs:213-224 checks per tick on the host)
        clip = (l.abs() > 1.0).any() | (r.abs() > 1.0).any()
        shape = _tap_shape(cfg, block)
        return state, [], {"audio": (l.reshape(shape), r.reshape(shape)), "clip": clip}

    def mega_spec(self, params, cfg, block, connected):
        def emit(ctx, ins):
            l, r = ctx.expect_stereo(ins[0])
            return [], {"audio": (l, r), "clip": Peak(l, r)}

        return MegaSpec(
            emit=emit,
            declare={"taps": [("audio", 2), ("clip", 0)], "exit_f": 0, "exit_i": 0},
            tap_post=lambda taps: {**taps, "clip": taps["clip"] > 1.0},
        )


class _ExternalFeed(ModuleDef):
    """Base for modules whose audio originates on the host: ``ext_spec``
    declares the per-block buffers the program reads from ``host_aux``."""

    def ext_spec(self, params, cfg: EngineConfig, block: BlockSpec):
        """dict name -> (shape, dtype) of host-provided per-block arrays."""
        return {}

    def mega_spec(self, params, cfg, block, connected):
        def emit(ctx, ins):
            return [None, self._region_audio(ctx)], {}

        return MegaSpec(
            emit=emit,
            operands=lambda aux, h: {"pcm_l": h["pcm"][0], "pcm_r": h["pcm"][1]},
        )


class StreamInputDef(_ExternalFeed):
    kind = "StreamInput"

    def terminals(self, params):
        # video first, audio second (stream_input.rs:45-48)
        return [], [
            LineType.VIDEO.labeled("Video"),
            LineType.STEREO.labeled("Audio"),
        ]

    def ext_spec(self, params, cfg, block):
        # channel-major [2, S]: each channel is one contiguous row
        return {"pcm": ((2, block.n_samples(cfg)), np.int16)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        pcm = host_aux["pcm"]  # i16 [2, S] filled by the host ingest path
        audio = (pcm[0].to(torch.float32) * _I16_SCALE,
                 pcm[1].to(torch.float32) * _I16_SCALE)
        return state, [None, audio], {}

    def _region_audio(self, ctx):
        return (ctx.op(OP_I16, ctx.operands["pcm_l"]),
                ctx.op(OP_I16, ctx.operands["pcm_r"]))


class MediaSourceDef(_ExternalFeed):
    kind = "MediaSource"

    def terminals(self, params):
        # the reference emits only video (media_source.rs:52-55); the audio
        # output is the JAX package's extension so WAV media is audible
        return [], [
            LineType.VIDEO.unlabeled(),
            LineType.STEREO.labeled("Audio"),
        ]

    def ext_spec(self, params, cfg, block):
        return {"pcm": ((2, block.n_samples(cfg)), np.float32)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        pcm = host_aux["pcm"]
        return state, [None, (pcm[0], pcm[1])], {}

    def _region_audio(self, ctx):
        return (ctx.operands["pcm_l"], ctx.operands["pcm_r"])


class StreamOutputDef(ModuleDef):
    kind = "StreamOutput"

    def terminals(self, params):
        # video first, audio second (stream_output.rs:48-51)
        return [
            LineType.VIDEO.labeled("Video"),
            LineType.STEREO.labeled("Audio"),
        ], []

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        l, r = expect_stereo(inputs[1], block.n_samples(cfg), device)
        shape = _tap_shape(cfg, block)
        return state, [], {"audio": (l.reshape(shape), r.reshape(shape))}

    def mega_spec(self, params, cfg, block, connected):
        return _stereo_tap_spec()
