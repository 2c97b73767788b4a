#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mixlab_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA toolkit) and the repository checkout; it
imports no jax.  Phases, any failure of which exits non-zero:

  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels (csrc/*.cu) and print the build time
     and ptxas's lines, and for the eq, region and envelope kernels (the
     batched rows forms' too) their registers, stack and spill bytes;
  3. envelope kernel vs its plain twin on the card, 3 carried blocks each:
     S = 735, T-1, T, T+1 (T the tile, 512 samples), 44,100, 48,000,
     384,000 and one past the split bound; open / dense / sparse gates, and
     gates with edges at T-1, T, T+1 of every tile boundary and on the
     first and last sample, and with one edge in every tile; each S prints
     its tiles (G) and tile length (T);
  4. EqThree kernel vs its twin, output and poles within 2e-5, 3 carried
     blocks each: S = 1, L-1, L+1, T-1, T, T+1 (L the run a thread, T the
     CTA's tile: 8 and 1,024 samples), 8,192, 44,100, 48,000, the split
     bound and one past it; each S prints its CTAs (G) and run (L);
  5. region kernel vs its twin on the card, launch by launch on the same
     inputs: the flagship at 48 kHz in blocks of 48,000 samples (one part)
     and of 240,000 (two parts), and the sink zoo with StreamInput feeds,
     each over 3 carried blocks; and the region program vs the regular one;
  6. the main paths, each with the launch counts set to 0 just before and
     read just after: the flagship 16-module graph written to a .mixlab
     file and rendered by ``mixlab_tpu_torch.render_cli`` for 10 s (a) at
     its defaults (44.1 kHz, 60-tick blocks, cuda: the envelope and eq
     kernels must launch) and (b) at ``--sample-rate 48000`` (the region
     kernel once per block, the envelope kernel in the prelude); the audio
     is held against the float64 oracle (first 2 s) and the port's own CPU
     render (all 10 s); and (c) the ``.mp4`` export of 2 s at the defaults
     on the pure codec tier: the file walks as ``ftyp``, ``moov`` (``avc1``,
     ``mp4a``), then ``moof``/``mdat`` pairs with 86 AAC frames and 20
     video frames, and the envelope and eq kernels launch once per block;
  7. timing, for information: each kernel vs its twin at the main path's
     shapes (and the region kernel on one part of a two-part block), the
     envelope kernel's device time per launch at 44,100 and 48,000 samples
     for tiles of 256 to 2,048 samples (profiler), the region program vs
     the regular one per 48 kHz block, the render of 60 s of audio as a
     realtime factor at both rates, and a profile of 5 render blocks at
     each: device time per block and its share of the unprofiled wall;
     the eq kernel (S = 44,100) and the region kernel (48 kHz block): device
     time per launch, device launches per call (the eq kernel must make
     exactly one), share of the bound, the sweep of the run L and the CTA
     size T (eq: T = 64-512, L = 2-32 at 44,100 and 48,000 samples, each
     held to its twin; region: L = 1-16) and the region's breakdown (a
     one-TAP plan, the plan with its EQ as an AMP, the plan);
  8. crossfade kernel vs its twin on the card, exact (planes 1920x1080,
     960x540, 36x100, 1x1, 7x13, 17x31, 5x13 and 1025x16 -- n % 16 of 0, 1,
     11 and 15, vector counts that leave a ragged last CTA -- and one at an
     odd byte offset; fades 0, 1, 127, 128, 254, 255; single-plane
     launches and three-plane launches of mixed sizes), and
     ``scale_picture`` 1280x720 -> 1920x1080 on the card vs the CPU
     (``"int8"`` exact, ``"f32"`` within 1 LSB); run with phases 3-5;
  9. the realtime main path, with the launch counts set to 0 just before and
     read just after: the port's ``Engine`` (44.1 kHz, ``block_ticks=1``,
     cuda) built by client ops (the flagship, two StreamInputs on RTMP
     mountpoints, a VideoMixer at fader 0.6 into the Monitor), 120 ticks in
     direct drive, each publishing a new 1080p bars and 720p gradient frame
     and 735 samples; the crossfade kernel must launch exactly 120 times,
     every composite equal the twin on the same stored pictures, and the
     first 10 ticks agree with a CPU ``Engine`` (composites within 1 LSB,
     monitor audio within 1e-4); run after phase 6;
 10. realtime timing, for information, after phase 7: the crossfade vs its
     twin at 1080p, its device time per picture back to back and with the
     L2 cache flushed between launches (a 128 MB write; profiler),
     ``scale_picture`` by method, ``tick_once`` over 300 ticks
     with and without the video chain, a profile of 10 ticks, the edit path
     (``compile_patch`` and the first block; a client op), and a 5 s
     threaded run (``Engine.start()`` with a 60 fps feeder thread);
 11. the polyphase resize kernel vs its twin on the card, exact: every
     ``RESIZE_CASES`` geometry (720p -> 1080p planes, 540p -> 1080p,
     1080p -> 720p, 1080 -> 540, 240 -> 256 with 16 phases, ragged widths,
     the steepest 2.75:1 downscale, whose window needs over 48 KB of shared
     memory, ratios with zero weights between nonzero taps) as a single plane on both axes and on each axis alone; the
     720p -> 1080p and 540p -> 1080p pictures as three-plane launches (one
     launch each), a picture with an unchanged plane and one with a plane
     of one resized axis; each plane within 1 LSB of the dense f32 resize;
     the passthrough kernel vs its twin, exact, at S = 384,000 and a ragged
     S; run with phases 3-5 and 8;
 12. the composite main path, with the launch counts set to 0 just before
     and read just after: config 5's video half (``bench.py:474-496``) at
     1080p30 for 60 frames, each a 960x540 gradient to yuv420p, its three
     planes to 1080p through ONE ``resize_picture_polyphase`` launch, the
     luma crossfaded with its 1-row roll at fade 128 (1 crossfade launch);
     then beside it the same frames on the dense f32 resize (within 1 LSB)
     and the folded ``resize_crossfade_roll`` (luma within 2 LSB), one frame
     through the banded int8 products (equal to the dense int8), and the
     realtime path's 1280x720 camera through the polyphase resize (within
     1 LSB of the f32 letterbox's content box);
 13. the profiling tool's path, with the launch counts set to 0 just before
     and read just after: ``mixlab_tpu_torch.tools.profile_env_eq``'s nine
     rows at 48 kHz, S = 384,000, on a slope of 2 and 10 blocks, one round;
     the passthrough kernel must launch once per block of ``full_dummy_eq``
     and in no other row;
 14. video and passthrough timing, for information: per 720p -> 1080p
     picture and per config-5 frame, the resize kernel (one launch), its
     twin, the dense f32 and int8 resizes and the banded int8 (CUDA events,
     the forms in turns), the kernel's device time per picture (profiler);
     the passthrough vs its twin and ``torch.mul`` at S = 384,000 (CUDA
     events in turns, both kernels' device time by the profiler), and the
     host time of each piece of a wrapper's launch path, the guarded path's
     (a device guard, a ``Stream`` object, messages formatted up front) and
     the lean path's (``kernels.launch``);
 15. the served session on the card, the realtime engine's Monitor codec
     threads live (pure tier): (a) in this process a ``ProjectHandle`` on
     cuda and ``run_server`` on an ephemeral port; a WebSocket client of the
     script's own builds ``flagship.realtime_video_ops`` (cameras fed at
     60 fps as in phase 10), reads the Monitor's socket id from its
     indication and subscribes to ``/_monitor/<id>`` for 10 s: the init
     packet, then segments that walk as ``moof``/``mdat``; exactly one
     crossfade launch per video tick (counts set to 0 and read on the
     engine thread), the native CAVLC tier, and for information segments/s,
     the pipe's dropped count, the encoders' ms per frame and per second of
     audio and the served ``tick_once`` p50/p99 and share over 16.667 ms
     (the AAC encoder runs in its codec process, ``av/aac_worker.py``; the
     log line names earlier figures with it on the codec thread); then, each encoder alone, the native and numpy
     CAVLC tiers' ms per 560x350 frame (byte-identical) and the AAC
     encoder's ms per second in this process and through its codec process;
     (b) ``python -m mixlab_tpu_torch --listen 127.0.0.1:<port>`` at its
     default device: ``GET /`` with the port's ``index.html``, one client
     op, SIGTERM -> exit 0 within 15 s with the op persisted.  Any
     exception in a server, codec or engine thread fails the phase;
 16. the batched paths, each with the launch counts set to 0 just before and
     read just after: (a) the batched eq kernel (B = 1, 2, 32, 133, 1,024
     and the B either side of each switch of the plan's form x S = 8,192,
     12,000, 44,100, 96,000: the cooperative grid, one CTA a row) and the
     batched envelope kernel
     (B = 1, 2, 32, 1,024 and the B either side of each switch of the
     plan's form x S = 4,097 (a last tile of one sample), 12,000, 32,768,
     48,000, 96,000; dense and sparse gates; every form the plan takes: the
     cooperative grid, one CTA a block, the look-back) against their
     batched twins over 3 carried blocks (EQ_TOL, ENV_ATOL), exactly one
     device launch a call for every B (profiler), and each form's time,
     device time, bound and twin time at B = 1,024 and 8,192 x 12,000 and
     32 x 96,000 (the envelope also 1,024 x 38,400); (b) the fleet: the flagship at 48 kHz
     in 15-tick blocks, N = 1,024 sessions with their own params, one eq
     launch and one envelope launch a block, four slots against single-patch
     renders on the card (EQ_TOL); for information N = 1,024 and 8,192: wall
     per block, realtime multiple, device busy share and peak memory; (c)
     fleet serving: a ``FleetEngine`` of 1,024 slots on the card behind a
     ``FleetServeApp``, 16 WebSocket clients for 5 s: joins, states, framed
     i16 PCM, one edit and its Sync, every unedited session within 1 LSB of
     a dedicated render from its join; blocks/s and the share over the
     250 ms budget; (d) ``stem_parallel_step`` with 16 stems (master =
     16 x one stem within 2e-4, one eq launch), the resampler against
     ``resample_block_np`` within 2e-6 (refused under cuDNN TF32), and
     config 3 (16 stereo stems 44.1 -> 48 kHz and the per-channel eq,
     B = 32 x 96,000) as x realtime;
 17. media playback, after phase 15: (a) the port's native H.264 decode
     tier against its Python tier, bit-exact, on the x264 streams committed
     under ``tests/data/h264/`` (CAVLC and CABAC, P and B, the High
     profile's 8x8 transform) and on a 1080p CAVLC intra stream of the
     port's encoder, then ms per 1080p frame by tier; (b) a 1920x1080, 30
     fps, 10 s MP4 with 44.1 kHz stereo AAC-LC made here by the port's
     encoders and mux, uploaded into a ``ProjectHandle`` on cuda behind
     ``run_server``; the script's WebSocket client builds the realtime
     workspace with one 1080p camera on the VideoMixer's channel A at fader
     0 and a MediaSource of the upload on channel B, and subscribes to the
     Monitor: one crossfade launch per video tick in a 5 s window (counts
     set to 0 and read on the engine thread); 12 composites holding a media
     picture equal decoded pictures exactly; at fader 0.6, 12 composites
     within 1 LSB of the CPU twin on the mixer's stored pictures; the PCM
     the engine's feed played equal to the AAC decoder's within 1e-4 (the
     MediaPlayer decodes AAC-LC in its codec process); for
     information the window's served tick p50/p99, share over 16.667 ms,
     the pipe's dropped ticks, the feed's frames late on the wall clock and
     underrun ticks, and a second window with the AAC path a no-op; (c)
     ``imdct_batch_torch`` on the card against the numpy ``imdct_batch``
     within 2e-3, refused under TF32;
 18. live ingest and broadcast, after phase 17 on its 1080p30 stream and
     AAC granules (``ingest_session``), behind ``run_server`` on a
     ``ProjectHandle`` on cuda: (a) the script's RTMP publisher (the port's
     client) sends the stream with its AAC-LC to ``cam``, a StreamInput on
     the VideoMixer's channel B at fader 0 with a 1080p camera on A: one
     crossfade launch per video tick in a 5 s window (counts set to 0 and
     read on the engine thread), ingested pictures on the card, 12
     composites equal decoded pictures exactly, the played PCM within 1e-4
     of the AAC decoder's, and for information the served tick, the
     ingest's decode ms per frame, late frames and underruns; (b) a
     StreamOutput connected by a client op to ``out`` on the same server:
     Live over the session socket, 1120x700 pictures of a split test
     picture and the 440 Hz tone back on ``out``, tags a second and drops;
     (c) a 48 kHz WAV Icecast SOURCE to ``radio`` at 44.1 kHz within 2e-6
     of ``resample_block_np``;
 19. scale-out, after phase 16 and before phase 15's threads, each path with
     the launch counts set to 0 just before and read just after: (a) the
     flagship's stems at 48 kHz over meshes of 1, 2 and 4 entries on the
     card (and 2 and 4 distinct cards where there are), 5 stems and 8, in
     16- and 41-tick blocks: the master within 2e-4 of the one-entry
     mesh's, at 16 ticks the batched region kernel once a shard a block
     and no eq launch (the block qualifies for the region program, as the
     JAX stems take it), at 41 the batched eq kernel once a shard a block,
     the batched envelope kernel once a shard at any length; (b) the
     fleet at N = 8,192 over a 4-entry mesh: every session's taps equal to the
     one-device fleet's bit for bit, one eq launch a shard, the wall a
     block of each for information; (c) ``row_sharded_blend`` over 4
     entries at 1080p and heights that do not divide by 4: equal to the
     twin, one crossfade launch a shard; (d) the live ``Engine`` with
     ``StemsPatch.compiler`` over a 2-entry mesh, 60 ticks in direct drive
     with a structural edit at tick 30: taps 5 x the one-device engine's
     within 1e-6; (e) two processes in a ``gloo`` group (``mesh_worker``),
     each a 2-entry mesh on the card: the master's checksum within 1e-3
     relative of one process's 4-entry mesh, the region kernel twice a
     process at 16 ticks, and over ``nccl`` across
     distinct cards where there are two; (f) ``python -m
     mixlab_tpu_torch.server.fleet``: a controller and two agents with
     ``--device cuda``; a workspace placed, built by one session (an
     oscillator into an EqThree), migrated to the other agent, whose worker
     resumes from the checkpoint (the EqThree's state equal to the source
     worker's checkpoint continued on the card to the same tick), then
     SIGTERM: every process exits 0;
 20. the batched region, after phase 16 (the profiler), each path with the
     launch counts set to 0 just before and read just after: (a) the
     region kernel against its batched twin in every form its plan takes
     (the cooperative grid with gridDim.y = B, one CTA a row, the
     look-back; the rows form forced beside the grid where the plan takes
     the grid) at B = 1, 2, where B x G just fits at L = 4, either side of
     each switch of the plan's form, 1,024 and 8,192 (B x S at most 8,192 x
     12,800) and S = 8,192, 8,320 (a last tile of one chunk), 12,800,
     38,400 and 204,800 (two parts), 3 carried blocks: the flagship's plan,
     the same with one operand every row shares (row stride 0), the sink
     zoo's plan and a PEAK plan with a NaN, taps and exits within 2e-5,
     scalar taps exact, one launch a call and no memset at every B (the
     flagship's plan); its time a call and device time a launch at 1,024
     and 8,192 x 12,800 beside its bound and its twin; (b) the fleet at 48 kHz with
     per-instance params on the region program, 16 ticks (N = 1,024 and
     8,192) and 48 ticks (N = 1,024): region 1, eq 0, envelope 1 a block;
     taps and state within 2e-5 of the same fleet on the
     regular program and four slots of single-patch region renders; then,
     in turns, the wall, device time with its top kernels (and the batched
     region and envelope kernels' device time a launch), busy share and
     peak memory of both programs; (c) fleet serving in 16-tick blocks: one
     region launch a block, slot PCM within 1 LSB of dedicated renders;
     (d) the fleet of 8,192 over a 4-entry mesh at 16 ticks: 4 region
     launches a block, taps bit-equal to one device's;
 21. the live engine's edit path, after phase 10 and before phase 16 (and
     phase 15's threads), each path with the launch counts set to 0 just
     before and read just after: (a) the threaded realtime engine (the
     flagship, 1080p and 720p cameras fed at 60 fps, the VideoMixer, the
     crossfade kernel) for a 5 s quiet window, then 5 s of 10 structural
     ops a second (create an oscillator, connect it to the Mixer, delete
     it) and 30 VideoMixer fader edits a second: for each window the ticks,
     the fewest in a second (at least 30), those over 16.667 ms and late on
     the schedule, the tick wall's p50 and p99, ticks without exactly one
     crossfade launch (none allowed); op to adoption p50 and max, no stale
     program adopted, the final program the final workspace's; then, for
     information, the same storm in direct drive (every op compiled and
     adopted at once on the thread that ticks); (b) the 48 kHz stems
     engine over a 2-entry mesh in 16-tick blocks, threaded, one structural
     edit with the compile worker's warm held 0.6 s: one region launch a
     shard every block before, during and after the warm, two on the
     compile thread; (c) ``pipeline_depth`` 0, 1 and 2 on the realtime
     engine in direct drive for 120 ticks: the routed Monitor audio and
     composites identical, each d ticks later; (d) whether the libavcodec
     shim builds here and the codec tier taken; where it does, the phase 17
     clip through ``MediaPlayer._run_shim``.  Not in ``main``:
     ``edit_attribution`` (the storm as the engine runs, with the warm beside
     the ticks, with the warm a no-op and with every edit adopted at once,
     in turns).

 22. the look-back's launch number on the device (``csrc/rows.cuh``), after
     phase 20: for the envelope and region kernels, a batched launch at a
     shape whose plan takes the look-back (envelope 32 x 96,000, region 64 x
     102,400), after two calls on a side stream, captured on that stream
     into a CUDA graph and replayed 4 times with new inputs copied into its
     static tensors and an eager look-back call between replays, every
     replay and call against the twin on its inputs (the envelope bit for
     bit, the region within 2e-5), and the scratch's count of ended
     launches equal to the launches made on it; then two host threads of
     200 look-back calls each on one stream, every call against the twin.
 23. the last surface, after phase 18 and before phase 15 (b), each path with
     the launch counts set to 0 just before and read just after: (a)
     ``examples/torch_synth_patch.py`` for 5 s at 48 and 44.1 kHz on the
     card (its ``main``; the launches of each kernel printed, none assumed,
     some kernel must launch), then on the CPU: the int16 PCM within 4 LSB
     (phase 6's 1e-4 on the WAV), rms over 0.01; (b) phase 15 (a)'s served
     session with ``MIXLAB_PURE_AUDIO=flac`` (lossless FLAC encoded on the
     codec thread), then with AAC, in turns, 5 s each: the init packet's
     mime names ``flac`` and holds ``fLaC`` and ``dfLa``, every audio sample
     of every segment the client read decodes by ``av/flacdec.py`` to
     exactly the int16 PCM fed to the encoder, one crossfade launch a video
     tick; segments/s, the encoder's ms per second of audio, the served tick
     p50/p99 and dropped ticks of both; then the FLAC encoder alone, its ms
     per second of audio and its share of the interpreter lock beside a
     Python thread; (c) ``examples/torch_fleet_demo.py``
     as a subprocess on the card (600 s timeout): exit 0, the migrated
     workspace's runtime state restored, no process of its session left,
     its seconds.

Not in ``main``: ``batched_ab`` (the parent's batched eq, envelope and
region launches against this checkout's, in turns, outputs compared),
``rows_sweep`` (the rows forms' tiles, lanes, runs, forms and launch
bounds, in turns), ``single_ab`` and ``region_ab`` (the single-block
launches against the parent's), ``fleet_ab`` (the 15-tick fleet with the
parent's eq kernel and this checkout's, in turns), ``lookback_phase``
(phase 22 alone), ``last_surface_phase`` (phase 23 alone), and the
attribution helpers named below.

TF32 is switched off for matrix products and cuDNN (the eq twin's Toeplitz
products must be IEEE f32, as the JAX package's Precision.HIGHEST).
The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ENV_ATOL = 2e-5          # tests/test_envelope_pallas.py
EQ_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_eq_pallas.py:110
ORACLE_ATOL = 3e-3       # tests/test_whole_graph_oracle.py:55
CPU_RENDER_ATOL = 1e-4
REGION_ATOL = 2e-5       # tests/test_pallas_graph.py:85
MS_PER_SAMPLE = 1000.0 / 44_100
# the card's peaks for the bound (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# the realtime path: 44.1 kHz, 60 ticks/s; cam1 1080p bars, cam2 720p gradient
# (letterboxed into the 1080p composite), VideoMixer fader 0.6 (fade 153)
RT_RATE = 44_100
RT_SPT = 735
RT_FADER = 0.6
CAM_SIZES = ((1920, 1080), (1280, 720))
RT_AUDIO_ATOL = 1e-4     # the port's CUDA-vs-CPU tolerance, as CPU_RENDER_ATOL
COMPOSITE_LSB = 1        # tests/test_video.py:197 and :215
FOLD_LSB = 2             # tests/test_video.py:318, smooth content
FADES = (0, 1, 127, 128, 254, 255)
CROSSFADE_SHAPES = ((1080, 1920), (540, 960), (36, 100), (1, 1), (7, 13), (17, 31), (5, 13),
                    (1025, 16))
FLUSH_BYTES = 128 * 2**20  # written between launches: more than the 50 MB L2
# (what, (in_h, in_w), (out_h, out_w)) for the resize kernel vs its twin
RESIZE_CASES = (
    ("720p->1080p luma", (720, 1280), (1080, 1920)),
    ("720p->1080p chroma u", (360, 640), (540, 960)),
    ("720p->1080p chroma v", (360, 640), (540, 960)),
    ("540p->1080p luma", (540, 960), (1080, 1920)),
    ("540p->1080p chroma", (270, 480), (540, 960)),
    ("1080p->720p", (1080, 1920), (720, 1280)),
    ("1080->540", (1080, 1920), (540, 960)),
    ("240->256, 16 phases", (240, 240), (256, 256)),
    ("ragged widths", (98, 174), (147, 261)),
    ("ragged widths, rows halved", (100, 90), (50, 135)),
    ("2.75:1 down, 12 taps", (110, 330), (40, 120)),
    ("zero weights inside the taps", (26, 26), (18, 22)),
)
# (what, [(in_h, in_w) per plane], [(out_h, out_w) per plane]): pictures in
# one resize launch each
RESIZE_PICTURES = (
    ("720p->1080p yuv420p", [(720, 1280), (360, 640), (360, 640)],
     [(1080, 1920), (540, 960), (540, 960)]),
    ("540p->1080p yuv420p", [(540, 960), (270, 480), (270, 480)],
     [(1080, 1920), (540, 960), (540, 960)]),
    ("an unchanged plane", [(720, 1280), (360, 640), (360, 640)],
     [(1080, 1920), (360, 640), (540, 960)]),
    ("one resized axis per plane", [(720, 1280), (360, 640), (98, 174)],
     [(720, 1920), (540, 640), (147, 174)]),
)
PASSTHROUGH_S = (384_000, 384_001)
# the composite path: config 5's video half (bench.py:474-496), 1080p30
COMPOSITE_FRAMES = 60
COMPOSITE_SRC = (540, 960)  # gradient_rgb(960, 540, t); out is twice each side
COMPOSITE_FADE = 128


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def fmp4_boxes(data: bytes, start: int = 0, end=None):
    """[(type, payload start, box end)] of the ISO-BMFF boxes in data[start:end]."""
    end = len(data) if end is None else end
    out = []
    while start + 8 <= end:
        size = int.from_bytes(data[start:start + 4], "big")
        kind = data[start + 4:start + 8].decode("latin-1")
        if size < 8 or start + size > end:
            raise AssertionError(f"fmp4: bad {kind!r} box of {size} bytes at {start}")
        out.append((kind, start + 8, start + size))
        start += size
    if start != end:
        raise AssertionError(f"fmp4: {end - start} trailing bytes")
    return out


def parse_fmp4(data: bytes) -> dict:
    """Walk a fragmented MP4 as the monitor writes it: ``ftyp``, ``moov``
    (a ``trak`` per track, its sample entry ``avc1`` or ``mp4a``), then
    ``moof``/``mdat`` pairs; -> {"codecs": {track id: entry}, "samples":
    {entry: sample count}, "fragments": n}.  Raises on any other layout."""
    top = fmp4_boxes(data)
    kinds = [k for k, _, _ in top]
    if kinds[:2] != ["ftyp", "moov"] or kinds[2:] != ["moof", "mdat"] * ((len(kinds) - 2) // 2):
        raise AssertionError(f"fmp4 layout {kinds[:6]}... ({len(kinds)} boxes)")

    def child(s, e, *path):
        for kind in path:
            s, e = next((a, b) for k, a, b in fmp4_boxes(data, s, e) if k == kind)
        return s, e

    codecs = {}
    for kind, s, e in fmp4_boxes(data, top[1][1], top[1][2]):
        if kind == "trak":
            ts, _ = child(s, e, "tkhd")
            track = int.from_bytes(data[ts + 12:ts + 16], "big")  # version 0
            ss, se = child(s, e, "mdia", "minf", "stbl", "stsd")
            entry = fmp4_boxes(data, ss + 8, se)[0][0]
            codecs[track] = entry
    samples = {entry: 0 for entry in codecs.values()}
    for kind, s, e in top[2::2]:
        ts, te = child(s, e, "traf")
        hs, _ = child(ts, te, "tfhd")
        track = int.from_bytes(data[hs + 4:hs + 8], "big")
        rs, _ = child(ts, te, "trun")
        samples[codecs[track]] += int.from_bytes(data[rs + 4:rs + 8], "big")
    return {"codecs": codecs, "samples": samples, "fragments": (len(top) - 2) // 2}


# --------------------------------------------------------------------------
# kernel vs twin checks


def tile_edge_gates(np, kind, S, T, n_blocks, rng):
    """Gates for ``n_blocks`` blocks of S samples in tiles of T, with edges
    alternately rising and falling: ``"tile_edges"`` at T-1, T and T+1 of
    every tile boundary of each block and on its first and last sample,
    ``"every_tile"`` at one random sample of every tile."""
    if kind == "tile_edges":
        at = {0, S - 1}
        for b in range(T, S + 1, T):
            at.update(t for t in (b - 1, b, b + 1) if t < S)
    else:
        at = {min(b + int(rng.integers(0, T)), S - 1) for b in range(0, S, T)}
    x = np.full(n_blocks * S, 0.5, np.float32)
    edges = sorted(blk * S + t for blk in range(n_blocks) for t in at)
    x[edges] = np.resize(np.array([1.0, 0.0], np.float32), len(edges))
    return x


def launch_tiles(envc, S):
    """(G, T) of each launch of an envelope block of S samples on card 0."""
    part = -(-S // -(-S // envc.MAX_KERNEL_S))
    lane, tiles = envc.tile_plan(part, envc.resident_tiles(0))
    return tiles, envc.THREADS * lane


def check_envelope(torch, np, dev):
    from mixlab_tpu_torch.dsp import envelope_cuda as envc

    params = {k: torch.tensor(v, device=dev) for k, v in dict(
        attack_ms=25.0, decay_ms=500.0, sustain_amplitude=0.8, release_ms=200.0).items()}

    def state0():
        return {"mode_on": torch.tensor(False, device=dev),
                "on_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
                "off_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
                "off_amp": torch.tensor(0.0, device=dev)}

    def gates(kind, S, T, rng):
        n = 3 * S
        if kind == "open":  # all the flagship's trigger sends
            return np.ones(n, np.float32)
        if kind == "dense":
            return rng.choice([0.0, 1.0, 0.5], size=n).astype(np.float32)
        if kind != "sparse":
            return tile_edge_gates(np, kind, S, T, 3, rng)
        x = np.full(n, 0.5, np.float32)  # sparse edges across block ends
        edges = sorted(set(rng.integers(0, n, 10).tolist() + [S - 1, S, 2 * S + 1]))
        for i, e in enumerate(edges):
            x[e] = 1.0 if i % 2 == 0 else 0.0
        return x

    worst = 0.0
    T0 = envc.TILE
    for S in (735, T0 - 1, T0, T0 + 1, 44_100, 48_000, 384_000, envc.MAX_KERNEL_S + 1):
        G, T = launch_tiles(envc, S)
        for kind in ("open", "dense", "sparse", "tile_edges", "every_tile"):
            rng = np.random.default_rng(S)
            x_all = torch.from_numpy(gates(kind, S, T, rng)).to(dev)
            st_k, st_t = state0(), state0()
            for blk in range(3):
                x = x_all[blk * S:(blk + 1) * S]
                got, st_k = envc.envelope_block_cuda(x, st_k, params, MS_PER_SAMPLE)
                want, st_t = envc.envelope_block_torch(x, st_t, params, MS_PER_SAMPLE)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                amp_err = abs(st_k["off_amp"].item() - st_t["off_amp"].item())
                if not (err <= ENV_ATOL and amp_err <= ENV_ATOL):
                    raise AssertionError(f"envelope S={S} {kind} block {blk}: "
                                         f"out err {err}, off_amp err {amp_err}")
                for k in ("mode_on", "on_pos", "off_pos"):
                    if st_k[k].item() != st_t[k].item():
                        raise AssertionError(f"envelope S={S} {kind} block {blk}: "
                                             f"{k} {st_k[k].item()} != {st_t[k].item()}")
                worst = max(worst, err, amp_err)
            log(f"envelope kernel vs twin S={S} (G={G} tiles of T={T} per launch) {kind}: ok "
                f"(3 blocks)")
    return worst


def check_eq(torch, np, dev):
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

    f_lo = _filter_coeff(FREQ_LO, 44_100)
    f_hi = _filter_coeff(FREQ_HI, 44_100)
    gains = torch.tensor([1.5849, 1.0, 1.5849], device=dev)
    worst = 0.0
    for S in eq_edge_sizes(eqc):
        run, G = eqc.scan_plan(min(S, eqc.MAX_KERNEL_S), eqc.resident_tiles(dev.index or 0))
        rng = np.random.default_rng(S)
        p_k = torch.from_numpy(rng.uniform(-0.1, 0.1, (4, 2)).astype(np.float32)).to(dev)
        p_t = p_k.clone()
        hist = torch.zeros(3, device=dev)
        for blk in range(3):
            x = torch.from_numpy(rng.uniform(-1, 1, S).astype(np.float32)).to(dev)
            xd = torch.cat([hist, x])[:S]
            hist = x[-3:]
            got, p_k = eqc.eq_cascade_cuda(x, xd, p_k, gains, f_lo, f_hi, VSA)
            want, p_t = eqc.eq_cascade_torch(x, xd, p_t, gains, f_lo, f_hi, VSA)
            torch.cuda.synchronize()
            for name, g, w in (("out", got, want), ("poles", p_k, p_t)):
                err = (g - w).abs()
                if not bool((err <= EQ_TOL["atol"] + EQ_TOL["rtol"] * w.abs()).all()):
                    raise AssertionError(f"eq S={S} block {blk} {name}: max err "
                                         f"{err.max().item()}")
                worst = max(worst, err.max().item())
        log(f"eq kernel vs twin S={S} (G={G} CTAs of {eqc.THREADS} threads x L={run} samples "
            f"per launch): ok (3 blocks)")
    return worst


def eq_edge_sizes(eqc):
    """Block sizes at the eq kernel's edges: one sample, a run and one past
    it, a CTA's tile and one either side, the gate, both rates' blocks, the
    split bound and one past it."""
    L, T = eqc.RUN, eqc.THREADS * eqc.RUN
    return (1, L - 1, L + 1, T - 1, T, T + 1, eqc.PALLAS_THRESHOLD, 44_100, 48_000,
            eqc.MAX_KERNEL_S, eqc.MAX_KERNEL_S + 1)


# --------------------------------------------------------------------------
# region kernel vs twin


def sink_zoo():
    """tests/test_pallas_graph.py:_sink_zoo, built with the port: an
    eq-seeded graph with every sink kind and a StreamInput feed."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.protocol import InputId, OutputId

    ws = Workspace()

    def add(kind, params):
        return ws.create_module(p.ModuleParams(kind, params))

    osc = add("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW))
    si = add("StreamInput", p.StreamInputParams())
    eq = add("EqThree", p.EqThreeParams(p.Decibel(3.0), p.Decibel(-2.0), p.Decibel(1.0)))
    mix = add("Mixer", p.MixerParams.with_channels(2))
    out = add("OutputDevice", None)
    plot = add("Plotter", None)
    so = add("StreamOutput", p.StreamOutputParams())
    pan = add("StereoPanner", None)
    for i, o in ((InputId(eq, 0), OutputId(osc, 0)), (InputId(mix, 0), OutputId(si, 1)),
                 (InputId(pan, 0), OutputId(eq, 0)), (InputId(pan, 1), OutputId(eq, 0)),
                 (InputId(mix, 1), OutputId(pan, 0)), (InputId(out, 0), OutputId(mix, 0)),
                 (InputId(plot, 0), OutputId(mix, 0)), (InputId(so, 1), OutputId(mix, 1))):
        ws.connect(i, o)
    return ws, si


class HoldRegion:
    """Inside ``with``: every launch of the region kernel is followed by its
    twin on the same inputs (plan, operands, params, state), and the
    outputs (taps, scalar taps, exits) are compared.  The twin's result is
    dropped, so the kernel's exits carry on to the next part and block."""

    def __init__(self, torch, atol=REGION_ATOL):
        self.torch, self.atol = torch, atol
        self.worst, self.launches, self.captured = 0.0, 0, []

    def __enter__(self):
        from mixlab_tpu_torch.engine import region_cuda

        self.mod, self.kernel = region_cuda, region_cuda.region_part_cuda

        def both(plan, operands, pf, sf, S, consts=None):
            got = self.kernel(plan, operands, pf, sf, S, consts)
            want = region_cuda.region_part_torch(plan, operands, pf, sf, S, consts)
            self.torch.cuda.synchronize()
            for name, g, w in zip(("taps", "stap", "ef"), got, want):
                err = (g - w).abs().max().item() if g.numel() else 0.0
                if not err <= self.atol:
                    raise AssertionError(f"region kernel vs twin ({name}, S={S}): "
                                         f"max abs err {err} > {self.atol}")
                self.worst = max(self.worst, err)
            self.launches += 1
            # the parameter row with the constants, as a single part takes it
            row = pf if consts is None else self.torch.cat([pf, consts])
            self.captured.append((plan, list(operands), row, sf, S))
            return got

        # the wrapper counts into whatever the module's name points at: these
        # launches go to ``both.launches``, not to the main path's count
        both.launches = self.kernel.launches
        region_cuda.region_part_cuda = both
        return self

    def __exit__(self, *exc):
        self.mod.region_part_cuda = self.kernel


def _run_blocks(patch, ws, n_blocks, feeds=None):
    aux, state = patch.prepare_aux(ws), patch.init_state(ws)
    spb = patch.block.n_samples(patch.cfg)
    per_block = []
    for i in range(n_blocks):
        state, taps = patch.run(aux, patch.host_aux(i * spb, (feeds or {}).get(i)), state)
        per_block.append(taps)
    return state, per_block


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _tree_err(a, b, what):
    la, lb = list(_leaves(a)), list(_leaves(b))
    if [k for k, _ in la] != [k for k, _ in lb]:
        raise AssertionError(f"{what}: tree structure differs")
    worst = 0.0
    for (k, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what} {k}: {x.dtype} {tuple(x.shape)} vs "
                                 f"{y.dtype} {tuple(y.shape)}")
        worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst


def check_region(torch, np, dev):
    """Region kernel vs twin (every launch, 3 carried blocks per graph) and
    the region program vs the regular one on the card."""
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph

    cfg = EngineConfig(sample_rate=48_000)
    zoo, si = sink_zoo()
    rng = np.random.default_rng(7)
    zoo_feeds = {i: {str(si.value): {"pcm": rng.integers(
        -32768, 32767, (2, 48_000)).astype(np.int16)}} for i in range(3)}
    worst = 0.0
    for name, ws, ticks, feeds, parts in (
        ("flagship", build_16_module_graph()[0], 60, None, 1),
        ("flagship", build_16_module_graph()[0], 300, None, 2),
        ("sink zoo", zoo, 60, zoo_feeds, 1),
    ):
        block = BlockSpec(ticks)
        pm = compile_patch(ws, cfg, block, dev)
        if not pm._mega:
            raise AssertionError(f"{name}: the region program did not engage")
        with HoldRegion(torch) as hold:
            sm, tm = _run_blocks(pm, ws, 3, feeds)
        if hold.launches != 3 * parts:
            raise AssertionError(f"{name}: {hold.launches} region launches, want {3 * parts}")
        pr = compile_patch(ws, cfg, block, dev, mega=False)
        sr, tr = _run_blocks(pr, ws, 3, feeds)
        prog_err = max(_tree_err(sm, sr, "state"),
                       *(_tree_err(a, b, "taps") for a, b in zip(tm, tr)))
        if not prog_err <= REGION_ATOL:
            raise AssertionError(f"{name}: region vs regular program err {prog_err}")
        worst = max(worst, hold.worst)
        log(f"region kernel vs twin, {name}, S={block.n_samples(cfg)} ({parts} part(s)/block), "
            f"3 blocks: max abs err {hold.worst:.3e}; region vs regular program "
            f"{prog_err:.3e} (atol {REGION_ATOL})")
    return worst


# --------------------------------------------------------------------------
# main path


def oracle_flagship(n: int, sr: int):
    """The flagship graph composed from tests/oracle.py in float64, as
    tests/test_whole_graph_oracle.py composes it (at any sample rate)."""
    import numpy as np
    import oracle

    gate = np.ones(n, dtype=np.float32)
    env, _ = oracle.envelope(0, gate, 25.0, 500.0, 0.8, 200.0, sr)
    amps = []
    for i in range(4):
        mono = oracle.oscillator(0, n, 110.0 * (i + 1), "sine", sr)
        amps.append(oracle.amplifier(np.stack([mono, mono], -1), env, 0.5, 0.3))
    fm_mono = oracle.fm_sine(0, env, 440.0, 880.0, sr)
    fm = np.stack([fm_mono, fm_mono], -1)
    eq_l, _ = oracle.eq_three(amps[0][:, 0], 4.0, 0.0, 4.0, sr)
    pan = np.stack([eq_l, amps[0][:, 1]], -1)
    inputs = [amps[0], amps[1], amps[2], amps[3], fm, pan, amps[1], amps[2]]
    master, _ = oracle.mixer(inputs, [0.0] * 8, [1.0] * 8, [False] * 8)
    return master


def main_path(torch, np, proj: Path, tmp: Path, sample_rate: int):
    """``render_cli`` for 10 s at ``sample_rate`` on the card, with the launch
    counts set to 0 just before and read just after."""
    import wave

    from mixlab_tpu_torch import render_cli

    counters = launch_counters()
    out_wav = tmp / f"flagship_{sample_rate}.wav"
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    audio = render_cli.main([str(proj), str(out_wav), "--seconds", "10",
                             "--sample-rate", str(sample_rate)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"main path {sample_rate} Hz: render_cli 10 s on cuda in {wall:.3f} s, "
        f"launches {launches}")
    if sample_rate % 128 == 0:  # 60-tick blocks are whole chunks: the region
        want = {"envelope": (10, None), "region": (10, 10)}
    else:
        want = {"envelope": (10, None), "eq_cascade": (10, None)}
    for name, (lo, hi) in want.items():
        n = launches[name]
        if n < lo or (hi is not None and n != hi):
            raise AssertionError(f"main path {sample_rate} Hz launched the {name} kernel "
                                 f"{n} times (want {'exactly ' if hi else '>= '}{lo})")

    sr = sample_rate
    if audio.shape != (10 * sr, 2) or not np.isfinite(audio).all():
        raise AssertionError(f"render output {audio.shape}, finite={np.isfinite(audio).all()}")
    with wave.open(str(out_wav), "rb") as w:
        head = (w.getframerate(), w.getnchannels(), w.getsampwidth(), w.getnframes())
        pcm = np.frombuffer(w.readframes(head[3]), "<i2").reshape(-1, 2)
    if head != (sr, 2, 2, audio.shape[0]):
        raise AssertionError(f"wav header (rate, channels, width, frames) = {head}")
    pcm_err = float(np.abs(pcm / 32767.0 - np.clip(audio, -1.0, 1.0)).max())
    if not pcm_err <= 2.0 / 32767:
        raise AssertionError(f"wav samples disagree with the returned audio: {pcm_err}")

    want_audio = oracle_flagship(2 * sr, sr)
    err_oracle = float(np.abs(audio[:2 * sr] - want_audio).max())
    log(f"main path {sr} Hz vs float64 oracle (first 2 s): max abs err {err_oracle:.3e} "
        f"(atol {ORACLE_ATOL})")
    if not err_oracle <= ORACLE_ATOL:
        raise AssertionError(f"{sr} Hz render disagrees with the oracle: max abs err "
                             f"{err_oracle:.3e} > {ORACLE_ATOL}")
    if not np.abs(audio).max() > 0.5:
        raise AssertionError(f"{sr} Hz render is near silent: peak {np.abs(audio).max():.3e}")

    def render(device, name):
        return render_cli.main([str(proj), str(tmp / name), "--seconds", "10",
                                "--sample-rate", str(sr), "--device", device])

    cpu_audio = render("cpu", f"cpu_{sr}.wav")
    err_cpu = float(np.abs(audio - cpu_audio).max())
    log(f"main path {sr} Hz cuda vs cpu render (10 s): max abs err {err_cpu:.3e} "
        f"(atol {CPU_RENDER_ATOL})")
    if not err_cpu <= CPU_RENDER_ATOL:
        raise AssertionError(f"{sr} Hz cuda render disagrees with the cpu render: " + mismatch_report(
            np, audio, cpu_audio, want_audio, sr,
            render("cuda", f"again_cuda_{sr}.wav"), render("cpu", f"again_cpu_{sr}.wav")))
    return launches


def mismatch_report(np, cuda, cpu, oracle_2s, sr, cuda_again, cpu_again) -> str:
    """Where and how two renders of the same project disagree, each side's
    distance from the float64 oracle, and whether a second render of each
    reproduces the first: what tells a wrong card result from a wrong CPU
    result and a fault that comes and goes from one that stays."""
    diff = np.abs(cuda - cpu)
    frame, ch = np.unravel_index(int(diff.argmax()), diff.shape)
    over = np.flatnonzero((diff > CPU_RENDER_ATOL).any(axis=-1))
    n = oracle_2s.shape[0]
    return (f"max abs err {diff.max():.3e} > {CPU_RENDER_ATOL} at frame {frame} channel {ch} "
            f"({frame / sr:.4f} s: cuda {float(cuda[frame, ch])!r}, "
            f"cpu {float(cpu[frame, ch])!r}); "
            f"{over.size} frames over, the first at {over[0] if over.size else None}; "
            f"vs the oracle over the first 2 s: cuda {np.abs(cuda[:n] - oracle_2s).max():.3e}, "
            f"cpu {np.abs(cpu[:n] - oracle_2s).max():.3e}; a second render equals the first: "
            f"cuda {np.array_equal(cuda, cuda_again)} (max abs diff "
            f"{np.abs(cuda - cuda_again).max():.3e}), cpu {np.array_equal(cpu, cpu_again)} "
            f"(max abs diff {np.abs(cpu - cpu_again).max():.3e}); second cuda vs first cpu "
            f"{np.abs(cuda_again - cpu).max():.3e}")


# --------------------------------------------------------------------------
# timing (information only)


def time_ms(torch, fn, n=200, warmup=20):
    """Mean time per call by CUDA events over n back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def eq_flops(S: int) -> int:
    """The EqThree recurrence's work once through the block (the scan
    kernels run it twice, the twin's Toeplitz form 64 times): per stage and
    band y = a*y + b and the next drive f*y (3, 8 stage-bands), the first
    drive f*x + vsa (2 per band), the band mix (5)."""
    return (8 * 3 + 2 * 2 + 5) * S


def region_work(plan, operands, S: int, batch: int = 1):
    """(bytes, flops) of one part over ``batch`` rows: every distinct operand
    read once (an operand the rows share once), the taps written once, the
    scalar rows, the constants once; the elementwise ops per sample and the
    eq's recurrence, each row."""
    from mixlab_tpu_torch.dsp import base

    nbytes = sum(v.numel() * v.element_size() for v in operands)
    nbytes += 4 * (batch * (plan.n_taps * S + plan.n_stap + plan.n_pf + 2 * plan.n_ef)
                   + plan.n_consts)
    per_sample = {base.OP_AMP: 1, base.OP_AMP_MOD: 4, base.OP_I16: 1, base.OP_PEAK: 3}
    flops = 0
    for code, a in plan.ops():
        if code == base.OP_MIX:
            flops += 2 * a[1] * S
        elif code == base.OP_EQ:
            flops += eq_flops(S)
        else:
            flops += per_sample.get(code, 0) * S
    return nbytes, flops * batch


def timing(torch, np, dev, card, proj: Path):
    from mixlab_tpu_torch.dsp import envelope_cuda as envc
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.engine.project import ProjectBase
    from mixlab_tpu_torch.engine.scan_render import scan_blocks

    S = 44_100
    x = torch.ones(S, device=dev)  # the flagship's gate
    st = {"mode_on": torch.tensor(False, device=dev),
          "on_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
          "off_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
          "off_amp": torch.tensor(0.0, device=dev)}
    prm = {k: torch.tensor(v, device=dev) for k, v in dict(
        attack_ms=25.0, decay_ms=500.0, sustain_amplitude=0.8, release_ms=200.0).items()}
    xe = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, S).astype(np.float32)).to(dev)
    xd = torch.cat([torch.zeros(3, device=dev), xe])[:S]
    poles = torch.zeros(4, 2, device=dev)
    gains = torch.tensor([1.5849, 1.0, 1.5849], device=dev)
    f_lo, f_hi = _filter_coeff(FREQ_LO, 44_100), _filter_coeff(FREQ_HI, 44_100)

    # one 48 kHz flagship block's region launch, captured from the program
    with ProjectBase(proj) as base:
        ws = Workspace.from_persist(base.read_workspace())
    cfg48 = EngineConfig(sample_rate=48_000)
    patches = {mega: compile_patch(ws, cfg48, BlockSpec(60), dev, mega=mega)
               for mega in (True, False)}
    with HoldRegion(torch) as hold:
        _run_blocks(patches[True], ws, 1)
    plan, operands, pf, sf, S48 = hold.captured[0]
    # and the first part of a 300-tick block (two parts per block)
    with HoldRegion(torch) as hold:
        _run_blocks(compile_patch(ws, cfg48, BlockSpec(300), dev), ws, 1)
    plan2, operands2, pf2, sf2, S2 = hold.captured[0]

    res = {}
    # plain, kernel, kernel, plain: the order spreads drift over both
    for name, shape, kern, plain, work in (
        ("envelope", f"S={S}", lambda: envc.envelope_block_cuda(x, st, prm, MS_PER_SAMPLE),
         lambda: envc.envelope_block_torch(x, st, prm, MS_PER_SAMPLE),
         (8 * S + 4 * 4 + 2 * 13, 12 * S)),
        ("eq_cascade", f"S={S}",
         lambda: eqc.eq_cascade_cuda(xe, xd, poles, gains, f_lo, f_hi, VSA),
         lambda: eqc.eq_cascade_torch(xe, xd, poles, gains, f_lo, f_hi, VSA),
         (12 * S + 4 * (8 + 8 + 3), eq_flops(S))),
        ("region", f"flagship 48 kHz block, S={S48}",
         lambda: region_cuda.region_part_cuda(plan, operands, pf, sf, S48),
         lambda: region_cuda.region_part_torch(plan, operands, pf, sf, S48),
         region_work(plan, operands, S48)),
        ("region_part_of_2", f"first part of a 300-tick 48 kHz block, S={S2}",
         lambda: region_cuda.region_part_cuda(plan2, operands2, pf2, sf2, S2),
         lambda: region_cuda.region_part_torch(plan2, operands2, pf2, sf2, S2),
         region_work(plan2, operands2, S2)),
    ):
        p1 = time_ms(torch, plain)
        k1 = time_ms(torch, kern)
        k2 = time_ms(torch, kern)
        p2 = time_ms(torch, plain)
        b_ms, b_by = bound(*work)
        res[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"timing {name} at {shape} [{card}]: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain twin {p1:.4f}/{p2:.4f} ms per call (CUDA events, 200 calls); "
            f"bound {b_ms * 1e3:.3f} us by {b_by} ({work[0]} B, {work[1]} flop)")

    # the envelope's device time per launch by tile length, the flagship's
    # open gate at both rates (the wrapper's tile is LANE = 2)
    for n in (44_100, 48_000):
        xo = torch.ones(n, device=dev)
        for lane in (1, 2, 4, 8):
            G, T = envc.tile_plan(n, envc.resident_tiles(0), lane)[1], envc.THREADS * lane
            found = _device_us(torch, lambda: envc._launch(xo, 0, st, prm, MS_PER_SAMPLE, lane),
                               "envelope_kernel", n=50)
            log(f"timing envelope kernel S={n}, G={G} tiles of T={T} [{card}]: device time "
                f"{'/'.join(f'{us:.3f}' for _, us, _ in found) or 'not measured'} us per "
                f"launch (profiler, 50 launches)" + (" <- the wrapper's tile" if lane == envc.LANE
                                                     else ""))
    envelope_call_pieces(torch, envc, card, x, st, prm)
    scan_kernels_device(torch, dev, card, res, (xe, xd, poles, gains, f_lo, f_hi),
                        (plan, operands, pf, sf, S48))

    # one whole 48 kHz block: the region program vs the regular program
    blk = {}
    for mega in (False, True, True, False):
        patch = patches[mega]
        aux, state = patch.prepare_aux(ws), patch.init_state(ws)
        host = patch.host_aux(0)
        blk.setdefault(mega, []).append(
            time_ms(torch, lambda: patch.run(aux, host, state), n=50, warmup=5))
    log(f"timing one 48 kHz flagship block [{card}]: region program "
        f"{blk[True][0]:.4f}/{blk[True][1]:.4f} ms, regular program (mega=False) "
        f"{blk[False][0]:.4f}/{blk[False][1]:.4f} ms per block (CUDA events, 50 blocks)")
    res["block_48k"] = blk

    # 60 s of audio (60 blocks) at each rate; at 48 kHz with and without
    # the region, in turns
    def render_60s(sr, mega):
        patch = compile_patch(ws, EngineConfig(sample_rate=sr), BlockSpec(60), dev, mega=mega)
        aux, state = patch.prepare_aux(ws), patch.init_state(ws)
        torch.cuda.synchronize()
        t = time.perf_counter()
        scan_blocks(patch, aux, state, 0, 60)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for sr, mega in ((44_100, None), (48_000, None), (48_000, False)):
        render_60s(sr, mega)  # warm-up
    walls = {}
    for _ in range(3):
        for key in ((44_100, None), (48_000, None), (48_000, False), (48_000, False),
                    (48_000, None)):
            walls.setdefault(key, []).append(render_60s(*key))
    for (sr, mega), w in walls.items():
        label = {None: "default", False: "mega=False"}[mega]
        log(f"timing render 60 s of audio at {sr} Hz ({label}) [{card}]: wall "
            f"{[round(x, 4) for x in w]} s, realtime factor {[round(60.0 / x, 1) for x in w]} x")

    for sr in (44_100, 48_000):
        busy_us = profile_blocks(torch, ws, dev, card, sr)
        wall_us = sorted(walls[(sr, None)])[1] / 60 * 1e6  # the median 60-block render
        share = f"{100 * busy_us / wall_us:.2f}%" if busy_us else "not measured"
        log(f"device time per {sr} Hz block {busy_us:.3f} us (profiler) against {wall_us:.3f} us "
            f"of unprofiled wall per block (the median 60 s render): busy {share} [{card}]")
    return res


def scan_kernels_device(torch, dev, card, res, eq_args, region_args):
    """The eq and region kernels' device time per launch (profiler), device
    launches per call and share of the bound at the main path's shapes, then
    the sweep of the run L and the CTA size T that chose the wrappers'
    defaults: eq at 44,100 and 48,000 samples, region at the 48 kHz block."""
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import VSA
    from mixlab_tpu_torch.engine import region_cuda

    xe, xd, poles, gains, f_lo, f_hi = eq_args
    plan, operands, pf, sf, S48 = region_args
    n = 50
    index = dev.index or 0
    for key, name, shape, call in (
        ("eq_cascade", "eq_cascade_kernel", f"S={xe.shape[0]}",
         lambda: eqc.eq_cascade_cuda(xe, xd, poles, gains, f_lo, f_hi, VSA)),
        ("region", "region_kernel", f"flagship 48 kHz block, S={S48}",
         lambda: region_cuda.region_part_cuda(plan, operands, pf, sf, S48)),
    ):
        for _ in range(3):  # a profile that lost device records is taken again
            found = _device_us(torch, call, "", n=n)  # every device item of a call
            kernels_ = [(k, c) for k, _, c in found if not k.startswith(("Memcpy", "Memset"))]
            per_call = sum(c for _, c in kernels_) / n
            if per_call >= 1:
                break
            log(f"timing {key}: the profile recorded {per_call:g} kernels a call; taken again")
        mine = [(k, us, c) for k, us, c in found if name in k]
        if not mine:
            log(f"timing {key} device time at {shape} [{card}]: not measured")
            continue
        us = mine[0][1]
        copies = [(k, c) for k, _, c in found if k.startswith(("Memcpy", "Memset"))]
        share = res[key]["bound_ms"] * 1e3 / us
        res[key].update(device_us=us, device_launches_per_call=per_call)
        log(f"timing {key} kernel at {shape} [{card}]: device time {us:.3f} us per launch, "
            f"{per_call:g} kernel launches per call ({', '.join(k[:40] for k, _ in kernels_)}; "
            f"copies per call: {', '.join(f'{k[:30]} {c / n:g}' for k, c in copies) or 'none'}), "
            f"{100 * share:.1f}% of the bound (profiler, {n} calls)")
        if key == "eq_cascade" and per_call != 1:
            raise AssertionError(f"eq_cascade: {per_call} device launches per call, want 1")

    for S in (44_100, 48_000):
        x = xe[:S] if S <= xe.shape[0] else torch.cat([xe, xe])[:S]
        xdd = torch.cat([xd[:3], x])[:S]
        want = eqc.eq_cascade_torch(x, xdd, poles, gains, f_lo, f_hi, VSA)
        for T in (64, 128, 256, 512):
            row = []
            for L in (2, 4, 8, 16, 32):
                run, G = eqc.scan_plan(S, eqc.resident_tiles(index, T), T, L)
                if run != L:
                    continue
                f = lambda: eqc._launch(x, xdd, poles, gains, f_lo, f_hi, VSA, index, T, L)
                got = f()
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if not bool(((g - w).abs() <= EQ_TOL["atol"] + EQ_TOL["rtol"] * w.abs()).all()):
                        raise AssertionError(f"eq sweep S={S} T={T} L={L}: max err "
                                             f"{(g - w).abs().max().item()}")
                found = _device_us(torch, f, "eq_cascade_kernel", n=n)
                row.append(f"L={L} (G={G}) " + ("/".join(f"{us:.3f}" for _, us, _ in found)
                                                or "not measured"))
            log(f"timing eq sweep S={S} T={T} [{card}]: device us per launch: " + "; ".join(row)
                + (" <- the wrapper's T" if T == eqc.THREADS else ""))
    row = []
    for L in (1, 2, 4, 8, 16):
        f = lambda: region_cuda.region_part_cuda(plan, operands, pf, sf, S48, run=L)
        found = _device_us(torch, f, "region_kernel", n=n)
        row.append(f"L={L} (G={-(-S48 // (region_cuda.CHUNK * L))}) "
                   + ("/".join(f"{us:.3f}" for _, us, _ in found) or "not measured"))
    log(f"timing region sweep S={S48} [{card}]: device us per launch by run "
        f"(wrapper L={region_cuda.RUN}): " + "; ".join(row))
    region_breakdown(torch, card, region_args, n)


def region_pieces(plan):
    """(a plan of one TAP: the launch and one op, ``plan`` with its EQ
    replaced by an AMP of the same input: the elementwise ops)."""
    from mixlab_tpu_torch.dsp import base

    tap = base.RegionPlan(n_operands=plan.n_operands, n_pf=plan.n_pf, n_ef=plan.n_ef)
    tap.add(base.OP_TAP, 0, 0)
    tap.n_taps, tap.n_consts, tap.n_stap = plan.n_taps, plan.n_consts, plan.n_stap
    no_eq = base.RegionPlan(n_operands=plan.n_operands, n_pf=plan.n_pf, n_ef=plan.n_ef)
    no_eq.n_slots, no_eq.n_consts = plan.n_slots, plan.n_consts
    no_eq.n_taps, no_eq.n_stap = plan.n_taps, plan.n_stap
    for code, a in plan.ops():
        if code == base.OP_EQ:  # dst = x * gains[0]
            no_eq.words += [base.OP_AMP, 5, a[0], a[1], a[4]]
        else:
            no_eq.words += [code, 2 + len(a), *a]
    return tap, no_eq


def region_breakdown(torch, card, region_args, n):
    """Where the region kernel's time goes at the 48 kHz block: a plan of
    one TAP (the launch, one op), the flagship's plan with its EQ replaced by
    an AMP of the same input (the elementwise ops), and the flagship's."""
    from mixlab_tpu_torch.engine import region_cuda

    plan, operands, pf, sf, S = region_args
    tap, no_eq = region_pieces(plan)
    row = []
    for what, pl in (("one TAP", tap), ("EQ as an AMP", no_eq), ("flagship", plan)):
        found = _device_us(torch, lambda: region_cuda.region_part_cuda(pl, operands, pf, sf, S),
                           "region_kernel", n=n)
        row.append(f"{what} " + ("/".join(f"{us:.3f}" for _, us, _ in found) or "not measured"))
    log(f"timing region breakdown S={S} [{card}]: device us per launch: " + "; ".join(row))


def profile_blocks(torch, ws, dev, card, sr):
    """Five render blocks under the profiler: device busy time, top kernels;
    returns the device time per block in us (0.0 when none was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.engine.scan_render import scan_blocks

    patch = compile_patch(ws, EngineConfig(sample_rate=sr), BlockSpec(60), dev)
    aux, state = patch.prepare_aux(ws), patch.init_state(ws)
    scan_blocks(patch, aux, state, 0, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        scan_blocks(patch, aux, state, 0, 5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side entries only (kernels, copies): the host ops that
    # launched them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us > 0:
        log(f"profile 5 render blocks at {sr} Hz (region {patch._mega}) [{card}]: wall "
            f"{wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({100 * busy_us / (wall * 1e6):.1f}% of the profiled wall), "
            f"{sum(e.count for e in events)} kernels and copies")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    else:
        log("profile: no device time recorded (not measured)")
    return busy_us / 5


# --------------------------------------------------------------------------
# the realtime engine tick with live video


def check_crossfade(torch, np, dev):
    """Crossfade kernel vs its twin on the card, exact: each plane alone at
    every fade (n % 16 of 0, 1, 11 and 15; vector counts that leave the last
    CTA ragged), a plane at an odd byte offset (the kernel's ragged range),
    and three-plane launches of mixed sizes against single-plane twins: a
    1080p picture, three small planes, and a ragged plane beside the odd
    one."""
    from mixlab_tpu_torch.video import blend

    rng = np.random.default_rng(5)

    def u8(n):
        return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)

    pairs = [(u8(s), u8(s)) for s in CROSSFADE_SHAPES]
    buf = u8(2 * 1920 * 1080 + 2)
    odd = (buf[1:1 + 1920 * 1080].view(1080, 1920), buf[-1920 * 1080 - 1:-1].view(1080, 1920))
    triples = [[pairs[0], pairs[1], (u8((540, 960)), u8((540, 960)))], pairs[2:5],
               [pairs[7], pairs[5], odd]]
    worst = 0
    for fade in FADES:
        for a, b in pairs + [odd]:
            (got,) = blend.crossfade_cuda([a], [b], fade)
            worst = max(worst, _lsb(torch, got, blend.crossfade_torch(a, b, fade)))
        for triple in triples:
            got = blend.crossfade_cuda([a for a, _ in triple], [b for _, b in triple], fade)
            for g, (a, b) in zip(got, triple):
                worst = max(worst, _lsb(torch, g, blend.crossfade_torch(a, b, fade)))
    torch.cuda.synchronize()
    log(f"crossfade kernel vs twin: planes {list(CROSSFADE_SHAPES)} and one at byte offset 1, "
        f"fades {list(FADES)}, single- and three-plane launches: max abs err {worst}")
    if worst != 0:
        raise AssertionError("the crossfade kernel disagrees with its twin")
    return float(worst)


def check_scale(torch, np, dev):
    """``scale_picture`` 1280x720 -> 1920x1080 on the card against the CPU:
    ``"int8"`` exact (an exact integer product, then the same f32 epilogue),
    ``"f32"`` within 1 LSB (the products sum in another order)."""
    from mixlab_tpu_torch.video import scale
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings

    rng = np.random.default_rng(9)
    (w, h), out = CAM_SIZES[1], PictureSettings(*CAM_SIZES[0])
    planes = {"y": rng.integers(0, 256, (h, w), dtype=np.uint8),
              "u": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
              "v": rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)}
    pic = Picture(PictureSettings(w, h), planes)
    for method, limit in (("int8", 0), ("f32", COMPOSITE_LSB)):
        got = scale.scale_picture(pic.to(dev), out, method)
        want = scale.scale_picture(pic.to("cpu"), out, method)
        err = max(_lsb(torch, got.planes[k].cpu(), want.planes[k]) for k in planes)
        log(f"scale_picture {w}x{h} -> {out.width}x{out.height} ({method}) cuda vs cpu: "
            f"max abs err {err} LSB (limit {limit})")
        if err > limit:
            raise AssertionError(f"scale_picture {method} on the card disagrees with the CPU")


def _lsb(torch, got, want) -> int:
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item())


def cam_frames(torch, np, dev, tick, sizes=CAM_SIZES):
    """Tick ``tick``'s ingest as numpy, the form ingest hands it in: a bars
    frame (phase = tick) for cam1 and a gradient frame (t = tick) for cam2,
    made on the card and fetched, and 735 samples of i16 stereo."""
    from mixlab_tpu_torch.video.pattern import pattern_picture

    pics = [pattern_picture(kind, w, h, tick, device=dev).to_numpy()
            for kind, (w, h) in zip(("bars", "gradient"), sizes)]
    pcm = np.random.default_rng(tick).integers(-3000, 3000, (RT_SPT, 2), dtype=np.int16)
    return pics, pcm


class Cameras:
    """Publishers on RTMP mountpoints, writing as an ingest thread does: per
    tick one video frame of a 1-tick duration and 735 samples per camera."""

    def __init__(self, names, sizes=CAM_SIZES):
        from mixlab_tpu_torch.io_host import source

        self.sizes = sizes
        self.sends = [source.RTMP_MOUNTPOINTS.connect(name) for name in names]

    def publish(self, tick, frames, hold: int = 1) -> bool:
        """``hold``: the frames' duration in ticks."""
        from mixlab_tpu_torch.utils.mtime import MediaDuration, MediaTime
        from mixlab_tpu_torch.video.frame import Picture, PictureSettings, VideoFrame

        planes, pcm = frames
        t = MediaTime.new(tick * RT_SPT, RT_RATE)
        ok = True
        for send, size, pl in zip(self.sends, self.sizes, planes):
            vf = VideoFrame(Picture(PictureSettings(*size), pl),
                            duration_hint=MediaDuration.new(hold, 60))
            ok = send.write_audio(t, pcm) and send.write_video(t, vf) and ok
        return ok

    def close(self):
        for send in self.sends:
            send.close()


class NoCodec:
    """Stands in for the Monitor's codec thread (``MonitorPipeline``) where a
    phase reads the monitor pipe itself."""

    socket_id = "no-codec"

    def __init__(self, pipe, cfg):
        pass

    def start(self):
        pass

    def stop(self):
        pass


def realtime_engine(device, cams, pipeline_depth=0):
    """The port's ``Engine`` at 44.1 kHz, ``block_ticks=1``, built by one
    session's client ops: the flagship graph and, with ``cams``, two
    StreamInputs on those RTMP mountpoints and a VideoMixer(a=0, b=1,
    fader=0.6) feeding the Monitor's video input.  The Monitor gets no
    codec thread (``NoCodec``): the caller reads its pipe.  Returns
    (engine, ids, session id)."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.engine import Engine
    from mixlab_tpu_torch.flagship import realtime_video_ops
    from mixlab_tpu_torch.server import monitor

    eng = Engine(cfg=EngineConfig(sample_rate=RT_RATE), block_ticks=1, device=device,
                 pipeline_depth=pipeline_depth)
    sid, _, events = eng.connect_session()
    ops, ids = realtime_video_ops(p, cams)
    real, monitor.MonitorPipeline = monitor.MonitorPipeline, NoCodec
    try:
        for seq, op in enumerate(ops, 1):
            eng.update(sid, p.WorkspaceMessage(seq, op))
            while not events.empty():  # read the broadcast, as a browser does
                events.get_nowait()
    finally:
        monitor.MonitorPipeline = real
    n_links = sum(isinstance(op, p.CreateConnection) for op in ops)
    if (len(eng.ws.modules), len(eng.ws.connections)) != (len(ops) - n_links, n_links):
        raise AssertionError(f"the client ops built {len(eng.ws.modules)} modules and "
                             f"{len(eng.ws.connections)} connections")
    return eng, ids, sid


def launch_counters():
    from mixlab_tpu_torch.dsp.envelope_cuda import envelope_block_cuda
    from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_cuda
    from mixlab_tpu_torch.engine.region_cuda import region_part_cuda
    from mixlab_tpu_torch.tools.profile_env_eq import passthrough_cuda
    from mixlab_tpu_torch.video.blend import crossfade_cuda
    from mixlab_tpu_torch.video.resize_cuda import resize_picture_polyphase

    return {"envelope": envelope_block_cuda, "eq_cascade": eq_cascade_cuda,
            "region": region_part_cuda, "crossfade": crossfade_cuda,
            "resize": resize_picture_polyphase, "passthrough": passthrough_cuda}


def realtime_path(torch, np, dev, n_ticks=120, n_cpu=10):
    """The realtime main path: the port's Engine on the card in direct drive
    for ``n_ticks`` ticks, each publishing a new 1080p and 720p frame; the
    launch counts set to 0 just before and read just after.  Each tick's
    composite is held against the twin on the same stored pictures
    (exact), and the first ``n_cpu`` ticks against a CPU Engine fed the
    same ingest (composites within 1 LSB, monitor audio within 1e-4)."""
    from mixlab_tpu_torch.video.blend import crossfade_torch

    eng, ids, _ = realtime_engine(str(dev), ("cam1", "cam2"))
    ref, ref_ids, _ = realtime_engine("cpu", ("cpu-cam1", "cpu-cam2"))
    cams, ref_cams = Cameras(("cam1", "cam2")), Cameras(("cpu-cam1", "cpu-cam2"))
    pipe, ref_pipe = eng.monitor_pipe(ids["monitor"]), ref.monitor_pipe(ref_ids["monitor"])
    mixer = eng._video_mixers[ids["mixer"]]
    fade = int(RT_FADER * 255.0)  # the engine's truncating cast
    w, h = CAM_SIZES[0]
    shapes = {"y": (h, w), "u": (h // 2, w // 2), "v": (h // 2, w // 2)}
    audio_err, lsb, peak = 0.0, 0, 0.0
    counters = launch_counters()
    try:
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        for tick in range(n_ticks):
            frames = cam_frames(torch, np, dev, tick)
            if not cams.publish(tick, frames):
                raise AssertionError(f"ingest refused tick {tick}'s frames")
            eng.tick_once()
            t0, audio, video = pipe.q.get(timeout=10)
            if t0 != tick * RT_SPT or audio.shape != (RT_SPT, 2) or not np.isfinite(audio).all():
                raise AssertionError(f"tick {tick}: monitor audio t0={t0} {audio.shape}")
            peak = max(peak, float(np.abs(audio).max()))
            got = video.picture.planes if video is not None else {}
            if {k: tuple(v.shape) for k, v in got.items()} != shapes:
                raise AssertionError(f"tick {tick}: no 1920x1080 composite in the monitor pipe")
            a_pic, b_pic = (mixer.channels[i].stored for i in (0, 1))
            for k in shapes:
                if not torch.equal(got[k], crossfade_torch(a_pic.planes[k], b_pic.planes[k],
                                                           fade)):
                    raise AssertionError(f"tick {tick}: composite plane {k} != the twin")
            if tick < n_cpu:
                if not ref_cams.publish(tick, frames):
                    raise AssertionError(f"cpu ingest refused tick {tick}'s frames")
                ref.tick_once()
                _, ref_audio, ref_video = ref_pipe.q.get(timeout=60)
                audio_err = max(audio_err, float(np.abs(audio - ref_audio).max()))
                lsb = max(lsb, *(_lsb(torch, got[k].cpu(), ref_video.picture.planes[k])
                                 for k in shapes))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        cams.close()
        ref_cams.close()
        eng.stop()
        ref.stop()
    log(f"realtime main path: Engine(device={dev}) {n_ticks} ticks with 1080p + 720p ingest "
        f"in {wall:.3f} s (frame making included), launches {launches}; every composite "
        f"equals the twin; first {n_cpu} ticks vs the cpu Engine: audio max abs err "
        f"{audio_err:.3e} (atol {RT_AUDIO_ATOL}), composites max {lsb} LSB "
        f"(limit {COMPOSITE_LSB}); monitor peak {peak:.3f}")
    if launches["crossfade"] != n_ticks:
        raise AssertionError(f"the crossfade kernel launched {launches['crossfade']} times "
                             f"in {n_ticks} ticks")
    if not (audio_err <= RT_AUDIO_ATOL and lsb <= COMPOSITE_LSB and peak > 0.1):
        raise AssertionError(
            f"the cuda Engine disagrees with the cpu Engine (or is silent): audio max abs err "
            f"{audio_err:.3e} (atol {RT_AUDIO_ATOL}), composites {lsb} LSB (limit "
            f"{COMPOSITE_LSB}), monitor peak {peak:.3e} (want > 0.1)")
    return launches


def _tick_walls(torch, eng, cams, pipe, pool, n):
    """Host wall of ``n`` ticks, each ``tick_once`` then a synchronize; the
    publish before it and the monitor read after it are not timed."""
    walls = []
    for _ in range(n):
        tick = eng.tick
        if cams is not None and not cams.publish(tick, pool[tick % len(pool)]):
            raise AssertionError(f"ingest refused tick {tick}'s frames")
        t = time.perf_counter()
        eng.tick_once()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        pipe.q.get_nowait()
    return walls


def realtime_timing(torch, np, dev, card):
    """For information: the crossfade kernel vs its twin at 1080p, the
    letterbox scale by method, ``tick_once`` with and without the video
    chain, a profile of 10 ticks, the edit path, and a threaded run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec
    from mixlab_tpu_torch.video import blend, scale
    from mixlab_tpu_torch.video.frame import PictureSettings
    from mixlab_tpu_torch.video.pattern import pattern_picture

    res = {}
    out = PictureSettings(*CAM_SIZES[0])
    a_pic = pattern_picture("bars", *CAM_SIZES[0], 3, device=dev)
    src = pattern_picture("gradient", *CAM_SIZES[1], 3, device=dev)
    b_pic = scale.scale_picture(src, out)
    al, bl = [a_pic.planes[k] for k in "yuv"], [b_pic.planes[k] for k in "yuv"]
    n_px = sum(t.numel() for t in al)
    # read a and b, write out; per pixel two products, a sum, a product and a shift
    nbytes, ops = 3 * n_px, 5 * n_px
    p1 = time_ms(torch, lambda: [blend.crossfade_torch(a, b, 153) for a, b in zip(al, bl)])
    k1 = time_ms(torch, lambda: blend.crossfade_cuda(al, bl, 153))
    k2 = time_ms(torch, lambda: blend.crossfade_cuda(al, bl, 153))
    p2 = time_ms(torch, lambda: [blend.crossfade_torch(a, b, 153) for a, b in zip(al, bl)])
    b_ms, b_by = bound(nbytes, ops)
    res["crossfade"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                        "bound_ms": b_ms, "bound_by": b_by}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            blend.crossfade_cuda(al, bl, 153)
        torch.cuda.synchronize()
    dev_us = [e.self_device_time_total / e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "crossfade" in e.key
              and e.self_device_time_total > 0]
    log(f"timing crossfade of a 1920x1080 yuv420p picture [{card}]: kernel {k1:.4f}/{k2:.4f} "
        f"ms, plain twin {p1:.4f}/{p2:.4f} ms per call (CUDA events, 200 calls); device time "
        f"{'/'.join(f'{u:.3f}' for u in dev_us) or 'not measured'} us per launch back to back "
        f"(profiler, 50 launches); bound {b_ms * 1e3:.3f} us by {b_by} ({nbytes} B, {ops} "
        f"integer ops); library call: none")
    # for a caller that finds the cache cold: the L2 flushed between launches
    # by a 128 MB write, which the profiler times apart from the crossfade
    # (the flush leaves L2 full of dirty lines, which the crossfade's own
    # lines evict: written back during it); then, for information, by the
    # write and a 128 MB read after it (clean lines: the crossfade's bytes
    # alone)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    clean = torch.ones(FLUSH_BYTES // 4, device=dev)
    flushes = {"a 128 MB write": lambda: flush.fill_(1),
               "a 128 MB write, again": lambda: flush.fill_(1),
               "a 128 MB write, then a 128 MB read": lambda: (flush.fill_(1), clean.sum())}
    for label, flush_l2 in flushes.items():
        def cold():
            flush_l2()
            blend.crossfade_cuda(al, bl, 153)

        found = _device_us(torch, cold, "crossfade_kernel", n=50)
        log(f"timing crossfade of a 1920x1080 yuv420p picture, L2 flushed between launches by "
            f"{label} [{card}]: device time " + (", ".join(
                f"{us:.3f} us per launch, {100 * b_ms * 1e3 / us:.1f}% of the bound"
                for _, us, _ in found) or "not measured") + " (profiler, 50 launches)")
    del flush, clean

    sc = {}
    for method in ("f32", "int8", "int8", "f32"):
        sc.setdefault(method, []).append(
            time_ms(torch, lambda: scale.scale_picture(src, out, method), n=100, warmup=10))
    log(f"timing scale_picture {CAM_SIZES[1][0]}x{CAM_SIZES[1][1]} -> "
        f"{out.width}x{out.height} letterboxed [{card}]: f32 {sc['f32'][0]:.4f}/"
        f"{sc['f32'][1]:.4f} ms, int8 {sc['int8'][0]:.4f}/{sc['int8'][1]:.4f} ms per picture "
        f"(CUDA events, 100 calls)")

    # tick_once with and without the video chain, in turns
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    rigs = {}
    try:
        for video in (True, False):
            names = ("t-cam1", "t-cam2") if video else ()
            eng, ids, sid = realtime_engine(str(dev), names)
            rigs[video] = (eng, Cameras(names) if video else None,
                           eng.monitor_pipe(ids["monitor"]), ids, sid)
        for video in (True, False):
            _tick_walls(torch, *rigs[video][:3], pool, 20)  # warm-up
        walls = {}
        for video in (True, False, False, True):
            walls.setdefault(video, []).extend(_tick_walls(torch, *rigs[video][:3], pool, 150))
        budget = 1.0 / 60
        for video, w in walls.items():
            w = np.asarray(w)
            label = "flagship + video" if video else "flagship only"
            log(f"timing tick_once ({label}, 300 ticks) [{card}]: median {np.median(w) * 1e3:.3f} "
                f"ms, p99 {np.percentile(w, 99) * 1e3:.3f} ms, max {w.max() * 1e3:.3f} ms, "
                f"{100 * float((w > budget).mean()):.1f}% over the 16.667 ms budget")
            res[f"tick_{'video' if video else 'audio'}"] = w

        eng, cams, pipe, ids, sid = rigs[True]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = sum(_tick_walls(torch, eng, cams, pipe, pool, 10))
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            log(f"profile 10 ticks (flagship + video) [{card}]: tick wall {wall * 1e3:.2f} ms, "
                f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / (wall * 1e6):.1f}% of "
                f"the wall), {sum(e.count for e in events)} kernels and copies")
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
                log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
            for e in events:
                if "crossfade" in e.key:
                    log(f"  crossfade kernel: {e.self_device_time_total / e.count:.3f} us "
                        f"device time per launch in the tick ({e.count} launches)")
        else:
            log("profile: no device time recorded (not measured)")

        # the edit path: compile_patch and the first block, then a client op
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            patch = compile_patch(eng.ws, eng.cfg, BlockSpec(1), dev)
            aux, state = patch.prepare_aux(eng.ws), patch.init_state(eng.ws)
            patch.run(aux, patch.host_aux(0), state)
            torch.cuda.synchronize()
            c_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            eng.update(sid, p.WorkspaceMessage(1000 + i, p.UpdateModuleParams(
                ids["mixer"], p.ModuleParams("VideoMixer", p.VideoMixerParams(
                    a=0, b=1, fader=RT_FADER)))))
            u_ms = (time.perf_counter() - t) * 1e3
            log(f"timing edit path {i} (flagship + video) [{card}]: compile_patch + first block "
                f"{c_ms:.3f} ms; a client op (VideoMixer params, rebuild included) {u_ms:.3f} ms")
    finally:
        for eng, cams, *_ in rigs.values():
            if cams is not None:
                cams.close()
            eng.stop()
    threaded_run(torch, np, dev, card, pool)
    return res


def threaded_run(torch, np, dev, card, pool, seconds=5.0):
    """``Engine.start()`` for ``seconds``, a feeder thread publishing both
    cameras at 60 fps; the monitor pipe read as a codec thread would."""
    eng, ids, _ = realtime_engine(str(dev), ("th-cam1", "th-cam2"))
    cams = Cameras(("th-cam1", "th-cam2"))
    pipe = eng.monitor_pipe(ids["monitor"])
    stop = threading.Event()
    fed = {"frames": 0, "refused": 0}

    def feeder():
        start = time.monotonic()
        k = 0
        while not stop.is_set():
            fed["refused"] += not cams.publish(k, pool[k % len(pool)])
            k += 1
            fed["frames"] = k
            stop.wait(max(0.0, start + k / 60 - time.monotonic()))

    th = threading.Thread(target=feeder, name="feeder")
    items = composites = 0
    try:
        eng.start()
        th.start()
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            try:
                composites += pipe.q.get(timeout=0.5)[2] is not None
                items += 1
            except queue.Empty:
                pass
        ticks, stat, info = eng.tick, eng._stat, eng.performance_info()
    finally:
        stop.set()
        th.join(timeout=5)
        eng.stop()
        cams.close()
    log(f"threaded run {seconds:.0f} s (flagship + video) [{card}]: {ticks} ticks "
        f"({ticks / seconds:.2f}/s), {fed['frames']} frames fed per camera ({fed['refused']} "
        f"refused), {items} monitor items read ({composites} with a composite, {pipe.dropped} "
        f"dropped); EngineStat: on-schedule {100 * stat.realtime_fraction_total:.1f}% of "
        f"{stat.total_ticks} ticks, max late {stat.total_max_late_s * 1e3:.3f} ms; last "
        f"report {info}")
    if ticks < 10 or composites < 1:
        raise AssertionError("the threaded engine did not run")



# --------------------------------------------------------------------------
# the video scale family and the profiling tool


def check_resize(torch, np, dev):
    """The resize kernel vs its twin on the card, exact: each geometry as
    one plane on both axes and on each axis alone, and whole pictures in one
    launch each; each plane within 1 LSB of the dense f32 resize; the
    passthrough kernel vs its twin, exact."""
    from mixlab_tpu_torch.tools import profile_env_eq as tool
    from mixlab_tpu_torch.video import resize_cuda as rc
    from mixlab_tpu_torch.video import scale

    rng = np.random.default_rng(13)

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def exact(what, planes, sizes):
        n = rc.resize_picture_polyphase.launches
        got = rc.resize_picture_polyphase(planes, sizes)
        want = rc.resize_picture_torch(planes, sizes)
        torch.cuda.synchronize()
        launched = rc.resize_picture_polyphase.launches - n
        resized = sum(tuple(x.shape) != tuple(s) for x, s in zip(planes, sizes))
        if launched != (1 if resized else 0):
            raise AssertionError(f"resize {what}: {launched} launches for one picture")
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(
                    f"resize kernel vs twin, {what}, plane {i}: "
                    f"{int((g.float() != w.float()).sum())} of {w.numel()} differ, max abs "
                    f"err {(g.float() - w.float()).abs().max().item()}")
        return got

    worst_dense = 0
    for what, src, dst in RESIZE_CASES:
        x = u8(src)
        for label, size in (("both axes", dst), ("rows alone", (dst[0], src[1])),
                            ("columns alone", (src[0], dst[1]))):
            (plane,) = exact(f"{what} {src}->{size} {label}", [x], [size])
            lsb = _lsb(torch, plane, scale.resize_plane(x, *size, "f32"))
            worst_dense = max(worst_dense, lsb)
            if lsb > COMPOSITE_LSB:
                raise AssertionError(f"resize_picture_polyphase {what} {label} disagrees with the "
                                     f"dense resize by {lsb} LSB")
        plans = [rc._phase_plan(a, b)[:3] for a, b in zip(src, dst)]
        log(f"resize kernel vs twin, {what} {src[0]}x{src[1]} -> {dst[0]}x{dst[1]} "
            f"(L, M, J: rows {plans[0]}, columns {plans[1]}): exact on both axes and on each "
            f"alone, one launch each; vs dense f32 within {COMPOSITE_LSB} LSB")
    for what, src, dst in RESIZE_PICTURES:
        planes = [u8(s) for s in src]
        exact(what, planes, dst)
        # a strided view of the first plane (made contiguous by the wrapper)
        wide = u8((src[0][0], 2 * src[0][1]))
        exact(f"{what}, strided luma", [wide[:, ::2]] + planes[1:], dst)
        log(f"resize kernel vs twin, picture {what} {src} -> {dst}: exact, one launch")
    log(f"resize planes vs dense f32: max {worst_dense} LSB (limit {COMPOSITE_LSB})")
    for S in PASSTHROUGH_S:
        x = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(dev)
        got, want = tool.passthrough_cuda(x), tool.passthrough_torch(x)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"passthrough kernel vs twin S={S}: max abs err "
                                 f"{(got - want).abs().max().item()}")
        log(f"passthrough kernel vs twin S={S}: bit-exact")
    return 0.0


def composite_frame(torch, t, dev, resize, fold=False):
    """Config 5's video frame ``t``: a 960x540 gradient to yuv420p, its
    planes to 1080p through ``resize(planes, sizes)`` (one picture), the
    luma crossfaded with its 1-row roll at fade 128 (the crossfade kernel),
    or with ``fold`` the luma through the folded ``resize_crossfade_roll``
    (f32) instead."""
    from mixlab_tpu_torch.video import blend, fused
    from mixlab_tpu_torch.video.colorspace import rgb_to_yuv420
    from mixlab_tpu_torch.video.pattern import gradient_rgb

    h, w = COMPOSITE_SRC
    y, u, v = rgb_to_yuv420(gradient_rgb(w, h, t, device=dev))
    if fold:
        y2 = fused.resize_crossfade_roll(y, 2 * h, 2 * w, COMPOSITE_FADE)
        u2, v2 = resize([u, v], [(h, w)] * 2)
        return y2, u2, v2
    y1, u2, v2 = resize([y, u, v], [(2 * h, 2 * w), (h, w), (h, w)])
    (y2,) = blend.crossfade_cuda([y1], [torch.roll(y1, 1, 0)], COMPOSITE_FADE)
    return y2, u2, v2


def _with_banded(flag: str, fn):
    """``fn()`` with ``MIXLAB_RESIZE_BANDED`` set to ``flag`` (restored)."""
    import os

    old = os.environ.get("MIXLAB_RESIZE_BANDED")
    os.environ["MIXLAB_RESIZE_BANDED"] = flag
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["MIXLAB_RESIZE_BANDED"]
        else:
            os.environ["MIXLAB_RESIZE_BANDED"] = old


def composite_path(torch, np, dev, card, n_frames=COMPOSITE_FRAMES):
    """The composite main path through the polyphase kernel and the
    crossfade kernel, the launch counts set to 0 just before and read just
    after; then the dense and folded forms beside it, banded int8 against
    dense int8 on one frame, and the realtime camera through the kernel."""
    from mixlab_tpu_torch.video import scale
    from mixlab_tpu_torch.video.frame import PictureSettings
    from mixlab_tpu_torch.video.pattern import pattern_picture
    from mixlab_tpu_torch.video.resize_cuda import resize_picture_polyphase

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    frames = [composite_frame(torch, i, dev, resize_picture_polyphase) for i in range(n_frames)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in counters.items()}
    h, w = COMPOSITE_SRC
    log(f"composite main path: {n_frames} config-5 frames ({w}x{h} -> {2 * w}x{2 * h}, "
        f"polyphase resize, roll, crossfade at {COMPOSITE_FADE}) on {dev} in {wall:.3f} s [{card}], "
        f"launches {launches}")
    for name, want in (("resize", n_frames), ("crossfade", n_frames)):
        if launches[name] != want:
            raise AssertionError(f"the composite path launched the {name} kernel "
                                 f"{launches[name]} times in {n_frames} frames (want {want})")

    def dense(planes, sizes):
        return [scale.resize_plane(p, h, w, "f32") for p, (h, w) in zip(planes, sizes)]

    shapes = [(2 * COMPOSITE_SRC[0], 2 * COMPOSITE_SRC[1]), COMPOSITE_SRC, COMPOSITE_SRC]
    lsb = fold_lsb = 0
    for i, got in enumerate(frames):
        if [tuple(g.shape) for g in got] != shapes or any(g.dtype != torch.uint8 for g in got):
            raise AssertionError(f"composite frame {i}: planes {[tuple(g.shape) for g in got]}")
        want = composite_frame(torch, i, dev, dense)
        lsb = max(lsb, *(_lsb(torch, g, w) for g, w in zip(got, want)))
        fold_lsb = max(fold_lsb, _lsb(torch, composite_frame(torch, i, dev, dense, True)[0],
                                      want[0]))
    mean = float(frames[-1][0].float().mean())
    log(f"composite path vs the dense f32 pipeline ({n_frames} frames): max {lsb} LSB (limit "
        f"{COMPOSITE_LSB}); folded luma vs the dense sequential: max {fold_lsb} LSB (limit "
        f"{FOLD_LSB}); last luma mean {mean:.2f}")
    if lsb > COMPOSITE_LSB or fold_lsb > FOLD_LSB or not 16.0 < mean < 240.0:
        raise AssertionError("the composite path disagrees with its dense or folded form")

    from mixlab_tpu_torch.video.colorspace import rgb_to_yuv420
    from mixlab_tpu_torch.video.pattern import gradient_rgb

    planes = rgb_to_yuv420(gradient_rgb(COMPOSITE_SRC[1], COMPOSITE_SRC[0], 0, device=dev))
    by_flag = {flag: _with_banded(flag, lambda: [
        scale.resize_plane(p, 2 * p.shape[0], 2 * p.shape[1], "int8") for p in planes])
        for flag in ("0", "1")}
    if not all(torch.equal(a, b) for a, b in zip(by_flag["0"], by_flag["1"])):
        raise AssertionError("banded int8 resize differs from the dense int8 on the card")
    log("banded int8 vs dense int8 on the card, one config-5 frame's planes: bit-identical")

    src = pattern_picture("gradient", *CAM_SIZES[1], 5, device=dev)
    out = PictureSettings(*CAM_SIZES[0])
    x, y, sw, sh = scale.letterbox_geometry(src.settings, out)
    boxed = scale.scale_picture(src, out, "f32")
    cam_lsb = 0
    subs = (("y", 0), ("u", 1), ("v", 1))
    got = resize_picture_polyphase([src.planes[k] for k, _ in subs],
                                   [(sh >> sub, sw >> sub) for _, sub in subs])
    for (k, sub), g in zip(subs, got):
        ph, pw, py, px = sh >> sub, sw >> sub, y >> sub, x >> sub
        cam_lsb = max(cam_lsb, _lsb(torch, g, boxed.planes[k][py:py + ph, px:px + pw]))
    log(f"realtime camera {CAM_SIZES[1][0]}x{CAM_SIZES[1][1]} through the polyphase resize vs "
        f"scale_picture(f32)'s content box {sw}x{sh}: max {cam_lsb} LSB (limit {COMPOSITE_LSB})")
    if cam_lsb > COMPOSITE_LSB:
        raise AssertionError("the polyphase resize disagrees with the letterbox's f32 scale")
    return launches


def profile_path(torch, dev, card):
    """The profiling tool's nine rows at 48 kHz (S = 384,000) on a short
    slope, the launch counts set to 0 just before and read just after."""
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.tools import profile_env_eq as tool

    S = BlockSpec(tool.BLOCK_TICKS).n_samples(EngineConfig(sample_rate=tool.SAMPLE_RATE))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    rows = tool.profile_rows(str(dev), reps=1, n1=2, n2=10,
                             log=lambda line: log(f"profile tool {line}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"profile tool path: {len(rows)} rows in {wall:.3f} s, launches {launches}")
    regions = {"chain", "full", "full_noosc", "no_env"}
    for r in rows:
        log(f"profile tool row {r['name']} [{card}]: {r['us_per_s']:.2f} us per second of audio "
            f"(slope 2 -> 10 blocks of {S} samples, one round), {r['program']} program, "
            f"{r['blocks']} blocks, launches {r['launches']}")
        want_pass = r["blocks"] if r["name"] == "full_dummy_eq" else 0
        if r["launches"]["passthrough"] != want_pass:
            raise AssertionError(f"profile row {r['name']}: passthrough launched "
                                 f"{r['launches']['passthrough']} times in {r['blocks']} blocks")
        if (r["program"] == "region") != (r["name"] in regions):
            raise AssertionError(f"profile row {r['name']} took the {r['program']} program")
        if not (0.0 < r["us_per_s"] < float("inf")):
            raise AssertionError(f"profile row {r['name']}: {r['us_per_s']} us/s")
    dummy = next(r for r in rows if r["name"] == "full_dummy_eq")
    if launches["passthrough"] != dummy["blocks"] or launches["region"] == 0:
        raise AssertionError(f"profile path launches {launches}")
    return launches


def resize_work(np, src_planes, dst_planes):
    """(bytes, flops) of resizing u8 planes: each input read once, each
    output written once; a multiply and an add per nonzero tap per output
    of each pass."""
    from mixlab_tpu_torch.video.resize_cuda import _phase_plan

    nbytes = sum(h * w for h, w in src_planes) + sum(h * w for h, w in dst_planes)
    flops = 0
    for (ih, iw), (oh, ow) in zip(src_planes, dst_planes):
        for n_in, n_out, outputs in ((ih, oh, oh * iw), (iw, ow, oh * ow)):
            if n_in != n_out:
                L, _, _, _, W = _phase_plan(n_in, n_out)[:5]
                flops += 2 * outputs * np.count_nonzero(W) / L
    return nbytes, int(flops)


def _device_us(torch, fn, name, n=20):
    """Device time per launch of the kernels whose name holds ``name``,
    from the profiler over ``n`` calls of ``fn``: [(kernel, us, count)].  A
    profile that recorded no such row is taken again, up to three in all
    (a profile in a process that ran many has come up empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        found = [(e.key, e.self_device_time_total / e.count, e.count)
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                 and name in e.key and e.self_device_time_total > 0]
        if found:
            break
        log(f"_device_us: the profile recorded no {name} kernel; taken again")
    return found


def video_timing(torch, np, dev, card):
    """For information: per 720p->1080p picture and per config-5 frame, the
    resize kernel (one launch per picture), its twin, the dense f32, int8
    and banded int8 resizes (CUDA events, the forms in turns, twice); the
    kernel's device time per picture; the passthrough vs its twin and
    torch.mul at S = 384,000, and the launch path's pieces."""
    from mixlab_tpu_torch.tools import profile_env_eq as tool
    from mixlab_tpu_torch.video import resize_cuda as rc
    from mixlab_tpu_torch.video import scale

    def per_plane(method):
        return lambda planes, sizes: [scale.resize_plane(p, h, w, method)
                                      for p, (h, w) in zip(planes, sizes)]

    forms = {  # name -> (resize(planes, sizes), MIXLAB_RESIZE_BANDED)
        "kernel": (rc.resize_picture_polyphase, "0"), "twin": (rc.resize_picture_torch, "0"),
        "dense f32": (per_plane("f32"), "0"), "int8": (per_plane("int8"), "0"),
        "banded int8": (per_plane("int8"), "1")}
    rng = np.random.default_rng(17)
    res = {}
    for label, src, dst in (
            ("720p->1080p yuv420p picture", [(720, 1280), (360, 640), (360, 640)],
             [(1080, 1920), (540, 960), (540, 960)]),
            ("config-5 frame, 540p->1080p", [(540, 960), (270, 480), (270, 480)],
             [(1080, 1920), (540, 960), (540, 960)])):
        planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev) for s in src]
        ms = {}
        for order in (list(forms), list(forms)[::-1]):
            for name in order:
                fn, flag = forms[name]
                ms.setdefault(name, []).append(_with_banded(
                    flag, lambda: time_ms(torch, lambda: fn(planes, dst), n=50, warmup=5)))
        nbytes, flops = resize_work(np, src, dst)
        b_ms, b_by = bound(nbytes, flops)
        dev_us = _device_us(torch, lambda: rc.resize_picture_polyphase(planes, dst),
                            "resize_picture_kernel")
        log(f"timing resize, {label} [{card}]: " + ", ".join(
            f"{name} {a:.4f}/{b:.4f}" for name, (a, b) in ms.items())
            + f" ms per picture (CUDA events, 50 calls, forms in turns); bound "
            f"{b_ms * 1e3:.3f} us by {b_by} ({nbytes} B, {flops} flop); library call: none "
            f"(F.interpolate's bicubic is another filter; dense f32 above)")
        for key, us, count in dev_us:
            log(f"  device time per launch {us:.3f} us ({count} launches traced in 20 pictures)  "
                f"{key[:100]}")
        # one launch per picture: the mean over the launches the trace holds
        traced = sum(count for _, _, count in dev_us)
        per_picture = sum(us * count for _, us, count in dev_us) / traced if traced else 0.0
        share = f"{100 * b_ms * 1e3 / per_picture:.1f}%" if per_picture else "not measured"
        log(f"  device time per picture {per_picture:.3f} us (one launch), {share} of the bound")
        res[label] = {"ms": sum(ms["kernel"]) / 2, "plain_ms": sum(ms["twin"]) / 2,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    out = {"resize": res["config-5 frame, 540p->1080p"]}

    S = 384_000
    x = torch.from_numpy(rng.standard_normal(S).astype(np.float32)).to(dev)
    gain = float(tool.GAIN)
    p1 = time_ms(torch, lambda: tool.passthrough_torch(x))
    k1 = time_ms(torch, lambda: tool.passthrough_cuda(x))
    m1 = time_ms(torch, lambda: torch.mul(x, gain))
    m2 = time_ms(torch, lambda: torch.mul(x, gain))
    k2 = time_ms(torch, lambda: tool.passthrough_cuda(x))
    p2 = time_ms(torch, lambda: tool.passthrough_torch(x))
    b_ms, b_by = bound(8 * S, S)
    dev_us = _device_us(torch, lambda: tool.passthrough_cuda(x), "passthrough_kernel", n=50)
    mul_us = _device_us(torch, lambda: torch.mul(x, gain), "", n=50)

    def us_text(found):
        return "/".join(f"{us:.3f}" for _, us, _ in found) or "not measured"

    log(f"timing passthrough S={S} [{card}]: kernel {k1:.4f}/{k2:.4f} ms, torch.mul "
        f"{m1:.4f}/{m2:.4f} ms, plain twin {p1:.4f}/{p2:.4f} ms per call (CUDA events, 200 "
        f"calls, in turns); device time per launch (profiler, 50 launches): kernel "
        f"{us_text(dev_us)} us, torch.mul {us_text(mul_us)} us "
        f"({', '.join(k[:80] for k, _, _ in mul_us)}); bound {b_ms * 1e3:.3f} us by {b_by} "
        f"({8 * S} B)")
    out["passthrough"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": (m1 + m2) / 2}
    launch_path_pieces(torch, dev, card, x)
    return out


def host_us(torch, f, n=2000):
    """Host time per call of ``f`` in us: the best of 3 rounds of ``n``
    calls, the card synchronised before each round, not inside it."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            f()
        best = min(best, time.perf_counter() - t)
    torch.cuda.synchronize()
    return best / n * 1e6


def envelope_call_pieces(torch, envc, card, x, st, prm):
    """For information: where an envelope call's host time goes, at the
    main path's S (host clock, ``host_us``)."""
    from mixlab_tpu_torch import kernels

    S, index = x.shape[0], x.get_device()
    lane, tiles = envc.tile_plan(S, envc.resident_tiles(index))
    buf = torch.empty(S + 4 + 16 * tiles, device=x.device)
    outs = {k: torch.empty_like(v) for k, v in st.items()}
    fn = kernels.load().mixlab_envelope_block
    args = (x.data_ptr(), buf.data_ptr(), S, 1, envc.FORM_GRID, lane, tiles, tiles,
            buf.data_ptr() + 4 * (S + 4), *(prm[k].data_ptr() for k in envc._PARAMS),
            MS_PER_SAMPLE,
            *(st[k].data_ptr() for k in ("mode_on", "on_pos", "off_pos", "off_amp")),
            *(outs[k].data_ptr() for k in ("mode_on", "on_pos", "off_pos", "off_amp")), index)
    raw = torch._C._cuda_getCurrentRawStream
    for name, f in (
            ("the wrapper, envelope_block_cuda", lambda: envc.envelope_block_cuda(
                x, st, prm, MS_PER_SAMPLE)),
            ("its launch path without the checks, _launch", lambda: envc._launch(
                x, index, st, prm, MS_PER_SAMPLE)),
            ("the five allocations (output with scratch, four state scalars)", lambda: (
                torch.empty(S + 4 + 16 * tiles, device=x.device),
                *(torch.empty((), dtype=v.dtype, device=x.device) for v in st.values()))),
            ("the bare CDLL call: a cooperative launch", lambda: fn(*args, raw(index)))):
        log(f"timing envelope call piece S={S} [{card}]: {host_us(torch, f):.3f} us per call  "
            f"{name}")


def launch_path_pieces(torch, dev, card, x, n=2000):
    """For information: the host time of each piece of a wrapper's launch
    path, the guarded path's beside the lean path's (``kernels.launch``), and
    the floor of any ctypes wrapper (its output's allocation and the bare
    call) beside ``torch.mul``; per call by the host clock over ``n`` calls,
    the best of 3 rounds; the card is synchronised before each round, not
    inside it."""
    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.tools import profile_env_eq as tool

    import ctypes

    index = x.get_device()
    one, one_out = torch.zeros(1, device=dev), torch.zeros(1, device=dev)
    C = torch._C
    fn = kernels.load().mixlab_passthrough  # CDLL, as every wrapper calls it
    pydll_fn = ctypes.PyDLL(str(kernels.library_path())).mixlab_passthrough  # keeps the GIL
    pydll_fn.argtypes, pydll_fn.restype = fn.argtypes, fn.restype
    device = x.device

    def guard():
        with torch.cuda.device(x.device):
            pass

    def require(cond, msg):  # a check whose message was built before it ran
        if not cond:
            raise ValueError(msg)

    def guarded_path(x):  # device guard, Stream object, eager messages; the same kernel
        require(isinstance(x, torch.Tensor) and x.device.type == "cuda",
                f"passthrough: unsupported device {getattr(x, 'device', type(x))}")
        require(x.dtype == torch.float32 and x.dim() == 1 and x.is_contiguous()
                and 0 < x.numel() < 2 ** 31,
                f"passthrough: want a contiguous non-empty 1-D float32 tensor, got "
                f"{x.dtype} {tuple(x.shape)}")
        out = torch.empty_like(x)
        lib = kernels.load()
        with torch.cuda.device(x.device):
            rc = lib.mixlab_passthrough(x.data_ptr(), out.data_ptr(), x.numel(), index,
                                        torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(lib, rc, "passthrough kernel launch")
        return out

    def allocate_and_launch(x):  # the least a wrapper can do: its output and the bare call
        out = torch.empty_like(x)
        fn(x.data_ptr(), out.data_ptr(), x.numel(), index, C._cuda_getCurrentRawStream(index))
        return out

    gain = float(tool.GAIN)
    floor = "allocate and launch: torch.empty_like and the bare CDLL call, S = 384,000"
    lean = "the lean path (passthrough_cuda), S = 384,000"
    mul = "torch.mul(x, gain), S = 384,000"
    pieces = (
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("torch.empty(S, dtype=torch.float32, device=device)",
         lambda: torch.empty(384_000, dtype=torch.float32, device=device)),
        ("x.new_empty(S)", lambda: x.new_empty(384_000)),
        ("x.data_ptr()", lambda: x.data_ptr()),
        ("x.is_contiguous()", lambda: x.is_contiguous()),
        ("ctypes call that returns at once (n = 0), CDLL",
         lambda: fn(one.data_ptr(), one_out.data_ptr(), 0, index, None)),
        ("ctypes call that returns at once (n = 0), PyDLL",
         lambda: pydll_fn(one.data_ptr(), one_out.data_ptr(), 0, index, None)),
        ("bare CDLL call of the kernel at S = 1 (its launch included)",
         lambda: fn(one.data_ptr(), one_out.data_ptr(), 1, index,
                    C._cuda_getCurrentRawStream(index))),
        ("stream as an object: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        ("raw stream: torch._C._cuda_getCurrentRawStream(index)",
         lambda: C._cuda_getCurrentRawStream(index)),
        ("device guard: with torch.cuda.device(x.device)", guard),
        ("device check: torch._C._cuda_getDevice() == index",
         lambda: C._cuda_getDevice() == index),
        ("entry point through kernels.load()", lambda: kernels.load().mixlab_passthrough),
        ("kept entry point", lambda: kernels._entries.get("mixlab_passthrough")),
        ("the guarded path's two messages, formatted", lambda: (
            f"passthrough: unsupported device {getattr(x, 'device', type(x))}",
            f"passthrough: want a contiguous non-empty 1-D float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)}")),
        ("the lean checks, inline", lambda: (
            isinstance(x, torch.Tensor) and x.is_cuda and x.dtype is torch.float32
            and x.dim() == 1 and 0 < x.numel() < 2 ** 31 and x.is_contiguous())),
        ("bare PyDLL call of the kernel at S = 1 (its launch included)",
         lambda: pydll_fn(one.data_ptr(), one_out.data_ptr(), 1, index,
                          C._cuda_getCurrentRawStream(index))),
        ("the guarded path, S = 384,000", lambda: guarded_path(x)),
        (floor, lambda: allocate_and_launch(x)),
        (lean, lambda: tool.passthrough_cuda(x)),
        (mul, lambda: torch.mul(x, gain)),
    )
    us = {}
    for name, f in pieces:
        us[name] = host_us(torch, f, n)
        log(f"timing launch path piece [{card}]: {us[name]:.3f} us per call  {name}")
    torch.cuda.synchronize()
    log(f"timing launch path floor [{card}]: allocate and launch {us[floor]:.3f} us, the lean "
        f"path {us[lean]:.3f} us, torch.mul {us[mul]:.3f} us per call (host clock, the best "
        f"of 3 rounds of {n}); the floor is {us[floor] / us[mul]:.2f}x torch.mul's call")


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# the .mp4 export and the served session


MP4_SECONDS = 2
SERVED_SECONDS = 10.0
TICK_BUDGET_MS = 1000.0 / 60


class _PureTier:
    """``MIXLAB_CODEC_TIER=pure`` and ``MIXLAB_PURE_AUDIO=<audio>`` while the
    block runs: the zero-dependency tier (AAC-LC, or lossless FLAC, + CAVLC
    H.264) that the parity tests hold to the JAX package's, whatever CLI
    encoders the host has."""

    def __init__(self, audio: str = "aac"):
        self.env = {"MIXLAB_CODEC_TIER": "pure", "MIXLAB_PURE_AUDIO": audio}

    def __enter__(self):
        import os

        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        import os

        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mp4_path(torch, proj: Path, tmp: Path):
    """``render_cli`` ``.mp4`` export of the flagship (its Monitor) for 2 s on
    the card at its defaults (44.1 kHz, 60-tick blocks), with the launch
    counts set to 0 just before and read just after: the file must walk as
    ``ftyp``, ``moov`` (``avc1``, ``mp4a``), ``moof``/``mdat`` pairs with
    2 s's samples, and the envelope and eq kernels launch once a block."""
    from mixlab_tpu_torch import render_cli

    out = tmp / "flagship.mp4"
    counters = launch_counters()
    with _PureTier():
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        render_cli.main([str(proj), str(out), "--seconds", str(MP4_SECONDS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counters.items()}
    walk = parse_fmp4(out.read_bytes())
    n_blocks = MP4_SECONDS * 60 // 60
    want = {"mp4a": MP4_SECONDS * RT_RATE // 1024, "avc1": MP4_SECONDS * 60 // 6}
    log(f"mp4 path: render_cli {MP4_SECONDS} s .mp4 on cuda in {wall:.3f} s, "
        f"{out.stat().st_size} bytes, tracks {walk['codecs']}, samples {walk['samples']} "
        f"(want {want}), {walk['fragments']} fragments, launches {launches}")
    if sorted(walk["codecs"].values()) != ["avc1", "mp4a"] or walk["samples"] != want:
        raise AssertionError(f"the .mp4 export holds {walk}, want samples {want}")
    for name in ("envelope", "eq_cascade"):
        if launches[name] != n_blocks:
            raise AssertionError(f"the .mp4 export launched the {name} kernel "
                                 f"{launches[name]} times in {n_blocks} blocks")
    return launches


async def ws_open(port: int, path: str):
    """A WebSocket client of the script's own: the upgrade, then (reader,
    writer)."""
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    if b" 101 " not in head.split(b"\r\n")[0]:
        raise AssertionError(f"websocket upgrade of {path} refused: {head[:80]!r}")
    return reader, writer


async def ws_read(reader, timeout=30.0) -> bytes:
    """One unmasked server frame's payload."""
    import asyncio

    async def read():
        head = await reader.readexactly(2)
        n = head[1] & 0x7F
        if n == 126:
            n = int.from_bytes(await reader.readexactly(2), "big")
        elif n == 127:
            n = int.from_bytes(await reader.readexactly(8), "big")
        return await reader.readexactly(n)

    return await asyncio.wait_for(read(), timeout)


def ws_text(payload: str) -> bytes:
    """A masked client text frame."""
    import os

    data, mask = payload.encode(), os.urandom(4)
    n = len(data)
    if n < 126:
        head = bytes([0x81, 0x80 | n])
    elif n < 65536:
        head = bytes([0x81, 0x80 | 126]) + n.to_bytes(2, "big")
    else:
        head = bytes([0x81, 0x80 | 127]) + n.to_bytes(8, "big")
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(data))


async def ws_op(reader, writer, seq, op):
    """Send one client op; read until its Sync; -> the Updates before it."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.protocol import wire

    writer.write(ws_text(json.dumps({"v": 1, "kind": "Workspace",
                                     "m": wire.encode(p.WorkspaceMessage(seq, op))})))
    await writer.drain()
    updates = []
    while True:
        kind, body = wire.parse_envelope(await ws_read(reader))
        if kind == "Sync":
            if body != seq:
                raise AssertionError(f"op {seq}: Sync {body}")
            return updates
        if kind == "Update":
            updates.append(body)


class ThreadFaults:
    """Collects every exception that ends a thread and every ERROR record
    logged (the engine's failed commands, the server loop's failed tasks)
    while active; ``check`` raises if there was one."""

    def __enter__(self):
        import logging

        self.faults = []
        self.old_hook = threading.excepthook
        threading.excepthook = lambda a: self.faults.append(
            f"thread {a.thread.name if a.thread else '?'}: {a.exc_type.__name__}: {a.exc_value}")
        faults = self.faults

        class Handler(logging.Handler):
            def emit(self, record):
                faults.append(f"log {record.name}: {record.getMessage()}")

        self.handler = Handler(level=logging.ERROR)
        logging.getLogger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        threading.excepthook = self.old_hook
        logging.getLogger().removeHandler(self.handler)

    def check(self, what):
        if self.faults:
            raise AssertionError(f"{what}: {len(self.faults)} faults: {self.faults[:5]}")


async def monitor_segments(port: int, socket_id: str, seconds: float, on_subscribed,
                           keep=None):
    """Subscribe to ``/_monitor/<socket_id>``: the init packet must be an
    fMP4 ``ftyp`` + ``moov``; then ``on_subscribed()``, and count the
    segments for ``seconds``, each of which must walk as ``moof``/``mdat``.
    A ``keep`` dict gets the init packet's header and segment (``"head"``,
    ``"init"``) and every segment after it (``"segments"``).
    -> (segments, elapsed seconds)."""
    reader, writer = await ws_open(port, f"/_monitor/{socket_id}")
    header, _, init = (await ws_read(reader)).partition(b"\n")
    head = json.loads(header)
    if head.get("mode") != "fmp4" or [k for k, _, _ in fmp4_boxes(init)] != ["ftyp", "moov"]:
        raise AssertionError(f"monitor init packet {head}")
    if keep is not None:
        keep.update(head=head, init=init, segments=[])
    on_subscribed()
    t0 = time.monotonic()
    segments = 0
    while time.monotonic() < t0 + seconds:
        header, _, seg = (await ws_read(reader)).partition(b"\n")
        if json.loads(header)["t"] == "init":
            continue
        if [k for k, _, _ in fmp4_boxes(seg)] != ["moof", "mdat"]:
            raise AssertionError("a monitor segment is not moof/mdat")
        if keep is not None:
            keep["segments"].append(seg)
        segments += 1
    elapsed = time.monotonic() - t0
    writer.close()
    return segments, elapsed


def monitor_client(port: int, socket_id: str, seconds: float) -> None:
    """The monitor client in a process of its own (``served_session`` with
    ``client="process"``): prints ``subscribed`` once the init packet is in,
    then one JSON line ``{"segments": n, "elapsed": s}``."""
    import asyncio

    segments, elapsed = asyncio.run(monitor_segments(
        port, socket_id, seconds, lambda: print("subscribed", flush=True)))
    print(json.dumps({"segments": segments, "elapsed": elapsed}), flush=True)


class _NoAac:
    """Stands in for the codec thread's AAC encoder in an attribution run:
    takes the audio and gives no frames."""

    def feed(self, pcm):
        pass

    def poll_frames(self):
        return []

    def close(self):
        pass


class _InProcessAac(_NoAac):
    """The AAC encoder as the JAX package (and the port before its codec
    process) runs it: ``AacLcEncoder`` on the codec thread itself, the same
    frames in the same polls."""

    def __init__(self, rate, channels):
        from mixlab_tpu_torch.av.aac import adts_frame
        from mixlab_tpu_torch.av.aacenc import AacLcEncoder

        self.enc, self.adts, self.channels = AacLcEncoder(rate, channels), adts_frame, channels
        self.buf = []

    def feed(self, pcm):
        self.buf.append(pcm.reshape(-1, self.channels))

    def poll_frames(self):
        import numpy as np

        buf = np.concatenate(self.buf) if self.buf else np.zeros((0, self.channels), np.int16)
        n = len(buf) // 1024
        out = [self.adts(self.enc.encode_granule(buf[k * 1024:(k + 1) * 1024]), self.enc.asc)
               for k in range(n)]
        self.buf = [buf[n * 1024:]]
        return out


def served_session(torch, np, dev, card, tmp: Path, aac: str = "process",
                   client: str = "thread", pure_audio: str = "aac") -> dict:
    """Phase 15 (a): a ``ProjectHandle`` on the card and ``run_server`` on an
    ephemeral port in this process.  A client of the script's own builds
    ``flagship.realtime_video_ops`` over the session socket, a feeder thread
    publishes both cameras at 60 fps, and the client subscribes to the
    Monitor's ``/_monitor/<socket id>`` for 10 s.  The launch counts are
    set to 0 and read on the engine thread, at the Monitor's pipe pushes
    that open and close the window, so the crossfade count must equal the
    video ticks in it exactly.

    ``aac="noop"`` swaps the codec thread's AAC encoder for ``_NoAac``,
    ``aac="inprocess"`` for ``_InProcessAac`` (the encoder on the codec
    thread, as before its codec process), and
    ``client="process"`` reads the monitor from a process of its own
    (``monitor_client``): ``served_attribution`` runs those.
    ``pure_audio="flac"`` muxes lossless FLAC (``MIXLAB_PURE_AUDIO=flac``),
    encoded on the codec thread: the init packet must name ``flac`` and hold
    ``fLaC`` and ``dfLa``, and every audio sample of every segment the client
    read must decode by the port's ``av/flacdec.py`` to exactly the int16
    PCM the codec thread fed its encoder (``_RecordedFlac``).  -> the
    window's figures, its kernel launches under ``"launches"``."""
    import asyncio

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.av.codecs import codec_tier
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.project import open_or_create
    from mixlab_tpu_torch.flagship import realtime_video_ops
    from mixlab_tpu_torch.server.app import run_server

    cams_names = ("srv-cam1", "srv-cam2")
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    counters = launch_counters()
    window = {"armed": False, "open": False, "video": 0, "items": 0, "launches": None}
    # after the window: composites copied to the host on the engine thread
    # at their push, and the pictures the codec thread fed its encoder
    check = {"left": 0, "host": {}, "fed": {}}
    walls = []
    fed, kept = [], {} if pure_audio == "flac" else None
    with _PureTier(pure_audio), _RecordedFlac(fed), ThreadFaults() as faults:
        proj = open_or_create(tmp / "served.mixlab", EngineConfig(sample_rate=RT_RATE),
                              block_ticks=1, device=str(dev))
        eng = proj.engine
        tick_once = eng.tick_once

        def timed_tick(*args):
            t = time.perf_counter()
            out = tick_once(*args)
            walls.append(time.perf_counter() - t)
            return out

        eng.tick_once = timed_tick
        cams = None  # the mountpoints listen once the ops have built the StreamInputs
        stop = threading.Event()

        def feeder():
            start, k = time.monotonic(), 0
            while not stop.is_set():
                cams.publish(k, pool[k % len(pool)])
                k += 1
                stop.wait(max(0.0, start + k / 60 - time.monotonic()))

        feed = threading.Thread(target=feeder, name="feeder")
        loop = asyncio.new_event_loop()
        server_thread = threading.Thread(target=loop.run_forever, name="server-loop")
        server_thread.start()
        tcp = replaced = None
        try:
            tcp, _ = asyncio.run_coroutine_threadsafe(
                run_server(proj, "127.0.0.1", 0), loop).result(60)
            port = tcp.sockets[0].getsockname()[1]

            async def build():
                reader, writer = await ws_open(port, "/session")
                await ws_read(reader)  # WorkspaceState
                await ws_read(reader)  # MediaLibrary
                ops, ids = realtime_video_ops(p, cams_names)
                socket_id = None
                for seq, op in enumerate(ops, 1):
                    for up in await ws_op(reader, writer, seq, op):
                        if up["t"] == "SUCreateModule" and up["params"]["kind"] == "Monitor":
                            socket_id = up["indication"]["value"]["socket_id"]
                writer.close()
                return ids, socket_id

            ids, socket_id = asyncio.run_coroutine_threadsafe(build(), loop).result(120)
            cams = Cameras(cams_names)
            feed.start()
            pipeline = eng._monitor_pipelines[ids["monitor"]]
            if socket_id != pipeline.socket_id:
                raise AssertionError(f"the Monitor's indication reads {socket_id!r}, its codec "
                                     f"thread's socket is {pipeline.socket_id!r}")
            pipe = eng.monitor_pipe(ids["monitor"])
            push = pipe.push

            def counted_push(item):
                # runs on the engine thread at the end of each tick
                if window["armed"] and not window["open"]:
                    for fn in counters.values():
                        fn.launches = 0
                    window["open"] = True
                elif window["open"] and window["launches"] is None:
                    # this tick's crossfade launched before its push
                    window["video"] += item[2] is not None
                    window["items"] += 1
                    if not window["armed"]:  # the push that closes the window
                        window["launches"] = {n: fn.launches for n, fn in counters.items()}
                elif check["left"] > 0 and item[2] is not None:
                    pic = item[2].picture
                    check["host"][item[0]] = (pic.settings, pic.to_numpy())
                    check["left"] -= 1
                return push(item)

            pipe.push = counted_push

            if not pipeline.broadcast.ready.wait(30):
                raise AssertionError("the monitor's codecs were not ready in 30 s")
            if aac != "process":  # the codec process ends after the engine stops
                replaced, pipeline._aac = pipeline._aac, (
                    _NoAac() if aac == "noop" else _InProcessAac(RT_RATE, 2))
            armed = {}

            def arm():
                walls.clear()
                armed["dropped"], armed["stats"] = pipe.dropped, dict(pipeline.stats)
                window["armed"] = True

            if client == "thread":
                segments, elapsed = asyncio.run_coroutine_threadsafe(monitor_segments(
                    port, socket_id, SERVED_SECONDS, arm, kept), loop).result(SERVED_SECONDS + 60)
            else:
                proc = subprocess.Popen(
                    [sys.executable, "-c", "import chip_smoke as cs; cs.monitor_client("
                     f"{port}, {socket_id!r}, {SERVED_SECONDS})"],
                    cwd=ROOT, stdout=subprocess.PIPE, text=True)
                try:
                    if proc.stdout.readline().strip() != "subscribed":
                        raise AssertionError("the monitor client process did not subscribe")
                    arm()
                    out = proc.communicate(timeout=SERVED_SECONDS + 60)[0]
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                if proc.returncode != 0:
                    raise AssertionError(f"the monitor client process exited {proc.returncode}")
                got = json.loads(out.strip().splitlines()[-1])
                segments, elapsed = got["segments"], got["elapsed"]
            window["armed"] = False
            dropped = pipe.dropped - armed["dropped"]
            stats = {k: pipeline.stats[k] - armed["stats"][k] for k in armed["stats"]}
            deadline = time.monotonic() + 10
            while window["launches"] is None and time.monotonic() < deadline:
                time.sleep(0.01)
            checked = monitor_pictures(torch, np, pipeline, check)
            cavlc = type(pipeline._h264._cavlc).__name__
        finally:
            stop.set()
            if feed.is_alive():
                feed.join(timeout=5)
            eng.stop()

            async def shut_down():
                # close the listener and end every connection's task before
                # the loop stops, so none is left pending
                if tcp is not None:
                    tcp.close()
                tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)

            asyncio.run_coroutine_threadsafe(shut_down(), loop).result(30)
            loop.call_soon_threadsafe(loop.stop)
            server_thread.join(timeout=10)
            loop.close()
            if cams is not None:
                cams.close()
            if replaced is not None:
                replaced.close()
            proj.close()
        faults.check("served session")
    if window["launches"] is None:
        raise AssertionError("the served window did not close on the engine thread")
    launches = window["launches"]
    w = np.sort(np.asarray(walls[:window["items"]]) * 1e3)
    p50, p99 = float(np.percentile(w, 50)), float(np.percentile(w, 99))
    over = float((w > TICK_BUDGET_MS).mean())
    ms_frame = 1e3 * stats["video_s"] / max(stats["video_frames"], 1)
    ms_audio_s = 1e3 * stats["audio_s"] / max(stats["audio_samples"] / RT_RATE, 1e-9)
    variant = {"process": "", "noop": ", AAC encoder a no-op",
               "inprocess": ", AAC encoder on the codec thread"}[aac] + (
        ", client in a process of its own" if client == "process" else "")
    before = ("; the AAC encoder in its codec process (with it on the codec thread, earlier "
              "runs on an NVIDIA H100 80GB HBM3 at 700 W: 2 / 8 dropped, 15.64 / 54.20% "
              "over)") if aac == "process" else ""
    if pure_audio == "flac":
        variant, before = ", FLAC audio encoded on the codec thread", ""
    log(f"served session{variant} [{card}]: codec tier {codec_tier()} (auto: "
        f"{_auto_codec_tier()}), CAVLC tier {cavlc}; {segments} segments in {elapsed:.3f} s "
        f"({segments / elapsed:.2f}/s); {window['items']} ticks in the window, "
        f"{window['video']} with video, pipe dropped {dropped}; encode {ms_frame:.3f} ms "
        f"per video frame ({stats['video_frames']} frames, scale included), "
        f"{ms_audio_s:.3f} ms per second of audio; served tick_once p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms, over {TICK_BUDGET_MS:.3f} ms {100 * over:.2f}% of "
        f"{len(w)} ticks; launches {launches}; {checked} fed pictures within 1 LSB "
        f"of the engine's composites scaled on the host{before}")
    if cavlc != "NativeCavlcIntraEncoder":
        raise AssertionError(f"the monitor's CAVLC tier is {cavlc}, not the native encoder")
    if launches["crossfade"] != window["video"] or window["video"] < 60:
        raise AssertionError(f"the served window launched the crossfade kernel "
                             f"{launches['crossfade']} times in {window['video']} video ticks")
    if segments < (5 if aac == "noop" else 10) * SERVED_SECONDS:
        raise AssertionError(f"only {segments} monitor segments in {elapsed:.1f} s")
    if pure_audio == "flac":
        flac_segments(np, kept, fed, segments)
    return {"launches": launches, "segments_per_s": segments / elapsed,
            "ticks": window["items"], "dropped": dropped, "p50": p50, "p99": p99,
            "over": over, "ms_frame": ms_frame, "ms_audio_s": ms_audio_s}


class _RecordedFlac:
    """While the block runs, every ``PureFlacStream`` the Monitor builds
    keeps a copy of the int16 PCM its codec thread feeds it in ``fed``."""

    def __init__(self, fed: list):
        self.fed = fed

    def __enter__(self):
        import numpy as np

        from mixlab_tpu_torch.av import flacenc

        fed, self.cls = self.fed, flacenc.PureFlacStream

        class Recorded(self.cls):
            def feed(self, pcm_i16):
                fed.append(np.array(pcm_i16, dtype=np.int16))
                super().feed(pcm_i16)

        flacenc.PureFlacStream = Recorded

    def __exit__(self, *exc):
        from mixlab_tpu_torch.av import flacenc

        flacenc.PureFlacStream = self.cls


def flac_segments(np, kept: dict, fed: list, segments: int) -> None:
    """The FLAC served session's stream as its client read it: the init
    packet names ``flac`` and holds ``fLaC`` and ``dfLa``; every audio
    sample of every segment decodes by the port's ``av/flacdec.py`` to
    exactly the int16 PCM fed at its place (its ``tfdt``)."""
    from mixlab_tpu_torch.av.flacdec import FlacDecoder
    from mixlab_tpu_torch.av.mp4read import Mp4Reader

    mime = kept["head"].get("mime", "")
    if not mime.endswith(', flac"') or b"fLaC" not in kept["init"] or b"dfLa" not in kept["init"]:
        raise AssertionError(f"the FLAC monitor's init packet: mime {mime!r}, fLaC "
                             f"{b'fLaC' in kept['init']}, dfLa {b'dfLa' in kept['init']}")
    if len(kept["segments"]) != segments:
        raise AssertionError(f"kept {len(kept['segments'])} of {segments} segments")
    reader = Mp4Reader(kept["init"] + b"".join(kept["segments"]))
    track = reader.audio_track()
    pcm = np.concatenate([a.reshape(-1, 2) for a in fed])
    dec, checked = FlacDecoder(track.streaminfo), 0
    for sample in track.samples:
        data = reader.sample_data(sample)
        got, used = dec.decode_frame(data)
        want = pcm[sample.dts:sample.dts + len(got)]
        if used != len(data) or len(got) != 1024 or not np.array_equal(got, want):
            raise AssertionError(f"the FLAC frame at sample {sample.dts} ({used} of {len(data)} "
                                 f"bytes, {len(got)} samples) is not the PCM fed there")
        checked += len(got)
    video = reader.video_track()
    if track.codec != "flac" or len(track.samples) + len(video.samples) != segments or \
            len(track.samples) < 10 * SERVED_SECONDS:
        raise AssertionError(f"the FLAC monitor's {segments} segments hold {len(track.samples)} "
                             f"{track.codec} and {len(video.samples)} video samples")
    log(f"served FLAC: {len(track.samples)} audio segments of {segments}, {checked} samples "
        f"a channel decoded by av/flacdec.py, all exactly the int16 PCM fed "
        f"({len(pcm)} samples a channel fed in all)")


def served_attribution() -> int:
    """For information, not part of ``main``: what in the process takes the
    served session's tick wall.  On one card, in turns: the bare engine
    (phase 10's ``tick_once`` with video: 300 ticks in direct drive, no
    codec thread), then phase 15 (a) twice over in the order: as ``main``
    runs it (the AAC encoder in its codec process), with the encoder on the
    codec thread (as before its codec process), with the encoder a no-op;
    then as ``main`` runs it with the interpreter's switch interval at
    0.5 ms (5 ms by default) and with the monitor client in a process of
    its own; then the bare engine again.  Run from the repo's root:

        python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.served_attribution())'
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.device import resolve_device
    from mixlab_tpu_torch.precision import switch_tf32_off

    card = card_line()
    log(card)
    switch_tf32_off()
    dev = resolve_device("cuda")
    kernels.load()
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    names = ("b-cam1", "b-cam2")

    def bare(label):
        eng, ids, _ = realtime_engine(str(dev), names)
        cams = Cameras(names)
        try:
            pipe = eng.monitor_pipe(ids["monitor"])
            _tick_walls(torch, eng, cams, pipe, pool, 20)  # warm-up
            w = np.asarray(_tick_walls(torch, eng, cams, pipe, pool, 300)) * 1e3
        finally:
            cams.close()
            eng.stop()
        log(f"attribution, bare engine {label} [{card}]: tick_once p50 "
            f"{np.percentile(w, 50):.3f} ms, p99 {np.percentile(w, 99):.3f} ms, over "
            f"{TICK_BUDGET_MS:.3f} ms {100 * float((w > TICK_BUDGET_MS).mean()):.2f}% of 300 ticks")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        bare("before")
        variants = [(aac, "thread", None) for aac in ("process", "inprocess", "noop")] * 2
        variants += [("process", "thread", 5e-4), ("process", "process", None)]
        for i, (aac, client, switch) in enumerate(variants):
            sub = Path(tmp) / f"variant{i}"
            sub.mkdir()
            old = sys.getswitchinterval()
            if switch is not None:
                sys.setswitchinterval(switch)
                log(f"attribution: switch interval {switch * 1e3:.1f} ms")
            try:
                served_session(torch, np, dev, card, sub, aac=aac, client=client)
            finally:
                sys.setswitchinterval(old)
        bare("after")
    return 0


SERVED_CHECK_TICKS = 36


def monitor_pictures(torch, np, pipeline, check) -> int:
    """The pictures the codec thread fed its H.264 encoder against the
    engine's own composites: for the next ``SERVED_CHECK_TICKS`` pushes with
    a picture, the engine thread copies the composite to the host as it
    pushes it (``check["host"]``); the codec thread, which scales the
    composite on the card on its own thread, records what it fed the
    encoder (``check["fed"]``).  Each fed picture must be within 1 LSB of
    its composite scaled on the host (the scale's f32 sums, card against
    CPU).  A picture the codec thread read while the engine was still
    writing it, or after its memory was reused, would differ by far more.
    -> the number of pictures compared (at least 4)."""
    from mixlab_tpu_torch.av.codecs import MONITOR_PICTURE
    from mixlab_tpu_torch.video.frame import Picture
    from mixlab_tpu_torch.video.scale import scale_picture

    encode, h264_feed, current = pipeline._encode_tick_fmp4, pipeline._h264.feed, {}

    def encode_tick(t0, audio, video):
        current["t0"] = t0
        out = encode(t0, audio, video)
        current["done"] = t0
        return out

    def feed(pic):
        if "t0" in current:  # not a tick that began before the wrappers
            check["fed"][current["t0"]] = pic.to_numpy()
        return h264_feed(pic)

    pipeline._h264.feed, pipeline._encode_tick_fmp4 = feed, encode_tick
    check["left"] = SERVED_CHECK_TICKS
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            check["left"] or current.get("done", -1) < max(check["host"])):
        time.sleep(0.01)
    both = sorted(set(check["host"]) & set(check["fed"]))
    for t0 in both:
        settings, planes = check["host"][t0]
        want = scale_picture(Picture(settings, {k: torch.from_numpy(v) for k, v in
                                                planes.items()}), MONITOR_PICTURE).to_numpy()
        for k, got in check["fed"][t0].items():
            err = int(np.abs(got.astype(np.int32) - want[k].astype(np.int32)).max())
            if got.shape != want[k].shape or err > 1:
                raise AssertionError(f"the monitor fed its encoder a picture at t0={t0} "
                                     f"whose {k} plane is {err} LSB from the engine's composite")
    if len(both) < SERVED_CHECK_TICKS // 6 - 2:
        raise AssertionError(f"only {len(both)} fed pictures matched the engine's "
                             f"{len(check['host'])} composites")
    return len(both)


def _auto_codec_tier() -> str:
    import os

    from mixlab_tpu_torch.av.codecs import codec_tier

    old = os.environ.pop("MIXLAB_CODEC_TIER", None)
    try:
        return codec_tier()
    finally:
        if old is not None:
            os.environ["MIXLAB_CODEC_TIER"] = old


def codec_timing(torch, np, dev, card, n_frames=10, audio_seconds=2):
    """For information, on the card's host, each encoder alone on this
    thread: the CAVLC tiers' ms per 560x350 frame (the native C++ encoder
    and the numpy one, which must give the same bytes) on the cameras'
    content scaled on the card, and the pure AAC-LC encoder's ms per second
    of 44.1 kHz stereo."""
    from mixlab_tpu_torch.av.aacenc import AacLcEncoder
    from mixlab_tpu_torch.av.codecs import MONITOR_PICTURE, PureAacStream
    from mixlab_tpu_torch.av.encode_stream import f32_to_i16
    from mixlab_tpu_torch.av.h264cavlc_fast import (FastCavlcIntraEncoder,
                                                     NativeCavlcIntraEncoder)
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings
    from mixlab_tpu_torch.video.scale import scale_picture

    pics = []
    for tick in range(2):
        for size, planes in zip(CAM_SIZES, cam_frames(torch, np, dev, tick)[0]):
            pic = Picture(PictureSettings(*size), planes).to(dev)
            pics.append(Picture(MONITOR_PICTURE,
                                scale_picture(pic, MONITOR_PICTURE).to_numpy()))
    ms, units = {}, {}
    for name, enc in (("native", NativeCavlcIntraEncoder(30)),
                      ("numpy", FastCavlcIntraEncoder(30))):
        units[name] = [enc.encode_frame(pic) for pic in pics]  # warm-up and the bytes
        t = time.perf_counter()
        for i in range(n_frames):
            enc.encode_frame(pics[i % len(pics)])
        ms[name] = 1e3 * (time.perf_counter() - t) / n_frames
    rng = np.random.default_rng(15)
    n = audio_seconds * RT_RATE
    tone = 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(n) / RT_RATE)
    audio = np.stack([tone, -tone], axis=1) + 0.05 * rng.standard_normal((n, 2))
    aac = PureAacStream(RT_RATE, 2)
    try:
        aac.feed(np.zeros(2 * 1024, np.int16))  # the child started and warm
        aac.poll_frames()
        t = time.perf_counter()
        for i in range(0, n, RT_SPT):  # fed a tick at a time, as the codec thread does
            aac.feed(f32_to_i16(audio[i:i + RT_SPT].astype(np.float32).reshape(-1)))
            aac.poll_frames()
        ms_audio = 1e3 * (time.perf_counter() - t) / audio_seconds
    finally:
        aac.close()
    enc = AacLcEncoder(RT_RATE, 2)
    i16 = f32_to_i16(audio.astype(np.float32).reshape(-1)).reshape(-1, 2)
    t = time.perf_counter()
    for k in range(n // 1024):
        enc.encode_granule(i16[k * 1024:(k + 1) * 1024])
    ms_inproc = 1e3 * (time.perf_counter() - t) / audio_seconds
    log(f"codec timing, each encoder alone on one host thread [{card}]: CAVLC per "
        f"560x350 frame native {ms['native']:.3f} ms, numpy {ms['numpy']:.3f} ms "
        f"({n_frames} frames of the cameras' content, qp 30); pure AAC-LC "
        f"{ms_inproc:.3f} ms per second of audio in this process, {ms_audio:.3f} ms of "
        f"wall through the codec process ({audio_seconds} s in ticks of {RT_SPT})")
    if units["native"] != units["numpy"]:
        raise AssertionError("the native and numpy CAVLC tiers disagree")


def served_subprocess(tmp: Path):
    """Phase 15 (b): ``python -m mixlab_tpu_torch --listen 127.0.0.1:<port>
    <tmp>/p.mixlab`` at its default device: the listening line, ``GET /``
    with the port's ``index.html``, one client op, then SIGTERM: exit 0
    within 15 s with the op's module in the workspace row."""
    import asyncio
    import signal
    import socket

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.project import ProjectBase

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    path = tmp / "p.mixlab"
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "mixlab_tpu_torch", "--listen",
                             f"127.0.0.1:{port}", str(path)], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines = []

    def read_err():
        for line in proc.stderr:
            lines.append(line.rstrip())

    reader_thread = threading.Thread(target=read_err, name="stderr")
    reader_thread.start()
    try:
        deadline = time.monotonic() + 120
        while not any("listening on" in line for line in lines):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("the server did not listen:\n" + "\n".join(lines[-20:]))
            time.sleep(0.05)
        t_listen = time.perf_counter() - t

        async def drive():
            r, w = await asyncio.open_connection("127.0.0.1", port)
            w.write(b"GET / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            await w.drain()
            data = await asyncio.wait_for(r.read(-1), 30)
            head, _, body = data.partition(b"\r\n\r\n")
            index = (ROOT / "mixlab_tpu_torch/server/static/index.html").read_bytes()
            if not head.startswith(b"HTTP/1.1 200 OK") or body != index:
                raise AssertionError(f"GET / answered {head[:40]!r} ({len(body)} bytes)")
            reader, writer = await ws_open(port, "/session")
            await ws_read(reader)
            await ws_read(reader)
            await ws_op(reader, writer, 1, p.CreateModule(
                p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
                p.WindowGeometry()))
            writer.close()

        asyncio.run(drive())
        proc.send_signal(signal.SIGTERM)
        t_term = time.perf_counter()
        rc = proc.wait(15)
        t_exit = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader_thread.join(timeout=5)
    with ProjectBase(path) as base:
        saved = base.read_workspace()
    log(f"served subprocess: listening after {t_listen:.2f} s, GET / 200 with the port's "
        f"index.html, one op, SIGTERM -> exit {rc} in {t_exit:.2f} s; workspace row "
        f"{json.dumps(saved)[:160]}")
    if rc != 0:
        raise AssertionError(f"the server exited {rc} on SIGTERM:\n" + "\n".join(lines[-20:]))
    if saved is None or "Oscillator" not in json.dumps(saved):
        raise AssertionError(f"the op's module is not in the workspace row: {saved}")


# ---------------------------------------------------------------------------
# phase 16: the batched paths (the fleet, fleet serving, stems, the resampler)
# ---------------------------------------------------------------------------

FLEET_TICKS = 15                      # server/fleet_serve.py: 0.25 s a block at 60 Hz
FLEET_N = (1024, 8192)
FLEET_AUDIO_S = FLEET_TICKS / 60
BATCH_EQ = ((1, 2, 32, 133, 1024), (8192, 12_000, 44_100, 96_000))
# the envelope's S: whole tiles of 4,096 (32,768), a last tile of one
# sample (4,097), cut ones; its B: these and where the plan switches form
BATCH_ENV = ((1, 2, 32, 1024), (4_097, 12_000, 32_768, 48_000, 96_000))
# the rows' batched shapes in PERF.md: the fleet's (N x 12,000) and config 3's
BATCH_TIMED = ((1024, 12_000), (8192, 12_000), (32, 96_000))
# the envelope's also the 48-tick fleet's (1,024 x 38,400)
ENV_TIMED = (*BATCH_TIMED, (1024, 38_400))
RESAMPLE_ATOL = 2e-6
MIX_ATOL = 2e-4          # tests/test_multichip.py:29
SERVED_SLOTS = 1024
SERVED_CLIENTS = 16
SERVED_SECONDS = 5.0


def kernel_launches(torch, fn, n=10):
    """(kernel launches per call, device us per launch, kernel name) from the
    profiler over ``n`` calls of ``fn``: the launches are the CUDA runtime's
    launch calls traced on the host (the device rows of a profile in this
    process have come up short), and every device kernel seen
    must be the one named.  Where three profiles in a row recorded no device
    row at all but traced the launch calls, the device time and the name are
    None ("not recorded"): the launches a call still come from the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile whose device rows were all lost is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        rows = [e for e in events
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if rows:
            break
        log("kernel_launches: the profile recorded no device kernel; taken again")
    launches = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key.startswith(("cudaLaunch", "cuLaunch")))
    if not rows and launches:
        return launches / n, None, None
    if len(rows) != 1 or rows[0].count > n:
        raise AssertionError(f"device kernels seen: {[(e.key[:60], e.count) for e in rows]}")
    # without traced launch calls, the device rows count them
    per_call = (launches or rows[0].count) / n
    return per_call, rows[0].self_device_time_total / rows[0].count, rows[0].key


def launches_a_call(torch, fn, n=3):
    """(the runtime's kernel launch calls a call, traced on the host; the
    memsets a call; the device kernels' names) over ``n`` calls of ``fn``
    after one untimed call.  Copies (the region's slot table upload) are
    neither."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key.startswith(("cudaLaunch", "cuLaunch")))
    memsets = sum(e.count for e in events if "memset" in e.key.lower())
    names = {e.key[:60] for e in events if e.device_type == DeviceType.CUDA
             and not e.key.startswith(("Memcpy", "Memset"))}
    return launches / n, memsets / n, names


def _us(us) -> str:
    return "not recorded" if us is None else f"{us:.1f}"


def _share(bound_ms, us) -> str:
    return "not recorded" if us is None else f"{bound_ms * 1e3 / us:.3f}"


def _close(torch, got, want, tol):
    err = (got.float() - want.float()).abs()
    return bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all()), err.max().item()


def batched_kernels(torch, np, dev, card):
    """(a) the batched eq and envelope kernels against their batched twins
    at every B x S of the lists, 3 carried blocks; one device launch per
    call for every B; then, for information, each form's time per call, device
    time per launch, bound and twin time at the fleet's and config 3's
    shapes."""
    from mixlab_tpu_torch.dsp import envelope_cuda as envc
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    g = torch.Generator(device=dev).manual_seed(16)
    rand = lambda *shape, lo=-1.0, hi=1.0: torch.rand(
        shape, generator=g, device=dev) * (hi - lo) + lo
    worst = {"eq_cascade": 0.0, "envelope": 0.0}
    eq_r, env_r = eqc.resident_tiles(dev.index or 0), envc.resident_tiles(dev.index or 0)
    eq_rows = eqc.rows_resident(dev.index or 0)
    for S in BATCH_EQ[1]:
        eq_plan = lambda b: eqc.batch_plan(S, b, eq_r, eq_rows)
        for B in sorted({*BATCH_EQ[0], *switch_points(eq_plan, 2 * eq_rows)}):
            chosen = eq_plan(B)
            gains = rand(B, 3, lo=0.5, hi=2.0)
            pk = rand(B, 4, 2, lo=-0.1, hi=0.1)
            pt = pk.clone()
            for blk in range(3):
                x, xd = rand(B, S), rand(B, S)
                got, pk = eqc.eq_cascade_batched(x, xd, pk, gains, *f)
                want, pt = eqc.eq_cascade_torch_batched(x, xd, pt, gains, *f)
                for name, a, b in (("out", got, want), ("poles", pk, pt)):
                    ok, err = _close(torch, a, b, EQ_TOL)
                    if not ok:
                        raise AssertionError(f"batched eq B={B} S={S} block {blk} {name}: "
                                             f"max err {err}")
                    worst["eq_cascade"] = max(worst["eq_cascade"], err)
            launch = ""
            if S == BATCH_EQ[1][1]:  # one device launch a call, for every B
                per_call, _, name = kernel_launches(
                    torch, lambda: eqc.eq_cascade_batched(x, xd, pk, gains, *f))
                if per_call != 1:
                    raise AssertionError(f"batched eq B={B} S={S}: {per_call} device launches "
                                         "a call")
                launch = f", 1 device launch a call ({name})"
            log(f"batched eq kernel vs twin B={B} S={S} ({form_name(eqc, chosen, B)}, "
                f"L={chosen.run}): ok (3 blocks){launch}")
    for S in BATCH_ENV[1]:
        env_rows = envc.rows_resident(dev.index or 0, envc.rows_lane(S))
        plan = lambda b: envc.batch_plan(S, b, env_r, env_rows)
        for B in sorted({*BATCH_ENV[0], *switch_points(plan, 2 * env_rows)}):
            chosen = plan(B)
            params = {"attack_ms": rand(B, lo=0.0, hi=30.0), "decay_ms": rand(B, lo=1.0, hi=500.0),
                      "sustain_amplitude": rand(B, lo=0.0, hi=1.0),
                      "release_ms": rand(B, lo=1.0, hi=300.0)}
            for kind, p_edge in (("dense", 0.3), ("sparse", 2e-4)):
                u = torch.rand((3, B, S), generator=g, device=dev)
                xs = torch.where(u < p_edge, 0.0, torch.where(u < 2 * p_edge, 1.0, 0.5))
                sk = {"mode_on": torch.zeros(B, dtype=torch.bool, device=dev),
                      "on_pos": torch.full((B,), envc.POS_FLOOR, dtype=torch.int32, device=dev),
                      "off_pos": torch.full((B,), envc.POS_FLOOR, dtype=torch.int32, device=dev),
                      "off_amp": torch.zeros(B, device=dev)}
                st = dict(sk)
                for blk in range(3):
                    got, sk = envc.envelope_block_batched(xs[blk], sk, params, 1000 / 48_000)
                    want, st = envc.envelope_block_torch_batched(xs[blk], st, params, 1000 / 48_000)
                    err = max((got - want).abs().max().item(),
                              (sk["off_amp"] - st["off_amp"]).abs().max().item())
                    same = all(torch.equal(sk[k], st[k]) for k in ("mode_on", "on_pos", "off_pos"))
                    if not (err <= ENV_ATOL and same):
                        raise AssertionError(f"batched envelope B={B} S={S} {kind} block {blk}: "
                                             f"max err {err}, integer state equal {same}")
                    worst["envelope"] = max(worst["envelope"], err)
            launch = ""
            if S == BATCH_ENV[1][2]:  # one device launch a call, for every B
                per_call, _, name = kernel_launches(
                    torch, lambda: envc.envelope_block_batched(xs[0], sk, params, 1000 / 48_000))
                if per_call != 1:
                    raise AssertionError(f"batched envelope B={B} S={S}: {per_call} device "
                                         "launches a call")
                launch = f", 1 device launch a call ({name})"
            log(f"batched envelope kernel vs twin B={B} S={S} "
                f"({form_name(envc, chosen, B)}, C={chosen.lane}): ok (dense, sparse; 3 blocks)"
                f"{launch}")

    times = {"eq_cascade": {}, "envelope": {}}
    for B, S in BATCH_TIMED:
        x, xd = rand(B, S), rand(B, S)
        poles, gains = rand(B, 4, 2, lo=-0.1, hi=0.1), rand(B, 3, lo=0.5, hi=2.0)
        eq_bound = bound(12.0 * B * S, eq_flops(S) * B)
        eq_call = lambda: eqc.eq_cascade_batched(x, xd, poles, gains, *f)
        _, eq_dev, _ = kernel_launches(torch, eq_call, n=5)
        times["eq_cascade"][f"{B}x{S}"] = row = {
            "ms": time_ms(torch, eq_call, n=20, warmup=3), "device_us": eq_dev,
            "plain_ms": time_ms(torch, lambda: eqc.eq_cascade_torch_batched(
                x, xd, poles, gains, *f), n=3, warmup=1),
            "bound_ms": eq_bound[0], "bound_by": eq_bound[1],
            "form": form_name(eqc, eqc.batch_plan(S, B, eq_r, eq_rows), B)}
        log(f"batched eq B={B} S={S} [{card}]: {row['ms']:.4f} ms a call, {_us(eq_dev)} us "
            f"device a launch ({row['form']}), twin {row['plain_ms']:.3f} ms, bound "
            f"{eq_bound[0] * 1e3:.1f} us ({eq_bound[1]}), share of the bound "
            f"{_share(eq_bound[0], eq_dev)}")
        del x, xd
    for B, S in ENV_TIMED:
        gate, st, prm = _env_batch(torch, dev, B, S, g)
        env_bound = bound(8.0 * B * S, 0.0)
        env_call = lambda: envc.envelope_block_batched(gate, st, prm, 1000 / 48_000)
        _, env_dev, _ = kernel_launches(torch, env_call, n=5)
        times["envelope"][f"{B}x{S}"] = row = {
            "ms": time_ms(torch, env_call, n=20, warmup=3), "device_us": env_dev,
            "plain_ms": time_ms(torch, lambda: envc.envelope_block_torch_batched(
                gate, st, prm, 1000 / 48_000), n=3, warmup=1),
            "bound_ms": env_bound[0], "bound_by": env_bound[1],
            "form": form_name(envc, envc.batch_plan(
                S, B, env_r, envc.rows_resident(dev.index or 0, envc.rows_lane(S))), B)}
        log(f"batched envelope B={B} S={S} [{card}]: {row['ms']:.4f} ms a call, "
            f"{_us(env_dev)} us device a launch ({row['form']}), twin {row['plain_ms']:.3f} ms, "
            f"bound {env_bound[0] * 1e3:.1f} us (bytes), share of the bound "
            f"{_share(env_bound[0], env_dev)}")
        del gate
    return worst, times


def fleet_workspaces(n):
    """n flagship workspaces with their own continuous params (the
    oscillators' and FM's frequencies, the amplifiers, the EQ gains)."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.flagship import build_16_module_graph

    base, _ = build_16_module_graph()
    out = []
    for i in range(n):
        ws = base.snapshot()
        d = (i % 97) / 97.0
        for j in range(4):
            ws.update_params(p.ModuleId(3 + j), p.ModuleParams(
                "Oscillator", p.OscillatorParams(110.0 * (j + 1) * (1 + 0.05 * d), p.Waveform.SINE)))
            ws.update_params(p.ModuleId(8 + j), p.ModuleParams(
                "Amplifier", p.AmplifierParams(amplitude=0.5 - 0.2 * d, mod_depth=0.3)))
        ws.update_params(p.ModuleId(7), p.ModuleParams("FmSine", p.FmSineParams(
            440.0 + 40 * d, 880.0 - 40 * d)))
        ws.update_params(p.ModuleId(12), p.ModuleParams("EqThree", p.EqThreeParams(
            p.Decibel(4.0 - 2 * d), p.Decibel(d), p.Decibel(4.0 + d))))
        out.append(ws)
    return out


def fleet_path(torch, np, dev, card):
    """(b) the fleet: the flagship at 48 kHz in 15-tick blocks, N = 1,024
    sessions with their own params, counts set to 0 just before a block and
    read just after (one eq launch, one envelope launch); four slots against
    single-patch renders on the card; then, for information, N = 1,024 and
    8,192: wall per block, realtime multiple, device busy share and peak
    device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(FLEET_TICKS)
    spb = block.n_samples(cfg)
    counters = launch_counters()
    launches, info = None, {}
    for n in FLEET_N:
        t = time.perf_counter()
        wss = fleet_workspaces(n)
        fleet = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, device=str(dev))
        built = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        fleet.run_block(0)  # first block: allocations
        torch.cuda.synchronize()
        if launches is None:
            for fn in counters.values():
                fn.launches = 0
            taps = fleet.run_block(spb)
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            log(f"fleet N={n}: one block launched {launches}")
            if launches["eq_cascade"] != 1 or launches["envelope"] != 1:
                raise AssertionError(f"fleet block launched the eq kernel {launches['eq_cascade']} "
                                     f"and the envelope kernel {launches['envelope']} times "
                                     "(want 1 and 1)")
            for i in (0, 1, n // 2, n - 1):
                patch = compile_patch(wss[i], cfg, block, dev)
                aux, st = patch.prepare_aux(wss[i]), patch.init_state(wss[i])
                for b in range(2):
                    st, want = patch.run(aux, patch.host_aux(b * spb), st)
                for c in range(2):
                    got_c, want_c = taps["16"]["audio"][c][i], want["16"]["audio"][c]
                    ok, err = _close(torch, got_c, want_c, EQ_TOL)
                    if not ok or not bool(torch.isfinite(got_c).all()):
                        raise AssertionError(f"fleet slot {i} channel {c} vs its single render: "
                                             f"max err {err}")
                log(f"fleet slot {i} vs a single-patch render on the card (2 blocks): max err "
                    f"{err:.3e} (EQ_TOL)")
        walls = []
        for b in range(2, 8):
            t = time.perf_counter()
            fleet.run_block(b * spb)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        wall = float(np.median(walls))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in range(8, 11):
                fleet.run_block(b * spb)
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        dev_s = sum(e.self_device_time_total for e in rows) / 3 / 1e6
        peak = torch.cuda.max_memory_allocated() / 2**30
        info[n] = {"wall_ms": wall * 1e3, "realtime": FLEET_AUDIO_S / wall,
                   "busy": dev_s / wall, "peak_gib": peak, "build_s": built}
        log(f"fleet N={n} [{card}]: built in {built:.2f} s, wall {wall * 1e3:.3f} ms a block "
            f"(median of 6; {FLEET_AUDIO_S} s of audio a session), {FLEET_AUDIO_S / wall:.2f} x "
            f"realtime, device {dev_s * 1e3:.3f} ms a block = busy share {dev_s / wall:.3f} of "
            f"the unprofiled wall, peak device memory {peak:.2f} GiB")
        for e in rows[:6]:
            log(f"  {e.self_device_time_total / 3e3:9.3f} ms a block {e.count / 3:6.0f}x  "
                f"{e.key[:90]}")
        del fleet
        torch.cuda.empty_cache()
    return launches, info


def fleet_served(torch, np, dev, card, ticks_a_block=FLEET_TICKS):
    """(c) fleet serving: a FleetEngine of capacity 1,024 on the card (the
    flagship, 15-tick blocks; phase 20 (c) at 16, on the region program)
    behind a FleetServeApp on an ephemeral port, 16 WebSocket clients for
    5 s; counts set to 0 just before the clients start and read just after
    they end: one launch a block of the block program's kernel (the
    region's where it was chosen, else the eq's)."""
    import asyncio

    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.server.fleet_serve import FleetEngine, FleetServeApp

    cfg = EngineConfig(sample_rate=48_000)
    template, mon = build_16_module_graph()
    counters = launch_counters()
    with ThreadFaults() as faults:
        t = time.perf_counter()
        eng = FleetEngine(template, SERVED_SLOTS, cfg, block_ticks=ticks_a_block,
                          device=str(dev))
        kernel = "region" if eng.fleet.patch._mega else "eq_cascade"
        log(f"fleet serving: FleetEngine of {SERVED_SLOTS} slots, {ticks_a_block}-tick blocks "
            f"({kernel} kernel), built and warmed in {time.perf_counter() - t:.2f} s")
        app = FleetServeApp(eng)

        async def client(port, k):
            reader, writer = await ws_open(port, "/fleet")
            joined = json.loads(await ws_read(reader))
            state = json.loads(await ws_read(reader))
            if joined.get("t") != "Joined" or state.get("kind") != "WorkspaceState":
                raise AssertionError(f"client {k}: {joined} / {state.get('kind')}")
            t_join = eng.slots[joined["slot"]].joined_sample  # the script inspects its engine
            pcms, synced, t_edit = [], None, None
            end = time.monotonic() + SERVED_SECONDS
            while time.monotonic() < end:
                if k == 0 and t_edit is None and len(pcms) >= 2:
                    writer.write(ws_text(json.dumps({"v": 1, "kind": "Workspace", "m": {
                        "t": "WorkspaceMessage", "sequence": 1, "op": {
                            "t": "UpdateModuleParams", "module_id": 3, "params": {
                                "kind": "Oscillator", "params": {
                                    "t": "OscillatorParams", "freq": 220.0,
                                    "waveform": "sine"}}}}})))
                    await writer.drain()
                    t_edit = time.monotonic()
                head, _, body = (await ws_read(reader)).partition(b"\n")
                msg = json.loads(head)
                if msg.get("t") == "pcm":
                    pcms.append((msg["t0"], np.frombuffer(body, np.int16).reshape(-1, 2)))
                elif msg.get("t") == "Sync":
                    synced = msg["sequence"]
                elif msg.get("t") == "Error":
                    raise AssertionError(f"client {k}: {msg}")
            writer.close()
            return joined["slot"], pcms, synced, t_join

        async def go():
            port = await app.serve()
            for fn in counters.values():
                fn.launches = 0
            tick0, t = eng.tick, time.monotonic()
            res = await asyncio.gather(*(client(port, k) for k in range(SERVED_CLIENTS)))
            launches = {name: fn.launches for name, fn in counters.items()}
            elapsed = time.monotonic() - t
            await app.shutdown()
            return res, launches, eng.tick - tick0, elapsed

        eng.start()
        try:
            results, launches, ticks, elapsed = asyncio.run(go())
            status = eng.status()
        finally:
            eng.stop()
        faults.check("fleet serving")
    blocks = ticks // ticks_a_block
    log(f"fleet serving [{card}]: {SERVED_CLIENTS} clients for {elapsed:.3f} s, {blocks} "
        f"blocks ({blocks / elapsed:.3f} blocks/s, {60 / ticks_a_block:g} = the 60 Hz "
        f"schedule), on schedule {status['on_schedule_fraction']}, over the "
        f"{ticks_a_block * 1000 / 60:g} ms budget {1 - status['on_schedule_fraction']:.4f}, max "
        f"late {status['max_late_ms']} ms, launches {launches}")
    other = "eq_cascade" if kernel == "region" else "region"
    # a block may straddle either end
    if abs(launches[kernel] - blocks) > 1 or launches[other]:
        raise AssertionError(f"served fleet: {launches[kernel]} {kernel} launches in {blocks} "
                             f"blocks, {launches[other]} {other}")
    slots = [r[0] for r in results]
    if len(set(slots)) != SERVED_CLIENTS or any(len(r[1]) < 3 for r in results):
        raise AssertionError(f"served fleet: slots {slots}, packets {[len(r[1]) for r in results]}")
    if results[0][2] != 1:
        raise AssertionError(f"the editing client got Sync {results[0][2]}")
    # every unedited session against a dedicated render from its join (the
    # edit of client 0 must not reach them); client 0's PCM after its Sync
    # is another render
    patch = compile_patch(template, cfg, BlockSpec(ticks_a_block), dev)
    renders = {}

    def render(t_join, n):
        if t_join not in renders:
            aux, st, out = patch.prepare_aux(template), patch.init_state(template), {}
            for j in range(n):
                t0 = t_join + j * patch.block.n_samples(cfg)
                st, taps = patch.run(aux, patch.host_aux(t0), st)
                out[t0] = torch.stack([(torch.clamp(c.reshape(-1), -1, 1) * 32767.0)
                                       .to(torch.int16) for c in taps["16"]["audio"]],
                                      1).cpu().numpy()
            renders[t_join] = out
        return renders[t_join]

    lsb = 0
    for _, pcms, _, t_join in results[1:]:
        want = render(t_join, 4)
        for t0, got in pcms:
            if t0 in want:
                lsb = max(lsb, int(np.abs(got.astype(np.int32) - want[t0]).max()))
    edited = render(results[0][3], 4)
    differ = sum(not np.array_equal(x, edited[t]) for t, x in results[0][1] if t in edited)
    log(f"fleet serving: the {SERVED_CLIENTS - 1} unedited sessions vs dedicated renders from "
        f"their joins (4 blocks each): {lsb} LSB; the edited session differs from its "
        f"template render in {differ} of its first blocks")
    if lsb > 1:
        raise AssertionError(f"served PCM vs a dedicated render: {lsb} LSB")
    return launches, {"blocks_per_s": blocks / elapsed,
                      "over_budget": 1 - status["on_schedule_fraction"]}


def stems_path(torch, np, dev, card):
    """(d) stems: ``stem_parallel_step`` with 16 stems of the flagship
    (counts set to 0 just before and read just after: one eq launch for all
    16); the resampler on the card against ``resample_block_np`` with the
    precision guard active; config 3 (16 stereo stems 44.1 -> 48 kHz and the
    per-channel eq, B = 32 x 96,000) as x realtime, for information."""
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp import resampler as rs
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.parallel.stems import stem_parallel_step

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(FLEET_TICKS)
    ws, mon = build_16_module_graph()
    fn, make_args, patch = stem_parallel_step(ws, cfg, block, str(mon.value), n_stems=16,
                                              device=str(dev))
    args = make_args(0)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    _, master = fn(*args)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    _, taps = patch.run(patch.prepare_aux(ws), patch.host_aux(0), patch.init_state(ws))
    one = torch.stack([c for c in taps[str(mon.value)]["audio"]], -1)
    err = (master - 16.0 * one).abs().max().item()
    log(f"stems: 16 stems of the flagship, master vs 16 x one stem: max err {err:.3e} "
        f"(atol {MIX_ATOL}), launches {launches}")
    if not err <= MIX_ATOL or launches["eq_cascade"] != 1:
        raise AssertionError(f"stems: master err {err}, eq launches {launches['eq_cascade']}")

    # the resampler: the guard refuses cuDNN's TF32, then the conv in IEEE f32
    x_np = np.random.default_rng(3).uniform(-1, 1, (735 * 120, 32)).astype(np.float32)
    ctx_np = np.zeros((31, 32), np.float32)
    x, ctx = torch.from_numpy(x_np).to(dev), torch.from_numpy(ctx_np).to(dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        rs.resample_block(x, ctx, 44_100, 48_000)
        raise AssertionError("the resampler ran under cuDNN TF32")
    except RuntimeError as e:
        if "IEEE f32" not in str(e):
            raise
    finally:
        torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for blk in range(2):
        y, ctx = rs.resample_block(x, ctx, 44_100, 48_000)
        want, ctx_np = rs.resample_block_np(x_np, ctx_np, 44_100, 48_000)
        worst = max(worst, float(np.abs(y.cpu().numpy() - want).max()))
    log(f"resampler on the card (32 channels, 88,200 -> 96,000 samples, 2 carried blocks) vs "
        f"resample_block_np: max err {worst:.3e} (atol {RESAMPLE_ATOL}); refused under cuDNN TF32")
    if not worst <= RESAMPLE_ATOL:
        raise AssertionError(f"resampler on the card: max err {worst}")

    # config 3 (bench.py:299-364): 2 s blocks
    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    gains = torch.tensor([1.5849, 0.7943, 1.5849], device=dev).expand(32, 3).contiguous()
    poles = torch.zeros(32, 4, 2, device=dev)
    hist = torch.zeros(32, 3, device=dev)
    ctx = torch.zeros(31, 32, device=dev)

    def config3():
        nonlocal ctx, poles, hist
        y, ctx = rs.resample_block(x, ctx, 44_100, 48_000)  # [96,000, 32]
        yc = y.T.contiguous()
        yd = torch.cat([hist, yc], 1)[:, :yc.shape[1]]
        hist = yc[:, -3:]
        out, poles = eqc.eq_cascade_batched(yc, yd.contiguous(), poles, gains, *f)
        return out

    per_block = time_ms(torch, config3, n=10, warmup=2) / 1e3
    log(f"config 3 [{card}]: 16 stereo stems, 44.1 -> 48 kHz and the per-channel eq "
        f"(B = 32 x 96,000, one eq launch), {per_block * 1e3:.3f} ms per 2 s block = "
        f"{2.0 / per_block:.1f} x realtime")
    return launches, {"x_realtime": 2.0 / per_block}


# the rows sweep: the kernels' CTAs an SM asked of the compiler (min blocks
# of __launch_bounds__) by variant, built from this checkout's sources
ROWS_VARIANTS = {
    "envelope.cu": ("constexpr int kRowsMinBlocks = 4;", (4, 3)),
    "region.cu": ("__launch_bounds__(kChunk) region_rows_kernel",
                  (None, 6)),
}


def variant_libraries(variants):
    """{tag: (ctypes library, ptxas registers of its rows kernels)} of
    ``variants`` ({tag: (source name, patched text)}): each a copy of a
    ``csrc`` source built with this checkout's flags under
    ``_build/variants``, one nvcc a variant, all started together."""
    import ctypes
    import re

    from mixlab_tpu_torch import kernels

    out = kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (name, text) in variants.items():
        (out / f"{tag}.cu").write_text(text)
        procs[tag] = subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC), "-o",
             str(out / f"{tag}.so"), str(out / f"{tag}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"variant {tag}: {text[-3000:]}")
        regs = re.findall(r"Compiling entry function '[^']*(rows_kernel|lookback_kernel)[^']*'.*?"
                          r"Used (\d+) registers", text, re.S)
        lib = ctypes.CDLL(str((out / f"{tag}.so").resolve()))
        for fn, args in {**kernels._SIGNATURES, **kernels._QUERIES}.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        libs[tag] = lib, regs
    return libs


# the eq's sweep: shapes (the aim's, where a row splits, either side of the
# plan's switch) and one CTA a row's tiles (threads, run): the built one and
# the others as patched copies of eq_cascade.cu (``eq_variants``)
EQ_SWEEP_SHAPES = ((1024, 12_000), (8192, 12_000), (32, 96_000), (256, 12_000), (8, 96_000),
                   (64, 96_000), (528, 12_000), (660, 12_000))
EQ_SWEEP_TILES = ((64, 16), (64, 32), *((t, r) for t in (128, 256) for r in (8, 16, 32)))
EQ_TILE_LINES = ("constexpr int kRowsThreads = {};", "constexpr int kRowsLg = {};")
# one CTA a row at the built tile with 5 CTAs an SM asked of the compiler
EQ_MIN5 = ("__launch_bounds__(kRowsThreads) eq_rows_kernel",
           "__launch_bounds__(kRowsThreads, 5) eq_rows_kernel")


def eq_variants():
    """{tag: (source name, text)}: ``eq_cascade.cu`` with one CTA a row's
    tile patched to each of ``EQ_SWEEP_TILES`` but the built one, and the
    built tile with ``EQ_MIN5``."""
    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.dsp import eq_cuda as eqc

    text = (kernels.CSRC / "eq_cascade.cu").read_text()
    built = tuple(line.format(v) for line, v in
                  zip(EQ_TILE_LINES, (eqc.ROWS_THREADS, eqc.ROWS_RUN.bit_length() - 1)))
    out = {"eq_min5": ("eq_cascade.cu", text.replace(*EQ_MIN5))}
    for T, L in EQ_SWEEP_TILES:
        if (T, L) == (eqc.ROWS_THREADS, eqc.ROWS_RUN):
            continue
        patched = text
        for old, line, v in zip(built, EQ_TILE_LINES, (T, L.bit_length() - 1)):
            patched = patched.replace(old, line.format(v))
        out[f"eq_{T}x{L}"] = ("eq_cascade.cu", patched)
    for tag, (_, t) in out.items():
        if t == text:
            raise AssertionError(f"{tag}: the patch found nothing to replace")
    return out


def eq_sweep(torch, np, card, g, libs):
    """The batched eq's forms in turns at ``EQ_SWEEP_SHAPES``: the
    cooperative grid where it fits and one CTA a row at the built tile, and
    one CTA a row through each library of ``libs`` ({tag: library} built
    from ``eq_variants``: the other tiles of ``EQ_SWEEP_TILES``, the built
    tile at 5 CTAs an SM), each held to the batched twin within 2e-5;
    device us a launch by the profiler with its share of the bound."""
    import ctypes

    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

    dev = torch.device("cuda", 0)
    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    eq_r, rows_r = eqc.resident_tiles(0), eqc.rows_resident(0)
    tiles_of = {"rows": (eqc.ROWS_THREADS, eqc.ROWS_RUN), "eq_min5": (eqc.ROWS_THREADS,
                                                                      eqc.ROWS_RUN)}
    res = {"rows": (rows_r, {})}
    for tag, lib in libs.items():
        n = ctypes.c_int(0)
        if lib.mixlab_eq_rows_resident(0, ctypes.byref(n)):
            raise RuntimeError(f"{tag}: occupancy query failed")
        res[tag] = (n.value, {"mixlab_eq_cascade": lib.mixlab_eq_cascade})
        if tag not in tiles_of:  # eq_<threads>x<run>
            tiles_of[tag] = tuple(map(int, tag[3:].split("x")))
    log(f"eq sweep [{card}]: grid CTAs resident {eq_r}; one CTA a row's resident by variant "
        + str({f"{tag} {tiles_of[tag][0]}x{tiles_of[tag][1]}": r for tag, (r, _) in res.items()}))
    for B, S in EQ_SWEEP_SHAPES:
        x, xd = (torch.rand((B, S), generator=g, device=dev) * 2 - 1 for _ in range(2))
        poles = torch.rand((B, 4, 2), generator=g, device=dev) * 0.2 - 0.1
        gains = torch.rand((B, 3), generator=g, device=dev) + 0.5
        want = eqc.eq_cascade_torch_batched(x, xd, poles, gains, *f)
        plans, entries = {}, {}
        try:
            run, tiles = eqc.scan_plan(S, eq_r, eqc.THREADS, eqc.RUN, B)
            plans["grid"] = eqc.BatchPlan(eqc.FORM_GRID, run, tiles, tiles * B, eqc.THREADS)
            entries["grid"] = {}
        except ValueError:
            pass
        for tag, (r, entry) in res.items():
            T, L = tiles_of[tag]
            key = f"{tag} {T}x{L}"
            plans[key] = eqc.BatchPlan(eqc.FORM_ROWS, L, -(-S // (T * L)), min(r, B), T)
            entries[key] = entry
        fns = {k: lambda p=p: eqc._launch(x, xd, poles, gains, *f, 0, plan=p)
               for k, p in plans.items()}
        for k, fn in fns.items():
            kernels._entries.update(entries[k])
            got = fn()
            torch.cuda.synchronize()
            kernels._entries.pop("mixlab_eq_cascade", None)
            for a, b in zip(got, want):
                ok, err = _close(torch, a, b, EQ_TOL)
                if not ok:
                    raise AssertionError(f"eq sweep {B}x{S} {k}: max err {err} from the twin")
        us = {}
        for k in list(fns) + list(fns)[::-1]:  # in turns, forwards then backwards
            kernels._entries.update(entries[k])
            us.setdefault(k, []).append(_device_us(torch, fns[k], "eq_", n=5)[0][1])
            kernels._entries.pop("mixlab_eq_cascade", None)
        us = {k: float(np.median(v)) for k, v in us.items()}
        b_ms = bound(12.0 * B * S, eq_flops(S) * B)[0]
        chosen = eqc.batch_plan(S, B, eq_r, rows_r)
        for k, t in sorted(us.items(), key=lambda kv: kv[1]):
            mine = plans[k] == chosen and not entries[k]
            log(f"eq sweep {B}x{S} [{card}] {k} ({form_name(eqc, plans[k], B)}): {t:.1f} us "
                f"device a launch, share of the bound {b_ms * 1e3 / t:.3f}"
                + ("  <- the plan's" if mine else ""))
        del x, xd, want


def rows_sweep(kinds=("eq", "region", "envelope")) -> int:
    """Not in ``main``: the batched rows forms' choices in turns, each held
    to its batched twin (the envelope bit for bit, the eq and the region
    within 2e-5), device time per launch by the profiler: the eq's forms and
    tiles (``eq_sweep``), the envelope's lane (16, 32) and the region's run
    (4, 8), one CTA a row against the look-back, at the fleet's and config
    3's shapes and B where the plans switch form, with the envelope and
    region kernels built as they stand and with another count of CTAs an SM
    asked of the compiler (``ROWS_VARIANTS``).  It chose ``ROWS_LANES``,
    ``ROWS_RUN``, ``ROWS_THREADS``, ``LOOKBACK_COST`` and the kernels' launch
    bounds.  ``kinds``: which kernels' sweeps run.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.rows_sweep())'``"""
    import ctypes

    import numpy as np
    import torch

    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.dsp import envelope_cuda as envc
    from mixlab_tpu_torch.engine import region_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda")
    log(card)
    kernels.load()
    kernels._raw_stream = torch._C._cuda_getCurrentRawStream
    g = torch.Generator(device=dev).manual_seed(3)
    if "eq" in kinds:
        eq_libs = variant_libraries(eq_variants())
        for tag, (_, regs) in eq_libs.items():
            log(f"rows sweep {tag}: registers {regs}")
        eq_sweep(torch, np, card, g, {tag: lib for tag, (lib, _) in eq_libs.items()})
    if "region" not in kinds and "envelope" not in kinds:
        return 0
    variants = {}
    for name, (line, counts) in ROWS_VARIANTS.items():
        text = (kernels.CSRC / name).read_text()
        for n in counts:
            if n is None:
                variant = text
            elif name == "envelope.cu":
                variant = text.replace(line, f"constexpr int kRowsMinBlocks = {n};")
            else:
                variant = text.replace(line, line.replace("(kChunk)", f"(kChunk, {n})")).replace(
                    "__launch_bounds__(kChunk) region_lookback_kernel",
                    f"__launch_bounds__(kChunk, {n}) region_lookback_kernel")
            variants[f"{name.split('.')[0]}_min{n or 0}"] = name, variant
    libs = {}
    for tag, (lib, regs) in variant_libraries(variants).items():
        libs[tag] = lib
        log(f"rows sweep {tag}: registers {regs}")

    def query(lib, fn, *args):
        n = ctypes.c_int(0)
        if getattr(lib, fn)(*args, ctypes.byref(n)):
            raise RuntimeError(f"{fn} failed")
        return n.value

    def turns(fns, name):
        res = {k: [] for k in fns}
        for who in list(fns) + list(fns)[::-1]:
            kernels._entries.update(fns[who][0])
            res[who].append(_device_us(torch, fns[who][1], name, n=5)[0][1])
        kernels._entries.clear()
        return {k: float(np.median(v)) for k, v in res.items()}

    plan, row, consts = region_plans(torch)["flagship"]
    consts, shape, S = consts.to(dev), rc.plan_shape(plan), 12_800
    for B in (264, 512, 1024, 8192) if "region" in kinds else ():
        ops, pf = _region_inputs(torch, g, plan, row, B, S, dev)
        sf = torch.rand((B, plan.n_ef), generator=g, device=dev) * 0.2 - 0.1
        want = rc.region_part_torch_batched(plan, ops, pf, sf, S, consts, B) if B <= 1024 else None
        fns = {}
        for tag, lib in libs.items():
            if not tag.startswith("region"):
                continue
            for run in (4, 8):
                tiles = -(-S // (rc.CHUNK * run))
                look = query(lib, "mixlab_region_rows_resident", rc.FORM_LOOKBACK, run, *shape, 0)
                for bp in (rc.BatchPlan(rc.FORM_ROWS, run, tiles, B),
                           rc.BatchPlan(rc.FORM_LOOKBACK, run, tiles, min(look, B * tiles))):
                    fns[f"{tag} {form_name(rc, bp, B)}"] = (
                        {"mixlab_region_part": lib.mixlab_region_part},
                        lambda bp=bp: rc.region_part_batched(plan, ops, pf, sf, S, consts, B,
                                                             form=bp))
        for k, (entry, fn) in fns.items():
            kernels._entries.update(entry)
            got = fn()
            torch.cuda.synchronize()
            kernels._entries.clear()
            if want is not None and not max(_rows_err(torch, a, b)
                                            for a, b in zip(got, want)) <= REGION_ATOL:
                raise AssertionError(f"rows sweep region {B}x{S} {k}: differs from the twin")
        nbytes, flops = region_work(plan, ops, S, B)
        b_ms = bound(nbytes, flops)[0]
        for k, us in sorted(turns(fns, "region").items(), key=lambda kv: kv[1]):
            log(f"rows sweep region {B}x{S} [{card}] {k}: {us:.1f} us device a launch, share "
                f"of the bound {b_ms * 1e3 / us:.3f}")
        if B in (1024, 8192):  # where one CTA a row's time goes: the plan's pieces
            one_tap, no_eq = region_pieces(plan)
            bp = rc.rows_plan(S, B, shape, rc.rows_resident(0, shape))
            pieces = {what: ({}, lambda pl=pl: rc.region_part_batched(pl, ops, pf, sf, S, consts,
                                                                      B, form=bp))
                      for what, pl in (("one TAP", one_tap), ("the EQ as an AMP", no_eq),
                                       ("the flagship's plan", plan))}
            log(f"rows sweep region {B}x{S} [{card}] {form_name(rc, bp, B)}: device us a launch "
                + "; ".join(f"{k} {us:.1f}" for k, us in turns(pieces, "region").items()))
        del ops, want
    for B, S in ((200, 12_000), (390, 12_000), (1024, 12_000), (8192, 12_000), (1024, 38_400),
                 (32, 96_000)) if "envelope" in kinds else ():
        gate, st, prm = _env_batch(torch, dev, B, S, g)
        want, _ = envc.envelope_block_torch_batched(gate, st, prm, 1000 / 48_000)
        fns = {}
        for tag, lib in libs.items():
            if not tag.startswith("envelope"):
                continue
            for lane in envc.ROWS_LANES:
                tiles = -(-S // (envc.THREADS * lane))
                look = query(lib, "mixlab_envelope_rows_resident", envc.FORM_LOOKBACK,
                             lane.bit_length() - 1, 0)
                for bp in (envc.BatchPlan(envc.FORM_ROWS, lane, tiles, B),
                           envc.BatchPlan(envc.FORM_LOOKBACK, lane, tiles,
                                          min(look, B * tiles))):
                    fns[f"{tag} {form_name(envc, bp, B)}"] = (
                        {"mixlab_envelope_block": lib.mixlab_envelope_block},
                        lambda bp=bp: envc._launch(gate, 0, st, prm, 1000 / 48_000, plan=bp))
        for k, (entry, fn) in fns.items():
            kernels._entries.update(entry)
            got, _ = fn()
            torch.cuda.synchronize()
            kernels._entries.clear()
            if not torch.equal(got, want):
                raise AssertionError(f"rows sweep envelope {B}x{S} {k}: differs from the twin")
        b_ms = bound(8.0 * B * S, 0.0)[0]
        for k, us in sorted(turns(fns, "envelope").items(), key=lambda kv: kv[1]):
            log(f"rows sweep envelope {B}x{S} [{card}] {k}: {us:.1f} us device a launch, share "
                f"of the bound {b_ms * 1e3 / us:.3f}")
        del gate
    return 0


def parent_library(parent: str, names):
    """The parent checkout's kernels ``names`` (``csrc`` sources; ``parent``:
    a checkout's root, e.g. unpacked by ``git archive`` into a listed
    directory) built with this checkout's flags into one library, one nvcc
    a source started together, loaded with ``ctypes.CDLL``; the parent's C
    signatures (before the look-back's number moved to the device) are
    declared: ``mixlab_eq_cascade`` (x, xd, S, batch, sequential, poles0,
    gains, tables, f_lo, f_hi, vsa, run, threads, tiles, scratch, out,
    poles_out, device, stream), ``mixlab_envelope_block`` (x, out, S, batch,
    form, lane, tiles, ctas, scratch, seq, attack..release, msps, state in,
    state out, device, stream), ``mixlab_region_part`` (ops, n_words, slots,
    n_operands, n_slots, pf, pf_stride, n_pf, consts, sf, sf_stride, taps,
    n_taps, stap, n_stap, ef, n_ef, S, batch, form, run, tiles, ctas, n_eq,
    i16 mask, scratch, seq, device, stream)."""
    import ctypes
    import os

    from mixlab_tpu_torch import kernels

    kernels.load()
    src = Path(parent) / "mixlab_tpu_torch" / "csrc"
    out = Path(parent) / "_ab_build"
    out.mkdir(exist_ok=True)
    nvcc = kernels.find_nvcc()
    objs = [str(out / f"{name}.o") for name in names]
    procs = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-I", str(src), "-c", "-o", o,
                               str(src / name)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for name, o in zip(names, objs)]
    for proc in procs:
        if proc.wait(timeout=600):
            raise RuntimeError(f"parent build failed: {proc.stdout.read().decode()[-4000:]}")
    lib_path = out / f"parent_{'_'.join(n.split('.')[0] for n in names)}.so"
    subprocess.run([nvcc, *kernels._ARCH, "-shared", "-o", str(lib_path), *objs], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    P, I, F, LL, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                      ctypes.c_uint)
    sigs = {"mixlab_eq_cascade": [P, P, I, I, I, P, P, P, F, F, F, I, I, I, P, P, P, I, P],
            "mixlab_envelope_block": [P, P, I, I, I, I, I, I, P, U, P, P, P, P, F, *[P] * 8,
                                      I, P],
            "mixlab_region_part": [P, I, P, I, I, P, LL, I, P, P, LL, P, I, P, I, P, I,
                                   I, I, I, I, I, I, I, U, P, U, I, P]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
    return lib


def single_ab(parent: str) -> int:
    """Not in ``main``: the single-block eq and envelope launches of the
    parent (``parent``: a checkout's root) and of this checkout, in turns
    (parent, change, change, parent, three times), device time per launch by
    the profiler at S = 44,100.  The parent's ``csrc`` is built with this
    checkout's flags and called through its own C signatures
    (``parent_library``) with a batch of one.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.single_ab("<dir>"))'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch.dsp import envelope_cuda as envc
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

    card = card_line()
    lib = parent_library(parent, ("eq_cascade.cu", "envelope.cu"))
    raw, dev, S = torch._C._cuda_getCurrentRawStream, torch.device("cuda"), 44_100
    f_lo, f_hi = _filter_coeff(FREQ_LO, S), _filter_coeff(FREQ_HI, S)
    x, xd = (torch.rand(S, device=dev) * 2 - 1 for _ in range(2))
    poles, gains = torch.zeros(4, 2, device=dev), torch.tensor([1.5849, 1.0, 1.5849], device=dev)
    tables = eqc._device_tables(f_lo, f_hi, dev)
    run, tiles = eqc.scan_plan(S, eqc.resident_tiles(0))
    at = -(-S // 4) * 4
    buf = torch.empty(at + 8 + 8 * tiles, device=dev)
    parent_eq = lambda: lib.mixlab_eq_cascade(
        x.data_ptr(), xd.data_ptr(), S, 1, 0, poles.data_ptr(), gains.data_ptr(),
        tables.data_ptr(), f_lo, f_hi, VSA, run, eqc.THREADS, tiles,
        buf.data_ptr() + 4 * (at + 8), buf.data_ptr(), buf.data_ptr() + 4 * at, 0, raw(0))
    change_eq = lambda: eqc._launch(x, xd, poles, gains, f_lo, f_hi, VSA, 0)
    gate = torch.ones(S, device=dev)
    st = {"mode_on": torch.tensor(False, device=dev),
          "on_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
          "off_pos": torch.tensor(envc.POS_FLOOR, dtype=torch.int32, device=dev),
          "off_amp": torch.tensor(0.0, device=dev)}
    prm = {k: torch.tensor(v, device=dev) for k, v in dict(
        attack_ms=25.0, decay_ms=500.0, sustain_amplitude=0.8, release_ms=200.0).items()}
    lane, etiles = envc.tile_plan(S, envc.resident_tiles(0))
    ebuf = torch.empty(at + 16 * etiles, device=dev)
    outs = {k: torch.empty_like(v) for k, v in st.items()}
    parent_env = lambda: lib.mixlab_envelope_block(
        gate.data_ptr(), ebuf.data_ptr(), S, 1, 0, lane, etiles, etiles,
        ebuf.data_ptr() + 4 * at, 0, *(prm[k].data_ptr() for k in envc._PARAMS), 1000 / 44_100,
        *(st[k].data_ptr() for k in envc._STATE), *(outs[k].data_ptr() for k in envc._STATE),
        0, raw(0))
    change_env = lambda: envc._launch(gate, 0, st, prm, 1000 / 44_100)
    if parent_eq() or parent_env():
        return 1
    torch.cuda.synchronize()
    got_env, _ = change_env()
    got_eq, _ = change_eq()
    torch.cuda.synchronize()
    if not (torch.equal(got_env, ebuf[:S]) and torch.equal(got_eq, buf[:S])):
        raise AssertionError("the parent's and this checkout's single launches differ")
    res = {}
    for _ in range(3):
        for who in ("parent", "change", "change", "parent"):
            for kind, fns in (("eq", (parent_eq, change_eq)),
                              ("envelope", (parent_env, change_env))):
                found = _device_us(torch, fns[who == "change"], "kernel", n=50)
                res.setdefault(f"{who} {kind}", []).append(found[0][1])
    for k, v in res.items():
        log(f"A/B single launch S={S} [{card}] {k}: device us per launch "
            + " ".join(f"{u:.3f}" for u in v) + f"; median {np.median(v):.3f}")
    return 0


def region_ab(parent: str) -> int:
    """Not in ``main``: the single-block region launch of the parent
    (``parent``: a checkout's root) and of this checkout, in turns (parent,
    change, change, parent, three times), on the flagship's 48 kHz block,
    device time per launch by the profiler; both launches' taps and exits
    must be equal.  The parent's ``region.cu`` is built with this
    checkout's flags and called through its own C signature
    (``parent_library``) with a batch of one, its constants after its params.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.region_ab("<dir>"))'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch.dsp.eq_cuda import scan_plan
    from mixlab_tpu_torch.engine import region_cuda as rc
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda")
    lib = parent_library(parent, ("region.cu",))
    ws = build_16_module_graph()[0]
    patch = compile_patch(ws, EngineConfig(sample_rate=48_000), BlockSpec(60), dev)
    with HoldRegion(torch) as hold:
        patch.run(patch.prepare_aux(ws), patch.host_aux(0), patch.init_state(ws))
    plan, ops, pf, sf, S = hold.captured[0]
    n_scratch = plan.n_slots - plan.n_operands
    scratch = torch.empty((n_scratch, S), device=dev)
    slots = torch.tensor([(v.data_ptr(), 0) for v in ops] + [(x.data_ptr(), 0) for x in scratch],
                         dtype=torch.int64, device=dev)
    words = torch.tensor(plan.words, dtype=torch.int32, device=dev)
    run, tiles = scan_plan(S, rc.resident_tiles(0), rc.CHUNK, rc.RUN)
    taps = torch.empty((plan.n_taps, S), device=dev)
    stap, ef = torch.empty(max(plan.n_stap, 1), device=dev), torch.empty(plan.n_ef, device=dev)
    raw = torch._C._cuda_getCurrentRawStream

    def parent_call():
        rc_ = lib.mixlab_region_part(
            words.data_ptr(), words.numel(), slots.data_ptr(), plan.n_operands, plan.n_slots,
            pf.data_ptr(), 0, plan.n_pf, pf.data_ptr() + 4 * plan.n_pf, sf.data_ptr(), 0,
            taps.data_ptr(), plan.n_taps, stap.data_ptr(), plan.n_stap, ef.data_ptr(),
            plan.n_ef, S, 1, 0, run, tiles, tiles, 0, 0, None, 0, 0, raw(0))
        if rc_:
            raise RuntimeError(f"parent region launch: CUDA error {rc_}")

    change_call = lambda: rc.region_part_cuda(plan, ops, pf, sf, S)
    parent_call()
    got = change_call()
    torch.cuda.synchronize()
    if not (torch.equal(got[0], taps) and torch.equal(got[2], ef)):
        raise AssertionError("the parent's and this checkout's region launches differ")
    res = {}
    for _ in range(3):
        for who in ("parent", "change", "change", "parent"):
            found = _device_us(torch, parent_call if who == "parent" else change_call, "region",
                               n=100)
            res.setdefault(who, []).append(found[0][1])
    for k, v in res.items():
        log(f"A/B single region launch S={S} (run {run}, {tiles} CTAs) [{card}] {k}: device us "
            "per launch " + " ".join(f"{u:.3f}" for u in v) + f"; median {np.median(v):.3f}")
    return 0


# the batched A/B's shapes (B, S): the aim's, then where a rows form splits
# a row or the cooperative grid still holds the batch; the envelope's and
# the region's where their look-back runs (the parent held its number on
# the host), the rows forms and the grid beside them
BATCHED_AB = {
    "eq_cascade": ((1024, 12_000), (8192, 12_000), (32, 96_000), (256, 12_000), (8, 96_000)),
    "envelope": ((1024, 12_000), (32, 96_000), (200, 12_000), (8, 32_768)),
    "region": ((1024, 12_800), (8, 102_400), (64, 102_400)),
}


def _env_batch(torch, dev, B, S, g):
    """The batched envelope timing inputs: sparse 0/1 gates, zero state,
    fixed params (phase 16's)."""
    gate = (torch.rand((B, S), generator=g, device=dev) > 0.9998).to(torch.float32)
    st = {"mode_on": torch.zeros(B, dtype=torch.bool, device=dev),
          "on_pos": torch.zeros(B, dtype=torch.int32, device=dev),
          "off_pos": torch.zeros(B, dtype=torch.int32, device=dev),
          "off_amp": torch.zeros(B, device=dev)}
    prm = {k: torch.full((B,), v, device=dev) for k, v in dict(
        attack_ms=25.0, decay_ms=500.0, sustain_amplitude=0.8, release_ms=200.0).items()}
    return gate, st, prm


def form_name(mod, plan, B) -> str:
    """What a batched plan of ``mod`` (``envelope_cuda``, ``eq_cuda`` or
    ``region_cuda``, whose ``FORM_*`` agree; the eq has no look-back)
    launches for B rows."""
    form, size, tiles, ctas = plan[:4]
    if form == mod.FORM_GRID:
        return f"grid {tiles} x {B}"
    # samples a tile: the eq's plan names its threads
    tile = size * (plan.threads if hasattr(plan, "threads")
                   else mod.CHUNK if hasattr(mod, "CHUNK") else mod.THREADS)
    if form == getattr(mod, "FORM_LOOKBACK", None):
        return f"look-back over {ctas} CTAs, {tiles} tiles of {tile} a row"
    return f"one CTA a row, {tiles} tiles of {tile}" + (f", {ctas} CTAs" if ctas < B else "")


def switch_points(plan, most):
    """The B (1..most) where ``plan(B)`` takes another form than at B - 1, and
    each B - 1."""
    out, last = set(), plan(1).form
    for b in range(2, most + 1):
        form = plan(b).form
        if form != last:
            out.update((b - 1, b))
        last = form
    return sorted(out)


def _variants(chosen, others):
    """{name: plan} of ``others`` that differ from ``chosen`` and each other."""
    out = {}
    for name, plan in others.items():
        if plan != chosen and plan not in out.values():
            out[name] = plan
    return out


def _turns(torch, fns, name, rounds, n):
    """{who: [device us per launch]} over ``rounds`` of the callables
    ``fns`` in turns, forwards then backwards (a, b, b, a for two)."""
    res = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for who in order + order[::-1]:
            found = _device_us(torch, fns[who], name, n=n)
            if len(found) != 1:
                raise AssertionError(f"{who}: device kernels {found}")
            res[who].append(found[0][1])
    return res


def _ab_log(np, card, kind, B, S, res, labels, b_ms, b_by, note):
    for who, us in res.items():
        log(f"A/B batched {kind} {B}x{S} [{card}] {who} ({labels[who]}): device us per launch "
            + " ".join(f"{u:.1f}" for u in us) + f"; median {np.median(us):.1f}, share of the "
            f"bound {b_ms * 1e3 / np.median(us):.3f} (bound {b_ms * 1e3:.1f} us, {b_by}); {note}")


def _other_rows(mod, rows, rows_res, B):
    """The rows form that ``rows`` (a rows plan of ``mod``) is not."""
    if rows.form == mod.FORM_LOOKBACK:
        return rows._replace(form=mod.FORM_ROWS, ctas=B)
    return rows._replace(form=mod.FORM_LOOKBACK, ctas=min(rows_res, B * rows.tiles))


def batched_ab(parent: str, rounds: int = 2, kinds=tuple(BATCHED_AB)) -> int:
    """Not in ``main``: the batched eq, envelope and region launches of the
    parent (``parent``: a checkout's root; its plans: the eq's cooperative
    grid where it fits, else one CTA a block in tiles of 2,048; the envelope's
    and region's as this checkout's, their look-back numbered on the host)
    and of this checkout (its plan's form, and the other forms it has at the
    shape: its rows form where the plan takes the grid; the envelope's and
    the region's other rows form), in turns (forwards then backwards, ``rounds`` times), at
    ``BATCHED_AB``'s shapes (``kinds`` of them): the eq's output and poles
    within 2e-5 of the parent's (largest difference printed), the
    envelope's outputs and state bit-equal to the parent's, the region's
    taps, scalar taps and exits within 2e-5 of the parent's, each scalar tap
    exactly the max of the launch's own taps; device us per launch by the
    profiler, each with its share of the bound.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.batched_ab("<dir>"))'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch.dsp import envelope_cuda as envc
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff
    from mixlab_tpu_torch.engine import region_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda")
    log(card)
    lib = parent_library(parent, ("eq_cascade.cu", "envelope.cu", "region.cu"))
    raw = torch._C._cuda_getCurrentRawStream
    g = torch.Generator(device=dev).manual_seed(15)
    msps = 1000 / 48_000

    def parent_status(nbytes):
        """A zeroed status scratch and the parent's host-side number on it."""
        scratch, seq = torch.zeros(nbytes, dtype=torch.uint8, device=dev), [0]

        def take():
            seq[0] += 1
            return seq[0]
        return scratch, take

    def check(rc_, what):
        if rc_:
            raise RuntimeError(f"parent {what} launch: CUDA error {rc_}")

    f = (_filter_coeff(FREQ_LO, 48_000), _filter_coeff(FREQ_HI, 48_000), VSA)
    eq_r, eq_rows = eqc.resident_tiles(0), eqc.rows_resident(0)
    for B, S in BATCHED_AB["eq_cascade"] if "eq_cascade" in kinds else ():
        x, xd = (torch.rand((B, S), generator=g, device=dev) * 2 - 1 for _ in range(2))
        poles = torch.rand((B, 4, 2), generator=g, device=dev) * 0.2 - 0.1
        gains = torch.rand((B, 3), generator=g, device=dev) + 0.5
        try:  # the parent's plan: its grid where it fits, else one CTA a block
            run, tiles = eqc.scan_plan(S, eq_r, eqc.THREADS, eqc.RUN, B)
            seq = 0
        except ValueError:
            run, tiles, seq = 16, -(-S // (eqc.THREADS * 16)), 1
        tables = eqc._device_tables(f[0], f[1], dev)
        at = -(-B * S // 4) * 4
        pbuf = torch.empty(at + 8 * B + 8 * B * (1 if seq else tiles), device=dev)
        parent_call = lambda: check(lib.mixlab_eq_cascade(
            x.data_ptr(), xd.data_ptr(), S, B, seq, poles.data_ptr(), gains.data_ptr(),
            tables.data_ptr(), *f, run, eqc.THREADS, tiles, pbuf.data_ptr() + 4 * (at + 8 * B),
            pbuf.data_ptr(), pbuf.data_ptr() + 4 * at, 0, raw(0)), "eq")
        chosen = eqc.batch_plan(S, B, eq_r, eq_rows)
        forms = {"change": chosen, **_variants(chosen, {"rows": eqc.rows_plan(S, B, eq_rows)})}
        fns = {"parent": parent_call, **{
            who: (lambda p=p: eqc._launch(x, xd, poles, gains, *f, 0, plan=p))
            for who, p in forms.items()}}
        labels = {"parent": f"one CTA a block, {tiles} tiles of 2048" if seq
                  else f"grid {tiles} x {B}",
                  **{who: form_name(eqc, p, B) for who, p in forms.items()}}
        parent_call()
        torch.cuda.synchronize()
        worst = 0.0
        for who, fn in fns.items():
            if who == "parent":
                continue
            out, pk = fn()
            torch.cuda.synchronize()
            for a, b in ((out.reshape(-1), pbuf[:B * S]), (pk.reshape(-1), pbuf[at:at + 8 * B])):
                ok, err = _close(torch, a, b, EQ_TOL)
                if not ok:
                    raise AssertionError(f"batched eq {B}x{S} {who}: max err {err} from the "
                                         "parent")
                worst = max(worst, err)
        res = _turns(torch, fns, "eq_", rounds, 10)
        b_ms, b_by = bound(12.0 * B * S, eq_flops(S) * B)
        _ab_log(np, card, "eq", B, S, res, labels, b_ms, b_by,
                f"output and poles within {worst:.3e} of the parent's")
        del x, xd, pbuf

    env_r = envc.resident_tiles(0)
    for B, S in BATCHED_AB["envelope"] if "envelope" in kinds else ():
        gate, st, prm = _env_batch(torch, dev, B, S, g)
        env_rows = envc.rows_resident(0, envc.rows_lane(S))
        chosen = envc.batch_plan(S, B, env_r, env_rows)
        form, lane, tiles, ctas = chosen  # the parent's plan is this checkout's
        at = -(-B * S // 4) * 4
        pbuf = torch.empty(at + (B * tiles * 16 if form == envc.FORM_GRID else 0), device=dev)
        pscr, take = parent_status(16 + envc.STATUS_BYTES * B * tiles)
        pout = {k: torch.empty_like(v) for k, v in st.items()}
        look = form == envc.FORM_LOOKBACK
        parent_call = lambda: check(lib.mixlab_envelope_block(
            gate.data_ptr(), pbuf.data_ptr(), S, B, form, lane, tiles, ctas,
            pscr.data_ptr() if look else pbuf.data_ptr() + 4 * at, take() if look else 0,
            *(prm[k].data_ptr() for k in envc._PARAMS), msps,
            *(st[k].data_ptr() for k in envc._STATE),
            *(pout[k].data_ptr() for k in envc._STATE), 0, raw(0)), "envelope")
        rows = envc.rows_plan(S, B, env_rows)
        forms = {"change": chosen, **_variants(chosen, {
            "rows": rows, "other rows form": _other_rows(envc, rows, env_rows, B)})}
        fns = {"parent": parent_call, **{
            who: (lambda p=p: envc._launch(gate, 0, st, prm, msps, plan=p))
            for who, p in forms.items()}}
        labels = {"parent": form_name(envc, chosen, B),
                  **{who: form_name(envc, p, B) for who, p in forms.items()}}
        parent_call()
        for who, fn in fns.items():
            if who == "parent":
                continue
            out, new = fn()
            torch.cuda.synchronize()
            if not (torch.equal(out.reshape(-1), pbuf[:B * S])
                    and all(torch.equal(new[k], pout[k]) for k in envc._STATE)):
                raise AssertionError(f"batched envelope {B}x{S} {who}: differs from the parent")
        res = _turns(torch, fns, "envelope", rounds, 10)
        _ab_log(np, card, "envelope", B, S, res, labels, *bound(8.0 * B * S, 0.0),
                "outputs bit-equal to the parent's")
        del gate, pbuf

    plans = region_plans(torch)
    resident = rc.resident_tiles(0)
    for B, S in BATCHED_AB["region"] if "region" in kinds else ():
        for key in ("flagship", "sink zoo") if (B, S) == BATCHED_AB["region"][0] else ("flagship",):
            plan, row, consts = plans[key]
            consts = consts.to(dev)
            shape = rc.plan_shape(plan)
            ops, pf = _region_inputs(torch, g, plan, row, B, S, dev)
            sf = torch.rand((B, plan.n_ef), generator=g, device=dev) * 0.2 - 0.1
            rows_res = rc.rows_resident(0, shape)
            chosen = rc.batch_plan(S, B, resident, shape, rows_res)
            grid = chosen.form == rc.FORM_GRID
            scratch = torch.empty((B, max(shape.n_scratch, 1), S) if grid else (1,), device=dev)
            table = [(v.data_ptr(), v.stride(0) * v.element_size() if v.dim() == 2 else 0)
                     for v in ops]
            table += ([(scratch[0, i].data_ptr(), 4 * shape.n_scratch * S)
                       for i in range(shape.n_scratch)] if grid else [(0, 0)] * shape.n_scratch)
            slots = torch.tensor(table, dtype=torch.int64, device=dev)
            words = torch.tensor(plan.words, dtype=torch.int32, device=dev)
            ptaps = torch.empty((B, plan.n_taps, S), device=dev)
            pstap = torch.empty((B, max(plan.n_stap, 1)), device=dev)
            pef = torch.empty((B, plan.n_ef), device=dev)
            pscr, take = parent_status(16 + 4 * -(-B // 4) * 4
                                       + rc.RECORD_BYTES * B * chosen.tiles * shape.n_eq)
            look = chosen.form == rc.FORM_LOOKBACK
            i16 = sum(1 << i for i, dt in enumerate(rc.operand_dtypes(plan))
                      if dt == torch.int16)
            parent_call = lambda: check(lib.mixlab_region_part(
                words.data_ptr(), words.numel(), slots.data_ptr(), plan.n_operands,
                plan.n_slots, pf.data_ptr(), plan.n_pf, plan.n_pf, consts.data_ptr(),
                sf.data_ptr(), plan.n_ef, ptaps.data_ptr(), plan.n_taps, pstap.data_ptr(),
                plan.n_stap, pef.data_ptr(), plan.n_ef, S, B, *chosen, shape.n_eq, i16,
                pscr.data_ptr() if look else 0, take() if look else 0, 0, raw(0)), "region")
            rows = rc.rows_plan(S, B, shape, rows_res)
            forms = {"change": chosen, **_variants(chosen, {
                "rows": rows, "other rows form": _other_rows(rc, rows, rows_res, B)})}
            fns = {"parent": parent_call, **{
                who: (lambda p=p: rc.region_part_batched(plan, ops, pf, sf, S, consts, B, form=p))
                for who, p in forms.items()}}
            labels = {"parent": form_name(rc, chosen, B),
                      **{who: form_name(rc, p, B) for who, p in forms.items()}}
            parent_call()
            worst = 0.0
            for who, fn in fns.items():
                if who == "parent":
                    continue
                taps, stap, ef = fn()
                torch.cuda.synchronize()
                err = max(_rows_err(torch, a, b)
                          for a, b in ((taps, ptaps), (stap, pstap[:, :plan.n_stap]), (ef, pef)))
                exact = _peaks_exact(torch, plan, ops, taps, stap)
                if not (err <= REGION_ATOL and exact):
                    raise AssertionError(f"batched region {key} {B}x{S} {who}: max err {err} "
                                         f"from the parent, scalar taps exact {exact}")
                worst = max(worst, err)
            res = _turns(torch, fns, "region", rounds, 10)
            _ab_log(np, card, f"region {key}", B, S, res, labels, *bound(*region_work(
                plan, ops, S, B)), f"taps and exits within {worst:.3e} of the parent's, scalar "
                "taps exactly the max of their own taps")
            del ops, ptaps, scratch
    return 0


def fleet_ab(parent: str, rounds: int = 2) -> int:
    """Not in ``main``: the 15-tick fleet (phase 16 b: the flagship at 48 kHz,
    N = 1,024 and 8,192 sessions with their own params, one eq launch a
    block) with the parent's eq kernel (``parent``: a checkout's root; its
    plan: one CTA a block in tiles of 2,048 where the grid does not fit) and
    this checkout's, in turns (parent, change, change, parent, ``rounds``
    times): the wall a block (median of 6), the device time a block and the
    eq kernel's device time a launch (a profile of 3 blocks).  The parent's
    launch replaces ``mixlab_eq_cascade`` behind the wrapper and takes the
    wrapper's arguments through its own C signature (``parent_library``).
    For information: the wall is the host's.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.fleet_ab("<dir>"))'``"""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.dsp import eq_cuda as eqc
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel.fleet import Fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda", 0)
    log(card)
    lib = parent_library(parent, ("eq_cascade.cu",))
    kernels.load()
    kernels._raw_stream = torch._C._cuda_getCurrentRawStream

    def parent_eq(x, xd, S, B, form, p0, gains, tables, f_lo, f_hi, vsa, run, threads, tiles,
                  ctas, scratch, out, poles_out, device, stream):
        seq = int(form != eqc.FORM_GRID)
        if seq:  # its one CTA a block: tiles of 128 x 16, 8 floats a block of scratch
            run, threads, tiles = 16, eqc.THREADS, -(-S // (eqc.THREADS * 16))
            scratch = torch.empty(8 * B, device=dev).data_ptr()
        return lib.mixlab_eq_cascade(x, xd, S, B, seq, p0, gains, tables, f_lo, f_hi, vsa, run,
                                     threads, tiles, scratch, out, poles_out, device, stream)

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(FLEET_TICKS)
    spb = block.n_samples(cfg)
    for n in FLEET_N:
        wss = fleet_workspaces(n)
        fleet = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, device=str(dev))
        res = {"parent": [], "change": []}
        b = 0
        for _ in range(rounds):
            for who in ("parent", "change", "change", "parent"):
                kernels._entries.pop("mixlab_eq_cascade", None)
                if who == "parent":
                    kernels._entries["mixlab_eq_cascade"] = parent_eq
                fleet.run_block(b * spb)
                torch.cuda.synchronize()
                walls = []
                for b in range(b + 1, b + 7):
                    t = time.perf_counter()
                    fleet.run_block(b * spb)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for b in range(b + 1, b + 4):
                        fleet.run_block(b * spb)
                    torch.cuda.synchronize()
                rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                eq = [e.self_device_time_total / e.count for e in rows if e.count and any(
                    k in e.key for k in ("eq_cascade", "eq_rows"))]
                res[who].append((float(np.median(walls)) * 1e3,
                                 sum(e.self_device_time_total for e in rows) / 3e3,
                                 eq[0] if eq else None))
        kernels._entries.pop("mixlab_eq_cascade", None)
        for who, runs in res.items():
            log(f"A/B fleet N={n} x {FLEET_TICKS} ticks [{card}] {who}: wall ms a block "
                + " ".join(f"{w:.3f}" for w, _, _ in runs)
                + f" (median {np.median([w for w, _, _ in runs]):.3f}); device ms a block "
                + " ".join(f"{d:.3f}" for _, d, _ in runs)
                + f" (median {np.median([d for _, d, _ in runs]):.3f}); eq kernel us a launch "
                + " ".join(_us(e) for _, _, e in runs))
        del fleet
        torch.cuda.empty_cache()
    return 0


def batched_paths(torch, np, dev, card):
    """Phase 16: -> (errors, times, {path: launches}, information)."""
    errs, times = batched_kernels(torch, np, dev, card)
    paths, info = {}, {}
    paths["fleet"], info["fleet"] = fleet_path(torch, np, dev, card)
    paths["fleet_served"], info["fleet_served"] = fleet_served(torch, np, dev, card)
    paths["stems"], info["stems"] = stems_path(torch, np, dev, card)
    return errs, times, paths, info


# ---------------------------------------------------------------------------
# phase 20: the batched region (the region kernel over a batch; the fleet,
# fleet serving and the mesh on the whole-graph region program under vmap)
# ---------------------------------------------------------------------------

REGION_FLEET_TICKS = (16, 48)    # 12,800 samples at 48 kHz (100 chunks), 38,400
# 8,320: a last tile of one chunk; 204,800: two parts of 102,400
REGION_EDGE_S = (8192, 8_320, 12_800, 38_400, 204_800)
REGION_EDGE_B = (1, 2, 1024, 8192)
# the edges' batches stop at the fleet's largest block (8,192 rows of 12,800)
REGION_MAX_SAMPLES = 8192 * 12_800
REGION_TIMED = ((1024, 12_800), (8192, 12_800))


def region_plans(torch):
    """{name: (plan, param row, consts)}: the flagship's and the sink zoo's
    region plans at 48 kHz, taken from one 16-tick block of each program on
    the CPU (the twin: no launch), and a plan of one PEAK and one TAP."""
    from mixlab_tpu_torch.dsp.base import OP_PEAK, OP_TAP, RegionPlan
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph

    cfg, cpu, out = EngineConfig(sample_rate=48_000), torch.device("cpu"), {}
    real = region_cuda.region_part_cuda
    for name, ws in (("flagship", build_16_module_graph()[0]), ("sink zoo", sink_zoo()[0])):
        patch = compile_patch(ws, cfg, BlockSpec(16), cpu)

        def grab(plan, operands, pf, sf, S, consts=None, *rest, _name=name):
            out.setdefault(_name, (plan, *region_cuda._split(plan, pf, consts)))
            return real(plan, operands, pf, sf, S, consts, *rest)

        region_cuda.region_part_cuda = grab
        try:
            patch.run(patch.prepare_aux(ws), patch.host_aux(0), patch.init_state(ws))
        finally:
            region_cuda.region_part_cuda = real
    plan = RegionPlan(2, n_pf=0, n_ef=0)
    plan.add(OP_PEAK, 0, 0, 1)
    plan.add(OP_TAP, 0, 0)
    plan.n_taps, plan.n_stap = 1, 1
    out["peak"] = (plan, torch.zeros(0), torch.zeros(0))
    return out


def _region_inputs(torch, g, plan, row, B, S, dev, shared=(), nan=False):
    """One block's random inputs for B rows of ``plan``: operands [B, S]
    (i16 where the plan reads i16; the operands in ``shared`` one [S] row that
    every row reads), the param rows the captured row times U(0.5, 1.5)."""
    from mixlab_tpu_torch.engine import region_cuda

    ops = []
    for i, dt in enumerate(region_cuda.operand_dtypes(plan)):
        shape = (S,) if i in shared else (B, S)
        if dt == torch.int16:
            ops.append(torch.randint(-32768, 32767, shape, generator=g, device=dev,
                                     dtype=torch.int16))
        else:
            ops.append(torch.rand(shape, generator=g, device=dev) * 2 - 1)
    if nan:  # one sample of the last row, in its middle tile, above every other
        ops[0][-1, S // 2 + 7] = float("nan")
        ops[1][0, S // 2 + 100] = 1e30
    pf = row.to(dev) * (torch.rand((B, row.numel()), generator=g, device=dev) + 0.5)
    return ops, pf


def _rows_err(torch, got, want):
    """Max |got - want| where both are numbers; inf if their NaNs differ."""
    if not torch.equal(got.isnan(), want.isnan()):
        return float("inf")
    d = (got - want).abs().nan_to_num(nan=0.0)
    return d.max().item() if d.numel() else 0.0


def _same_bits(torch, got, want):
    return torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0)) and torch.equal(
        got.isnan(), want.isnan())


def _peaks_exact(torch, plan, part, taps, stap):
    """Whether every scalar tap of a launch is EXACTLY the max of |l|, |r|
    over the part, NaN winning, with l and r read back from the launch's own
    taps (or operands): the reduction checked apart from the rounding of the
    ops before it."""
    from mixlab_tpu_torch.dsp import base

    tapped = {a[1]: a[0] for code, a in plan.ops() if code == base.OP_TAP}
    for code, a in plan.ops():
        if code != base.OP_PEAK:
            continue
        vals = [taps[:, tapped[s]] if s in tapped else part[s].float().expand(taps.shape[0], -1)
                for s in a[1:]]
        want = torch.maximum(vals[0].abs(), vals[1].abs()).amax(dim=1)
        if not _same_bits(torch, stap[:, a[0]], want):
            return False
    return True


def region_edges(torch, np, dev, card):
    """(a) the region kernel against its batched twin in every form its plan
    takes (and, where the plan takes the cooperative grid, the rows form
    forced beside it), at B = 1, 2, where B x G just fits at L = 4, where the
    plan switches form (past the largest grid; between the look-back and one
    CTA a row), 1,024 and 8,192 (B x S at most REGION_MAX_SAMPLES) x S of
    REGION_EDGE_S (8,320: a last tile of one chunk; 204,800 as the program
    cuts it: two parts, the exits carried from part to part in each row), 3
    carried blocks; the flagship's plan, the same with one operand every row
    shares (row stride 0), the sink zoo's plan and a PEAK plan with a NaN in
    one row.  Taps, scalar taps and exits within REGION_ATOL of the twin's;
    each scalar tap EXACTLY the max over the launch's own tapped values
    (``_peaks_exact``); the flagship's plan one launch a call and no memset
    at every B (``launches_a_call``).  -> (max abs err, timing rows)."""
    from mixlab_tpu_torch.engine import region_cuda as rc
    from mixlab_tpu_torch.engine.region_graph import _partition

    g = torch.Generator(device=dev).manual_seed(20)
    plans = region_plans(torch)
    resident = rc.resident_tiles(dev.index or 0)
    worst, t0 = 0.0, time.perf_counter()
    for S in REGION_EDGE_S:
        parts = _partition(S)
        P = parts[0][1]
        fit = resident // -(-P // (rc.CHUNK * rc.RUN))
        for name, key, shared, nan, pick in (
                ("flagship", "flagship", (), False, lambda b, sw: True),
                ("flagship, operand 0 shared", "flagship", (0,), False,
                 lambda b, sw: b in (2, 1024, *sw[1::2])),
                ("sink zoo", "sink zoo", (), False, lambda b, sw: b in (1, 2, *sw)),
                ("peak with a NaN", "peak", (), True, lambda b, sw: b in (2, *sw[1::2]))):
            plan, row, consts = plans[key]
            consts = consts.to(dev)
            shape = rc.plan_shape(plan)
            rows_r = rc.rows_resident(dev.index or 0, shape)
            # where the plan switches form: past the largest grid, between the
            # look-back and one CTA a row
            switch = switch_points(lambda b: rc.batch_plan(P, b, resident, shape, rows_r),
                                   2 * rows_r)
            bs = sorted({b for b in (*REGION_EDGE_B, fit, fit + 1, *switch)
                         if 0 < b and b * S <= REGION_MAX_SAMPLES and pick(b, switch)})
            for B in bs:
                chosen = rc.batch_plan(P, B, resident, shape, rows_r)
                # where the plan takes the grid, the rows form is forced beside it
                forms = [None] + ([rc.rows_plan(P, B, shape, rows_r)]
                                  if chosen.form == rc.FORM_GRID else [])
                s0 = torch.rand((B, plan.n_ef), generator=g, device=dev) * 0.2 - 0.1
                sf = {f: s0.clone() for f in ("twin", *forms)}
                errs, staps = [], True
                for blk in range(3):
                    ops, pf = _region_inputs(torch, g, plan, row, B, S, dev, shared,
                                             nan and blk == 1)
                    for a, b in parts:
                        part = [v[..., a:b] for v in ops]
                        want = rc.region_part_torch_batched(plan, part, pf, sf["twin"], b - a,
                                                            consts, B)
                        sf["twin"] = want[2]
                        for f in forms:
                            got = rc.region_part_batched(plan, part, pf, sf[f], b - a, consts,
                                                         B, form=f)
                            sf[f] = got[2]
                            errs.append(max(_rows_err(torch, g, w) for g, w in zip(got, want)))
                            staps = staps and _peaks_exact(torch, plan, part, got[0], got[1])
                err = max(errs)
                if key == "flagship" and not shared:  # one launch a call, no memset
                    a, b = parts[-1]
                    per_call, memsets, kernels_ = launches_a_call(
                        torch, lambda: rc.region_part_batched(
                            plan, [v[..., a:b] for v in ops], pf, sf[None], b - a, consts, B))
                    if per_call != 1 or memsets:
                        raise AssertionError(f"batched region B={B} S={S}: {per_call} launches "
                                             f"and {memsets} memsets a call ({kernels_})")
                log(f"batched region kernel vs twin, {name}, B={B} S={S} ({len(parts)} part(s); "
                    f"plan: {form_name(rc, chosen, B)}; forms "
                    f"{['the plan' if f is None else form_name(rc, f, B) for f in forms]}), 3 "
                    f"blocks: max abs err {err:.3e}, scalar taps exact {staps}"
                    + (", 1 launch a call, no memset" if key == "flagship" and not shared
                       else ""))
                if not (err <= REGION_ATOL and staps):
                    raise AssertionError(f"batched region {name} B={B} S={S}: max err {err}, "
                                         f"scalar taps exact {staps}")
                worst = max(worst, err)
    log(f"phase 20 (a) took {time.perf_counter() - t0:.1f} s")

    times = {}
    plan, row, consts = plans["flagship"]
    consts = consts.to(dev)
    for B, S in REGION_TIMED:
        ops, pf = _region_inputs(torch, g, plan, row, B, S, dev)
        sf = torch.rand((B, plan.n_ef), generator=g, device=dev) * 0.2 - 0.1
        call = lambda: rc.region_part_batched(plan, ops, pf, sf, S, consts, B)
        n = rc.region_part_cuda.launches
        # the profile may come up short of records (phase 16); the launches
        # a call are the wrapper's count, the device time the rows' mean
        found = _device_us(torch, call, "region", n=5)
        if len(found) > 1 or rc.region_part_cuda.launches - n != 6:
            raise AssertionError(f"batched region B={B}: device kernels {found}, "
                                 f"{rc.region_part_cuda.launches - n} launches in 6 calls")
        device_us = found[0][1] if found else None  # None: the profile recorded no row
        nbytes, flops = region_work(plan, ops, S, B)
        b_ms, b_by = bound(nbytes, flops)
        shape = rc.plan_shape(plan)
        chosen = rc.batch_plan(S, B, resident, shape, rc.rows_resident(dev.index or 0, shape))
        times[f"{B}x{S}"] = r = {
            "ms": time_ms(torch, call, n=20, warmup=3), "device_us": device_us,
            "plain_ms": time_ms(torch, lambda: rc.region_part_torch_batched(
                plan, ops, pf, sf, S, consts, B), n=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "form": form_name(rc, chosen, B)}
        log(f"batched region B={B} S={S} [{card}]: {r['ms']:.4f} ms a call, "
            f"{_us(device_us)} us device a launch ({r['form']}), twin {r['plain_ms']:.3f} ms, "
            f"bound {b_ms * 1e3:.1f} us ({b_by}, {nbytes} B), share of the bound "
            f"{_share(b_ms, device_us)}")
        del ops
    return worst, times


def _fleet_block_profile(torch, fleet, spb, first):
    """(device seconds a block, every device row, most time first) over 3
    blocks from ``first``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in range(first, first + 3):
            fleet.run_block(b * spb)
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    if not rows:  # the profile recorded no device row
        return None, []
    return sum(e.self_device_time_total for e in rows) / 3 / 1e6, rows


def region_fleet(torch, np, dev, card):
    """(b) the fleet at 48 kHz with per-instance params on the region program
    (16 ticks: N = 1,024 and 8,192; 48 ticks: N = 1,024) beside the same
    fleet on the regular batched program (``mega=False``): one block's
    launches with the counts set to 0 just before and read just after
    (region 1, eq 0, envelope 1: a batch takes it at any length), taps and state
    within REGION_ATOL of the regular fleet's over 2 blocks, four slots
    within REGION_ATOL of single-patch region renders; then, in turns, the
    wall a block (median of 6), device ms a block with the top six kernels,
    busy share and peak device memory of each.  -> ({path: launches}, info)."""
    from mixlab_tpu_torch.convert import tree_leaves
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.engine.region_graph import _partition
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, counters = EngineConfig(sample_rate=48_000), launch_counters()
    paths, info = {}, {}
    for ticks, ns in zip(REGION_FLEET_TICKS, (FLEET_N, FLEET_N[:1])):
        block = BlockSpec(ticks)
        spb = block.n_samples(cfg)
        parts = len(_partition(spb))
        for n in ns:
            t = time.perf_counter()
            wss = fleet_workspaces(n)
            fleets = {"region": Fleet.build(wss[0], n, cfg, block, per_instance_params=wss,
                                            device=str(dev)),
                      "regular": Fleet.build(wss[0], n, cfg, block, per_instance_params=wss,
                                             device=str(dev), mega=False)}
            built = time.perf_counter() - t
            if not fleets["region"].patch._mega or fleets["regular"].patch._mega:
                raise AssertionError(f"fleet at {ticks} ticks: region program chosen "
                                     f"{fleets['region'].patch._mega}")
            for fl in fleets.values():
                fl.run_block(0)
            torch.cuda.synchronize()
            _reset(counters)
            taps = fleets["region"].run_block(spb)
            torch.cuda.synchronize()
            launches = _read(counters)
            log(f"region fleet N={n} at {ticks} ticks: one block launched {launches}")
            if (launches["region"], launches["eq_cascade"], launches["envelope"]) != (parts, 0, 1):
                raise AssertionError(f"region fleet block launched {launches} (want region "
                                     f"{parts}, eq_cascade 0, envelope 1)")
            paths[f"fleet_region_{ticks}_{n}"] = launches
            ref = fleets["regular"].run_block(spb)
            err = max((a - b).abs().max().item()
                      for a, b in zip(taps["16"]["audio"], ref["16"]["audio"]))
            st_err = max((a.double() - b.double()).abs().max().item() for a, b in zip(
                tree_leaves(fleets["region"].state), tree_leaves(fleets["regular"].state)))
            slot_err = 0.0
            for i in (0, 1, n // 2, n - 1):
                patch = compile_patch(wss[i], cfg, block, dev)
                aux, st = patch.prepare_aux(wss[i]), patch.init_state(wss[i])
                for b in range(2):
                    st, want = patch.run(aux, patch.host_aux(b * spb), st)
                for c in range(2):
                    got_c = taps["16"]["audio"][c][i]
                    if not bool(torch.isfinite(got_c).all()):
                        raise AssertionError(f"region fleet slot {i}: not finite")
                    slot_err = max(slot_err, (got_c - want["16"]["audio"][c]).abs().max().item())
            log(f"region fleet N={n} at {ticks} ticks (built with the regular fleet in "
                f"{built:.2f} s): taps vs the regular fleet max err {err:.3e}, state "
                f"{st_err:.3e}; four slots vs single-patch region renders {slot_err:.3e} "
                f"(2 blocks, atol {REGION_ATOL})")
            if not max(err, st_err, slot_err) <= REGION_ATOL:
                raise AssertionError(f"region fleet N={n}: vs regular {err} / {st_err}, vs "
                                     f"single renders {slot_err}")
            walls = {k: [] for k in fleets}
            for b in range(2, 8):
                for k, fl in fleets.items():
                    t = time.perf_counter()
                    fl.run_block(b * spb)
                    torch.cuda.synchronize()
                    walls[k].append(time.perf_counter() - t)
            for k, fl in fleets.items():
                wall = float(np.median(walls[k]))
                dev_s, rows = _fleet_block_profile(torch, fl, spb, 8)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fl.run_block(11 * spb)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                info[f"{k}_{ticks}_{n}"] = r = {
                    "wall_ms": wall * 1e3, "device_ms": dev_s and dev_s * 1e3,
                    "busy": dev_s and dev_s / wall, "peak_gib": peak / 2**30,
                    "block_gib": (peak - before) / 2**30, "realtime": ticks / 60 / wall}
                device = ("not recorded" if dev_s is None else
                          f"{r['device_ms']:.3f} ms a block = busy share {r['busy']:.3f}")
                log(f"fleet N={n} at {ticks} ticks, {k} program [{card}]: wall "
                    f"{r['wall_ms']:.3f} ms a block (median of 6, in turns), "
                    f"{r['realtime']:.2f} x realtime, device {device}, peak device memory "
                    f"{r['peak_gib']:.2f} GiB (both fleets resident; {r['block_gib']:.2f} GiB "
                    f"above it during the block)")
                for e in rows[:6]:
                    log(f"  {e.self_device_time_total / 3e3:9.3f} ms a block {e.count / 3:6.0f}x  "
                        f"{e.key[:90]}")
                for e in rows:  # the batched kernels' own launches
                    if "region_" in e.key or "envelope_" in e.key:
                        log(f"  {k} program N={n} at {ticks} ticks [{card}]: {e.key[:60]} "
                            f"{e.self_device_time_total / e.count:.1f} us device a launch, "
                            f"{e.count / 3:.0f} a block")
            del fleets, taps, ref
            torch.cuda.empty_cache()
    return paths, info


def batched_region(torch, np, dev, card):
    """Phase 20: -> (max abs err, timing rows, {path: launches}, info)."""
    t = time.perf_counter()
    err, times = region_edges(torch, np, dev, card)
    paths, info = region_fleet(torch, np, dev, card)
    paths["fleet_served_16"], info["fleet_served_16"] = fleet_served(
        torch, np, dev, card, ticks_a_block=REGION_FLEET_TICKS[0])
    paths["mesh_fleet_16"] = mesh_fleet(torch, np, dev, card, ticks=REGION_FLEET_TICKS[0])
    log(f"phase 20 (batched region) took {time.perf_counter() - t:.1f} s")
    return err, times, paths, info


def region_phase() -> int:
    """Not in ``main`` alone: phase 20 by itself, after the build, with TF32
    off as ``main`` sets it.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.region_phase())'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda", torch.cuda.current_device())
    log(card)
    kernels.load()
    batched_region(torch, np, dev, card)
    return 0


# ---------------------------------------------------------------------------
# phase 22: the look-back's launch number on the device (csrc/rows.cuh)
# ---------------------------------------------------------------------------

# look-back shapes of the wrappers' own plans: the region's 102,400-sample
# parts, the envelope's config 3
LOOKBACK_SHAPES = {"envelope": (32, 96_000), "region": (64, 102_400)}
LOOKBACK_REPLAYS = 4
LOOKBACK_THREAD_CALLS = 200


def lookback_cases(torch, dev, forced=False):
    """{kernel: (make(seed) -> [tensor], call([tensor]) -> outputs, twin(...)
    -> outputs, check(got, want) -> max error or None where they differ,
    plan)} for the look-back kernels: at ``LOOKBACK_SHAPES`` through each
    wrapper's batched entry (its plan must take the look-back), or
    (``forced``) small blocks with the look-back forced over 8 CTAs."""
    from mixlab_tpu_torch.dsp import envelope_cuda as envc
    from mixlab_tpu_torch.engine import region_cuda as rc

    index, msps = dev.index or 0, 1000 / 48_000
    cases = {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(1000 + seed)

    def rand(g, *shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    # the envelope (bit-equal to its twin)
    B, S = (4, 20_000) if forced else LOOKBACK_SHAPES["envelope"]
    lane = envc.rows_lane(S)
    tiles = -(-S // (envc.THREADS * lane))
    plan = (envc.BatchPlan(envc.FORM_LOOKBACK, lane, tiles, 8) if forced
            else envc.batch_plan(S, B, envc.resident_tiles(index), envc.rows_resident(index, lane)))

    def env_make(seed, B=B, S=S):
        g = gen(seed)
        u = torch.rand((B, S), generator=g, device=dev)
        gate = torch.where(u < 3e-4, 0.0, torch.where(u < 6e-4, 1.0, 0.5))
        return [gate, (rand(g, B) > 0).contiguous(),
                (rand(g, B, lo=-40_000, hi=0)).to(torch.int32),
                (rand(g, B, lo=-40_000, hi=0)).to(torch.int32), rand(g, B, lo=0.0, hi=1.0),
                rand(g, B, lo=0.0, hi=30.0), rand(g, B, lo=1.0, hi=500.0),
                rand(g, B, lo=0.0, hi=1.0), rand(g, B, lo=1.0, hi=300.0)]

    def env_args(ts):
        return (ts[0], dict(zip(envc._STATE, ts[1:5])), dict(zip(envc._PARAMS, ts[5:9])))

    def env_flat(res):
        return [res[0], *(res[1][k] for k in envc._STATE)]

    def env_check(got, want):
        same = all(_same_bits(torch, a, b) if a.is_floating_point() else torch.equal(a, b)
                   for a, b in zip(got, want))
        return 0.0 if same else None

    cases["envelope"] = (
        env_make, (lambda ts, plan=plan: env_flat(envc._launch(
            ts[0], index, *env_args(ts)[1:], msps, plan=plan))) if forced
        else (lambda ts: env_flat(envc.envelope_block_batched(*env_args(ts), msps))),
        lambda ts: env_flat(envc.envelope_block_torch_batched(*env_args(ts), msps)), env_check,
        plan)

    # the region (the flagship's plan)
    rplan, row, consts = region_plans(torch)["flagship"]
    consts = consts.to(dev)
    shape = rc.plan_shape(rplan)
    B, S = (3, 12_800) if forced else LOOKBACK_SHAPES["region"]
    plan = (rc.BatchPlan(rc.FORM_LOOKBACK, 8, -(-S // 1024), 8) if forced
            else rc.batch_plan(S, B, rc.resident_tiles(index), shape, rc.rows_resident(index, shape)))
    n_ops = rplan.n_operands

    def region_make(seed, B=B, S=S):
        g = gen(seed)
        ops, pf = _region_inputs(torch, g, rplan, row, B, S, dev)
        return [*ops, pf, rand(g, B, rplan.n_ef, lo=-0.1, hi=0.1)]

    def region_check(got, want):
        err = max(_rows_err(torch, a, b) for a, b in zip(got, want))
        return err if err <= REGION_ATOL else None

    cases["region"] = (
        region_make, lambda ts, plan=plan, B=B, S=S: rc.region_part_batched(
            rplan, ts[:n_ops], ts[n_ops], ts[n_ops + 1], S, consts, B, form=plan if forced else None),
        lambda ts, B=B, S=S: rc.region_part_torch_batched(
            rplan, ts[:n_ops], ts[n_ops], ts[n_ops + 1], S, consts, B), region_check, plan)
    return cases


def _ended(torch, kernel, index, stream) -> int:
    """The launches that ended on ``kernel``'s status scratch for card
    ``index`` and ``stream`` (word 0 of its header, ``csrc/rows.cuh``)."""
    from mixlab_tpu_torch import kernels

    scratch = kernels._status[(kernel, index, stream.cuda_stream)]
    return int(scratch[:16].view(torch.int32)[0].item())


def lookback_replays(torch, dev, kernel, replays=LOOKBACK_REPLAYS) -> float:
    """``kernel``'s look-back launch at its ``LOOKBACK_SHAPES`` (its plan
    must take the look-back): two calls on a side stream, then the launch
    captured on that stream into a CUDA graph (its status scratch, made by
    the calls, exists before the capture) and replayed ``replays`` times on
    it with new inputs copied into the graph's static tensors, an eager call
    on other inputs after each replay.  Every replay and every eager call
    must match the twin on its inputs (the envelope bit for bit, the region
    within 2e-5), and the scratch's header must count every launch made on
    it, so each replay ran under a number of its own.  Returns the largest
    error."""
    make, call, twin, check, plan = lookback_cases(torch, dev)[kernel]
    if plan.form != 2:
        raise AssertionError(f"{kernel} {LOOKBACK_SHAPES[kernel]}: the plan takes {plan}, not "
                             "the look-back")
    worst = 0.0

    def held(got, ts, what):
        nonlocal worst
        err = check(got, twin(ts))
        if err is None:
            raise AssertionError(f"{kernel}: {what} differs from the twin")
        worst = max(worst, err)

    static = make(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            call(static)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outs = call(static)
        made = 2
        for r in range(1, replays + 1):
            new = make(r)
            for t, v in zip(static, new):
                t.copy_(v)
            graph.replay()
            held(outs, new, f"captured look-back launch, replay {r},")
            eager = make(100 + r)
            held(call(eager), eager, f"the eager call after replay {r}")
            made += 2
        side.synchronize()
        ended = _ended(torch, kernel, dev.index or 0, side)
    if ended != made:
        raise AssertionError(f"{kernel}: the status scratch counts {ended} launches ended, "
                             f"{made} were made")
    del graph
    return worst


def lookback_threads(torch, dev, kernel, calls=LOOKBACK_THREAD_CALLS) -> float:
    """Two host threads, each ``calls`` look-back launches of ``kernel`` (the
    form forced over 8 CTAs, small blocks) on one stream, each thread its
    own inputs: every call must match the twin, and the scratch's header
    must count every launch.  Returns the largest error."""
    make, call, twin, check, _ = lookback_cases(torch, dev, forced=True)[kernel]
    ins = [make(k) for k in range(2)]
    wants = [twin(ts) for ts in ins]
    stream = torch.cuda.current_stream()
    call(ins[0])  # the scratch at this size, made before the threads
    torch.cuda.synchronize()
    before = _ended(torch, kernel, dev.index or 0, stream)
    outs, faults = [[], []], []

    def work(k):
        try:
            for _ in range(calls):
                outs[k].append(call(ins[k]))
        except BaseException as e:  # noqa: BLE001 - reported below
            faults.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if faults:
        raise faults[0]
    ended = _ended(torch, kernel, dev.index or 0, stream) - before
    if ended != 2 * calls:
        raise AssertionError(f"{kernel}: the status scratch counts {ended} launches ended of "
                             f"{2 * calls}")
    worst = 0.0
    for k in range(2):
        for i, got in enumerate(outs[k]):
            err = check(got, wants[k])
            if err is None:
                raise AssertionError(f"{kernel}: thread {k} call {i} differs from the twin")
            worst = max(worst, err)
    return worst


def lookback_numbers(torch, np, dev, card) -> dict:
    """Phase 22: for each look-back kernel, the captured launch replayed
    (``lookback_replays``) and two threads on one stream
    (``lookback_threads``).  -> {kernel: max error}."""
    t, errs = time.perf_counter(), {}
    for kernel in LOOKBACK_SHAPES:
        e_graph = lookback_replays(torch, dev, kernel)
        e_threads = lookback_threads(torch, dev, kernel)
        errs[kernel] = max(e_graph, e_threads)
        log(f"look-back {kernel} [{card}]: a captured launch at {LOOKBACK_SHAPES[kernel]} "
            f"replayed {LOOKBACK_REPLAYS} times with new inputs, an eager call after each: each "
            f"the twin's (max err {e_graph:.3e}), every launch counted on the device; 2 threads "
            f"x {LOOKBACK_THREAD_CALLS} calls on one stream: each the twin's (max err "
            f"{e_threads:.3e}), every launch counted")
    log(f"phase 22 (the look-back's launch number) took {time.perf_counter() - t:.1f} s")
    return errs


def lookback_phase() -> int:
    """Not in ``main`` alone: phase 22 by itself, after the build.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.lookback_phase())'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda", 0)
    log(card)
    kernels.load()
    lookback_numbers(torch, np, dev, card)
    return 0


# ---------------------------------------------------------------------------
# phase 19: scale-out (the stems, the fleet, the blend and the live engine
# over a mesh; two processes as one mesh; the fleet controller and agents)
# ---------------------------------------------------------------------------

MESH_TICKS = (16, 41)      # 12,800 samples at 48 kHz (the eq kernel's gate open), 32,800 (both)
MESH_SHARDS = (1, 2, 4)
MESH_STEMS = (5, 8)
MESH_FLEET_SHARDS = 4
BLEND_SIZES = ((1080, 1920), (1081, 1920), (1082, 1920), (1083, 1920))
BLEND_FADES = (0, 128, 255)
ENGINE_STEMS = 5
ENGINE_TICKS = 60
ENGINE_TOL = 1e-6          # tests/test_engine_multichip.py:87
CHECKSUM_RTOL = 1e-3       # tests/test_distributed.py:99-104
WORKER_WAIT_S = 180


def _reset(counters):
    for c in counters.values():
        c.launches = 0


def _read(counters):
    return {name: c.launches for name, c in counters.items()}


def mesh_stems(torch, np, dev, card):
    """(a) the flagship's stems at 48 kHz over meshes of 1, 2 and 4 entries
    on the card (and of 2 and 4 distinct cards where there are), 5 stems
    (pad stems on the last shards) and 8, in 16- and 41-tick blocks: the
    master within MIX_ATOL of the same step over a one-entry CPU mesh on the
    same inputs (the kernels' plain twins, so each kernel is held to its
    twin at the shard shapes of this path: B of 2-8 rows at 12,800 and
    32,800 samples) and of the one-entry card mesh's, the batched eq kernel
    once a shard a block, the batched envelope kernel once a shard at any
    length (counts set to 0 just before the step, read just after)."""
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.stems import stem_parallel_step

    ws, mon = build_16_module_graph()
    cfg = EngineConfig(sample_rate=48_000)
    counters = launch_counters()
    meshes = [(f"{k} x {dev}", f"{k}", lambda k=k: make_mesh(k, devices=[str(dev)]))
              for k in MESH_SHARDS]
    meshes += [(f"{k} cards", f"{k}cards", lambda k=k: make_mesh(k)) for k in (2, 4)
               if k <= torch.cuda.device_count()]
    paths = {}
    for ticks in MESH_TICKS:
        block = BlockSpec(ticks)
        for n_stems in MESH_STEMS:
            fn, make_args, patch = stem_parallel_step(ws, cfg, block, str(mon.value),
                                                      n_stems=n_stems, device="cpu")
            twin = fn(*make_args(0))[1]
            # the region program where the block qualifies (16 ticks), as the
            # JAX stems take it: one region launch a shard and no eq launch
            kernel, other = (("region", "eq_cascade") if patch._mega
                             else ("eq_cascade", "region"))
            want = None
            for name, key, make in meshes:
                mesh = make()
                fn, make_args, _ = stem_parallel_step(ws, cfg, block, str(mon.value),
                                                      n_stems=n_stems, mesh=mesh)
                args = make_args(0)
                fn(*args)  # first call: allocations
                torch.cuda.synchronize()
                _reset(counters)
                t = time.perf_counter()
                _, master = fn(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = _read(counters)
                want = master if want is None else want
                err = (master.to(want.device) - want).abs().max().item()
                err_twin = (master.cpu() - twin).abs().max().item()
                log(f"mesh stems [{card}]: {n_stems} stems over {name}, {ticks}-tick blocks: "
                    f"master vs the twins' (one CPU entry) max err {err_twin:.3e}, vs the "
                    f"one-entry card mesh's {err:.3e} (atol {MIX_ATOL}), "
                    f"{wall * 1e3:.3f} ms a step, launches {launches}")
                if not (err <= MIX_ATOL and err_twin <= MIX_ATOL
                        and bool(torch.isfinite(master).all())
                        and launches[kernel] == len(mesh) and launches[other] == 0
                        and launches["envelope"] == len(mesh)):
                    raise AssertionError(f"mesh stems over {name}: err {err}, vs the twins "
                                         f"{err_twin}, launches "
                                         f"{launches} (want {len(mesh)} a kernel)")
                paths[f"mesh_stems_{key}_{ticks}"] = launches
    return paths


def mesh_fleet(torch, np, dev, card, ticks=FLEET_TICKS):
    """(b) the fleet as phase 16 (b) runs it, N = 8,192 sessions with their
    own params in 15-tick blocks (phase 20 (d): 16, on the region program),
    over a 4-entry mesh on the card: one launch a shard a block of the block
    program's kernel (the batched eq's, or the region's where it was chosen;
    counts set to 0 just before the block, read just after), every session's
    taps equal to the one-device fleet's bit for bit over two carried blocks
    where both run the kernel in the same form, else within REGION_ATOL; for
    information the wall per block of each."""
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(ticks)
    spb, n = block.n_samples(cfg), FLEET_N[-1]
    counters = launch_counters()
    t = time.perf_counter()
    wss = fleet_workspaces(n)
    one = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, device=str(dev))
    mesh = make_mesh(MESH_FLEET_SHARDS, axis="fleet", devices=[str(dev)])
    four = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, mesh=mesh, axis="fleet")
    built = time.perf_counter() - t
    kernel, other = ("region", "eq_cascade") if one.patch._mega else ("eq_cascade", "region")
    same_form = True
    if one.patch._mega:  # the form each side's rows take (the flagship's plan)
        shape = region_cuda.plan_shape(region_plans(torch)["flagship"][0])
        plan = lambda rows: region_cuda.batch_plan(
            spb, rows, region_cuda.resident_tiles(dev.index or 0), shape,
            region_cuda.rows_resident(dev.index or 0, shape))
        same_form = plan(n) == plan(n // MESH_FLEET_SHARDS)
    worst, same = 0.0, True
    for b in range(2):
        want = one.run_block(b * spb)
        torch.cuda.synchronize()
        _reset(counters)
        got = four.run_block(b * spb)
        torch.cuda.synchronize()
        launches = _read(counters)
        for g, w in zip(got["16"]["audio"], want["16"]["audio"]):
            same = same and torch.equal(g, w)
            worst = max(worst, (g - w).abs().max().item())
        if (launches[kernel], launches[other], launches["envelope"]) != (
                MESH_FLEET_SHARDS, 0, MESH_FLEET_SHARDS):
            raise AssertionError(f"mesh fleet block {b} launched {launches} (want {kernel} "
                                 f"and envelope {MESH_FLEET_SHARDS})")
    walls = {}
    for name, fleet in (("one device", one), (f"{MESH_FLEET_SHARDS} x {dev}", four)):
        w = []
        for b in range(2, 6):
            t = time.perf_counter()
            fleet.run_block(b * spb)
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t)
        walls[name] = float(np.median(w))
    log(f"mesh fleet [{card}]: N={n} over {MESH_FLEET_SHARDS} shards of {dev}, {ticks}-tick "
        f"blocks (built with the one-device fleet in {built:.2f} s): taps equal bit for bit "
        f"{same} (max err {worst:.3e}; the kernel in the same form on both sides {same_form}), "
        f"launches a block {launches}; wall a block "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in walls.items())
        + " (median of 4, for information)")
    if not (same if same_form else worst <= REGION_ATOL):
        raise AssertionError(f"mesh fleet taps differ from the one-device fleet's: {worst}")
    del one, four
    torch.cuda.empty_cache()
    return launches


def mesh_blend(torch, np, dev, card):
    """(c) ``row_sharded_blend`` over a 4-entry mesh on the card at 1080p
    and at heights that do not divide by 4: equal to the crossfade twin on
    the same planes, one crossfade launch a shard (counts set to 0 just
    before each blend, read just after)."""
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.stems import row_sharded_blend
    from mixlab_tpu_torch.video.blend import crossfade_torch

    counters = launch_counters()
    mesh = make_mesh(4, devices=[str(dev)])
    blend = row_sharded_blend(mesh)
    rng = np.random.default_rng(19)
    launches = None
    for h, w in BLEND_SIZES:
        a = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
        b = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
        for fade in BLEND_FADES:
            _reset(counters)
            out = blend(a, b, fade)
            torch.cuda.synchronize()
            launches = _read(counters)
            if not torch.equal(out, crossfade_torch(a, b, fade)) or launches["crossfade"] != 4:
                raise AssertionError(f"row-sharded blend {h}x{w} fade {fade}: launches "
                                     f"{launches}, equal {torch.equal(out, crossfade_torch(a, b, fade))}")
    ms = time_ms(torch, lambda: blend(a, b, 128), n=50, warmup=5)
    log(f"mesh blend [{card}]: {[s for s in BLEND_SIZES]} over 4 shards of {dev}, fades "
        f"{BLEND_FADES}: equal to the twin, one crossfade launch a shard; "
        f"{ms:.3f} ms a {BLEND_SIZES[-1][0]}x{BLEND_SIZES[-1][1]} blend (for information)")
    return launches


def mesh_engine(torch, np, dev, card):
    """(d) the live ``Engine`` (48 kHz, 2-tick blocks, the graph of
    ``tests/test_engine_multichip.py``: an oscillator through an amplifier
    into the Monitor) with ``StemsPatch.compiler`` over a 2-entry mesh on
    the card, 5 stems, 60 ticks in direct drive with a structural edit at
    tick 30 (a saw oscillator into the Monitor), beside the one-device
    engine taking the same ops in a run of its own before it: every block's
    taps 5 x the one-device engine's within ENGINE_TOL; the counts are set
    to 0 just before the mesh engine's run and read just after.  The
    Monitor's codec thread is stubbed."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.engine import Engine
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.stems import StemsPatch
    from mixlab_tpu_torch.server import monitor

    def template():
        ws = Workspace()
        o = ws.create_module(p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)))
        a = ws.create_module(p.ModuleParams("Amplifier", p.AmplifierParams(amplitude=0.5)))
        m = ws.create_module(p.ModuleParams("Monitor", None))
        ws.connect(p.InputId(a, 0), p.OutputId(o, 1))
        ws.connect(p.InputId(m, 1), p.OutputId(a, 0))
        return ws, m

    def drive(compiler):
        """One engine over ``compiler`` for ENGINE_TICKS ticks with the
        edit at half time: -> (engine, its taps a block)."""
        ws, mon = template()
        eng = Engine(workspace=ws, cfg=cfg, block_ticks=2, device=str(dev),
                     patch_compiler=compiler)
        sid, got, orig = eng.connect_session()[0], [], eng._route_taps

        def route(t0, S, tp, buffers):
            got.append((t0, _fetch(tp, mon)))
            return orig(t0, S, tp, buffers)

        eng._route_taps = route
        while eng.tick < ENGINE_TICKS:
            if eng.tick == ENGINE_TICKS // 2:
                eng.client_update(sid, p.WorkspaceMessage(1, p.CreateModule(
                    p.ModuleParams("Oscillator", p.OscillatorParams(220.0, p.Waveform.SAW)),
                    p.WindowGeometry())))
                new = max(eng.ws.modules, key=lambda m: m.value)
                eng.client_update(sid, p.WorkspaceMessage(2, p.CreateConnection(
                    p.InputId(mon, 1), p.OutputId(new, 1))))
            eng.tick_once()
        torch.cuda.synchronize()
        return eng, got

    cfg = EngineConfig(sample_rate=48_000)
    counters = launch_counters()
    real, monitor.MonitorPipeline = monitor.MonitorPipeline, NoCodec
    try:
        _, one_taps = drive(None)
        compiler = StemsPatch.compiler(make_mesh(2, devices=[str(dev)]), ENGINE_STEMS)
        _reset(counters)
        mesh_eng, mesh_taps = drive(compiler)
        launches = _read(counters)
    finally:
        monitor.MonitorPipeline = real
    taps = (mesh_taps, one_taps)
    worst = 0.0
    for (t0m, gm), (t0s, gs) in zip(*taps):
        if t0m != t0s:
            raise AssertionError(f"mesh engine blocks at t0 {t0m} and {t0s}")
        for m, s in zip(gm, gs):
            np.testing.assert_allclose(m, ENGINE_STEMS * s, rtol=ENGINE_TOL, atol=ENGINE_TOL)
            worst = max(worst, float(np.abs(m - ENGINE_STEMS * s).max()))
    shards = {len(st) for st in mesh_eng._state.values()}
    log(f"mesh engine [{card}]: {len(taps[0])} blocks of 2 ticks over 2 shards of {dev}, a saw "
        f"oscillator added at tick {ENGINE_TICKS // 2}: taps vs {ENGINE_STEMS} x the one-device "
        f"engine's max err {worst:.3e} (rtol = atol = {ENGINE_TOL}); state on {shards} shards "
        f"a module; launches {launches}")
    if len(mesh_taps) != ENGINE_TICKS // 2 or len(one_taps) != len(mesh_taps) \
            or shards != {2}:
        raise AssertionError(f"mesh engine ran {len(mesh_taps)} blocks (one device "
                             f"{len(one_taps)}), state shards {shards}")
    return launches


def _fetch(tp, mon):
    """The Monitor tap's (L, R) of a block as host arrays."""
    return [x.cpu().numpy() for x in tp[str(mon.value)]["audio"]]


def mesh_worker(pid: int, port: int, devices: str, backend: str) -> int:
    """Not in ``main`` alone: one process of phase 19 (e).  Joins the group
    of 2 at ``127.0.0.1:port`` as ``pid`` with the comma-separated
    ``devices`` as its mesh, runs the flagship's 8 stems at 48 kHz in
    16-tick blocks over the global mesh, and prints one JSON line: the
    master's checksum, rms and shape, and this process's launches (counts
    set to 0 just before the step, read just after)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.parallel.distributed import bring_up, distributed_stems_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = bring_up(f"127.0.0.1:{port}", 2, pid, devices=devices.split(","), backend=backend)
    ws, mon = build_16_module_graph()
    fn, make_args, _ = distributed_stems_step(ws, EngineConfig(sample_rate=48_000),
                                              BlockSpec(MESH_TICKS[0]), mesh, str(mon.value),
                                              n_stems=8)
    args = make_args(0)
    fn(*args)
    torch.cuda.synchronize()
    counters = launch_counters()
    _reset(counters)
    _, master = fn(*args)
    torch.cuda.synchronize()
    launches = _read(counters)
    m = master.cpu().double().numpy()
    print(json.dumps({"checksum": float(m.sum()), "rms": float((m ** 2).mean() ** 0.5),
                      "shape": list(m.shape), "launches": launches,
                      "mesh": [str(d) for d in mesh], "size": mesh.size}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def mesh_processes(torch, np, dev, card):
    """(e) two processes in a ``gloo`` group, each a 2-entry mesh on the
    card (``mesh_worker``): the master's checksum within CHECKSUM_RTOL of
    this process's 4-entry mesh's, each process's block-program kernel once
    a shard (at 16 ticks the region's, as the stems take the region program
    there, and no eq launch); with two or more cards, again over ``nccl``
    with each process on its own card."""
    import socket

    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.stems import stem_parallel_step

    ws, mon = build_16_module_graph()
    fn, make_args, patch = stem_parallel_step(ws, EngineConfig(sample_rate=48_000),
                                              BlockSpec(MESH_TICKS[0]), str(mon.value),
                                              n_stems=8, mesh=make_mesh(4, devices=[str(dev)]))
    kernel, other = ("region", "eq_cascade") if patch._mega else ("eq_cascade", "region")
    want = float(fn(*make_args(0))[1].cpu().double().numpy().sum())
    runs = [("gloo", [f"{dev},{dev}"] * 2)]
    if torch.cuda.device_count() > 1:
        runs.append(("nccl", [f"cuda:{i},cuda:{i}" for i in range(2)]))
    paths = {}
    for backend, devices in runs:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke, sys; sys.exit(chip_smoke.mesh_worker("
             f"{pid}, {port}, {devices[pid]!r}, {backend!r}))"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]
        try:
            outs = [proc.communicate(timeout=WORKER_WAIT_S) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(10)
        wall = time.perf_counter() - t
        for proc, (out, err) in zip(procs, outs):
            if proc.returncode != 0:
                raise AssertionError(f"mesh worker ({backend}) exited {proc.returncode}:\n"
                                     + err[-3000:])
        res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        rel = max(abs(r["checksum"] - want) / max(1.0, abs(want)) for r in res)
        log(f"mesh processes [{card}] ({backend}): 2 processes x {res[0]['mesh']} = "
            f"{res[0]['size']} shards, 8 stems: checksum {res[0]['checksum']:.6f} vs one "
            f"process's 4-entry mesh {want:.6f}, rel err {rel:.3e} (limit {CHECKSUM_RTOL}), "
            f"rms {res[0]['rms']:.4f}, launches {[r['launches'] for r in res]}; {wall:.2f} s "
            "with the processes' start")
        if not rel <= CHECKSUM_RTOL or not res[0]["rms"] > 0.01 \
                or res[0]["checksum"] != res[1]["checksum"]:
            raise AssertionError(f"mesh processes ({backend}): {res} vs {want}")
        for r in res:
            if r["launches"][kernel] != 2 or r["launches"][other]:
                raise AssertionError(f"mesh worker launched {r['launches']} (want {kernel} 2)")
        paths[f"mesh_processes_{backend}"] = res[0]["launches"]
    return paths


def mesh_controller(torch, np, dev, card, tmp: Path):
    """(f) ``python -m mixlab_tpu_torch.server.fleet``: a controller and two
    agents with ``--device cuda``, each in a process group of its own.  A
    workspace is placed, one session builds an oscillator into an EqThree
    (whose poles are DSP state), the workspace migrates to the other agent,
    whose worker must report ``restored``; its checkpoint a moment later
    must equal the source worker's checkpoint from before the migration
    continued by an engine on the card to the same tick (EQ_TOL).  SIGTERM
    stops the agents (each stops its worker) and the controller."""
    import asyncio
    import os
    import signal
    import socket

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.engine import Engine
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.engine.project import ProjectBase
    from mixlab_tpu_torch.server.fleet import decode_checkpoint, http_call

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "mixlab_tpu_torch.server.fleet"]
    roles = [cmd + ["controller", "--listen", f"127.0.0.1:{port}"]] + [
        cmd + ["agent", "--controller", url, "--host-id", h, "--data", str(tmp / h),
               "--device", str(dev)] for h in ("agent-a", "agent-b")]
    procs = []
    t_start = time.perf_counter()

    async def drive():
        deadline = time.monotonic() + 120
        while True:
            try:
                status, body = await http_call(url + "/fleet", timeout=5.0)
                if len(procs) == 1:
                    procs.extend(subprocess.Popen(r, cwd=ROOT, start_new_session=True,
                                                  stdout=subprocess.DEVNULL,
                                                  stderr=subprocess.PIPE) for r in roles[1:])
                elif sum(a["live"] for a in json.loads(body)["agents"].values()) == 2:
                    break
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
                pass
            if time.monotonic() > deadline:
                raise AssertionError("the controller saw no two live agents")
            await asyncio.sleep(0.2)
        t = time.perf_counter()
        status, body = await http_call(url + "/workspaces/w", "POST", timeout=180.0)
        if status != 200:
            raise AssertionError(f"placement answered {status}: {body[:300]!r}")
        placed = json.loads(body)
        t_place = time.perf_counter() - t
        reader, writer = await ws_open(int(placed["url"].rsplit(":", 1)[1]), "/session")
        await ws_read(reader)
        await ws_read(reader)
        for seq, op in enumerate([
                p.CreateModule(p.ModuleParams("Oscillator", p.OscillatorParams(
                    440.0, p.Waveform.SINE)), p.WindowGeometry()),
                p.CreateModule(p.ModuleParams("EqThree", p.EqThreeParams(
                    p.Decibel(4.0), p.Decibel(-2.0), p.Decibel(3.0))), p.WindowGeometry()),
                p.CreateConnection(p.InputId(p.ModuleId(2), 0),
                                   p.OutputId(p.ModuleId(1), 0))], 1):
            await ws_op(reader, writer, seq, op)
        writer.close()
        await asyncio.sleep(0.5)
        status, blob = await http_call(placed["url"] + "/_checkpoint", timeout=30.0)
        before = decode_checkpoint(blob)
        other = "agent-b" if placed["host"] == "agent-a" else "agent-a"
        t = time.perf_counter()
        status, body = await http_call(url + "/migrate/w", "POST",
                                       json.dumps({"to": other}).encode(), timeout=180.0)
        if status != 200:
            raise AssertionError(f"migration answered {status}: {body[:300]!r}")
        moved = json.loads(body)
        t_move = time.perf_counter() - t
        status, blob = await http_call(moved["url"] + "/_checkpoint", timeout=30.0)
        route = json.loads((await http_call(url + "/route/w"))[1])
        return placed, moved, route, before, decode_checkpoint(blob), t_place, t_move

    try:
        procs.append(subprocess.Popen(roles[0], cwd=ROOT, start_new_session=True,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
        placed, moved, route, before, after, t_place, t_move = asyncio.run(drive())
        rcs = []
        for proc in reversed(procs):
            proc.send_signal(signal.SIGTERM)
            rcs.append(proc.wait(60))
    finally:
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)  # the role and any worker it left
            except ProcessLookupError:
                pass
            if proc.poll() is None:
                proc.wait(10)
    with ProjectBase(tmp / moved["host"] / "w.mixlab") as base:
        ws = Workspace.from_persist(base.read_workspace())
    ref = Engine(workspace=ws, device=str(dev))
    if not ref.restore_dsp_state(before):
        raise AssertionError("the checkpoint does not fit the migrated workspace")
    while ref.tick < after["tick"]:
        ref.tick_once()
    ref_state = ref.checkpoint()["dsp_state"]
    worst = max(float(np.abs(g - w).max()) for g, w in zip(ref_state, after["dsp_state"]))
    ok = all(np.allclose(g, w, **EQ_TOL) for g, w in zip(ref_state, after["dsp_state"]))
    log(f"fleet controller [{card}]: placed on {placed['host']} in {t_place:.2f} s, migrated to "
        f"{moved['host']} in {t_move:.2f} s (restored {moved.get('restored')}), route "
        f"{route['host']}; tick {before['tick']} before, {after['tick']} after; the EqThree's "
        f"state vs the checkpoint continued on the card: max err {worst:.3e} (EQ_TOL); exits "
        f"{rcs[::-1]}; {time.perf_counter() - t_start:.2f} s in all")
    if not (moved.get("restored") is True and route["host"] == moved["host"] != placed["host"]
            and after["tick"] >= before["tick"] > 0 and len(ref_state) == len(after["dsp_state"])
            and ok and any(np.abs(w).max() > 0 for w in after["dsp_state"])
            and rcs == [0, 0, 0]):
        raise AssertionError(f"fleet controller: {placed}, {moved}, {route}, ticks "
                             f"{before['tick']} -> {after['tick']}, state err {worst}, exits {rcs}")


def scale_out(torch, np, dev, card, tmp: Path):
    """Phase 19: -> {path: launches}."""
    t = time.perf_counter()
    paths = mesh_stems(torch, np, dev, card)
    paths["mesh_fleet"] = mesh_fleet(torch, np, dev, card)
    paths["mesh_blend"] = mesh_blend(torch, np, dev, card)
    paths["mesh_engine"] = mesh_engine(torch, np, dev, card)
    paths.update(mesh_processes(torch, np, dev, card))
    mesh_controller(torch, np, dev, card, tmp)
    log(f"phase 19 (scale-out) took {time.perf_counter() - t:.1f} s")
    return paths


# --------------------------------------------------------------------------
# phase 21: the live engine's edit path

EDIT_WINDOW_S = 5.0
EDIT_STRUCT_HZ = 10        # structural ops a second: create, connect, delete an oscillator
EDIT_FADER_HZ = 30         # VideoMixer fader edits a second (param-only)
EDIT_MIN_TICKS_A_S = 30
EDIT_HOLD_TICKS = 6        # the storm's camera frames last 6 ticks: a feeder's jitter
                           # never leaves the mixer without a picture
EDIT_MESH_TICKS = 16       # 12,800 samples at 48 kHz: the region program
EDIT_MESH_HOLD_S = 0.6     # the mesh engine's warm held this long, as a long compile
EDIT_DEPTHS = (0, 1, 2)
EDIT_DEPTH_TICKS = 120
TICK_BUDGET_S = 1.0 / 60


def _ms(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) * 1e3 if len(xs) else float("nan")


class EditProbe:
    """Records an engine's ticks (through its ``EngineStat.record_tick``:
    start, end, deadline, the crossfade launches made in the tick), its
    rebuilds (after each client op's rebuild: the time, the compile
    generation and whether a compile is pending) and its adoptions (the
    time, the generation, and whether the adopted program runs the
    workspace as it stands)."""

    def __init__(self, eng):
        from mixlab_tpu_torch.engine.engine import Engine
        from mixlab_tpu_torch.video.blend import crossfade_cuda

        self.ticks, self.rebuilds, self.adoptions = [], [], []
        record, rebuild = eng._stat.record_tick, eng._rebuild

        def record_tick(deadline, fn):
            n, t = crossfade_cuda.launches, time.monotonic()
            out = record(deadline, fn)
            self.ticks.append((t, time.monotonic(), deadline, crossfade_cuda.launches - n))
            return out

        def rebuild_(full):
            rebuild(full)
            self.rebuilds.append((time.monotonic(), eng._compile_gen,
                                  eng._compiling is not None))

        def adopt(patch):
            self.adoptions.append((time.monotonic(), eng._compile_gen, patch.serves(eng.ws)))
            Engine._adopt_patch(eng, patch)

        eng._stat.record_tick, eng._rebuild, eng._adopt_patch = record_tick, rebuild_, adopt

    def window(self, t0, t1):
        """The ticks that started in [t0, t1): (start, end, deadline, crossfades)."""
        return [x for x in self.ticks if t0 <= x[0] < t1]


def _storm_ops(p, ids, first_id, seconds, struct_hz, fader_hz):
    """The storm's ops in time order: (seconds from its start, op, structural).
    Each structural cycle creates an oscillator, connects it to the Mixer's
    input 7 and deletes it; the fader edits move the VideoMixer's fader."""
    from mixlab_tpu_torch.flagship import MIXER

    geo = p.WindowGeometry()
    ops = []
    for k in range(int(seconds * struct_hz)):
        n, step = first_id + k // 3, k % 3
        if step == 0:
            op = p.CreateModule(p.ModuleParams("Oscillator", p.OscillatorParams(
                220.0 + 10 * (k // 3), p.Waveform.SINE)), geo)
        elif step == 1:
            op = p.CreateConnection(p.InputId(p.ModuleId(MIXER), 7), p.OutputId(p.ModuleId(n), 1))
        else:
            op = p.DeleteModule(p.ModuleId(n))
        ops.append((k / struct_hz, op, True))
    for k in range(int(seconds * fader_hz)):
        ops.append((k / fader_hz, p.UpdateModuleParams(ids["mixer"], p.ModuleParams(
            "VideoMixer", p.VideoMixerParams(a=0, b=1, fader=0.3 + 0.4 * (k % 2)))), False))
    return sorted(ops, key=lambda x: x[0])


def _send(eng, sid, seq, op):
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.engine import Busy

    deadline = time.monotonic() + 5.0
    while True:
        try:
            return eng.update(sid, p.WorkspaceMessage(seq, op))
        except Busy:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.002)


def _window_stats(ticks, seconds):
    """Ticks, ticks over the budget, late ticks, wall p50/p99 (ms), the
    fewest ticks in any second of the window, and ticks without exactly
    one crossfade launch."""
    walls = [end - start for start, end, _, _ in ticks]
    t0 = ticks[0][0] if ticks else 0.0
    per_s = [sum(1 for x in ticks if t0 + s <= x[0] < t0 + s + 1) for s in range(int(seconds))]
    return {"ticks": len(ticks), "over": sum(w > TICK_BUDGET_S for w in walls),
            "late": sum(end > deadline for _, end, deadline, _ in ticks),
            "p50": _ms(walls, 50), "p99": _ms(walls, 99), "min_a_s": min(per_s, default=0),
            "missed": sum(n != 1 for *_, n in ticks)}


def threaded_storm(torch, np, dev, pool, variant=None):
    """The threaded realtime engine (flagship, 1080p and 720p cameras fed at
    60 fps by a feeder thread, the VideoMixer, the monitor pipe read by a
    thread) for a quiet window, then a storm window of structural ops and
    fader edits.  ``variant(engine)``, for the attribution, changes the
    engine before it starts.  -> the windows' stats, each structural op's
    seconds to its adoption, stale adoptions, whether the final program is
    the final workspace's, the launches of both windows."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.compiler import compile_patch

    eng, ids, sid = realtime_engine(str(dev), ("e-cam1", "e-cam2"))
    cams = Cameras(("e-cam1", "e-cam2"))
    pipe = eng.monitor_pipe(ids["monitor"])
    probe = EditProbe(eng)
    if variant is not None:
        variant(eng)
    stop = threading.Event()
    counters = launch_counters()

    def feeder():
        start, k = time.monotonic(), 0
        while not stop.is_set():
            cams.publish(k, pool[k % len(pool)], hold=EDIT_HOLD_TICKS)
            k += 1
            stop.wait(max(0.0, start + k / 60 - time.monotonic()))

    def reader():
        while not stop.is_set():
            try:
                pipe.q.get(timeout=0.2)
            except queue.Empty:
                pass

    threads = [threading.Thread(target=f, name=f.__name__) for f in (feeder, reader)]
    ops = _storm_ops(p, ids, eng.ws.module_seq + 1, EDIT_WINDOW_S, EDIT_STRUCT_HZ, EDIT_FADER_HZ)
    sent = []
    try:
        for th in threads:
            th.start()
        eng.start()
        time.sleep(1.0)  # the first ticks
        _reset(counters)
        q0 = time.monotonic()
        time.sleep(EDIT_WINDOW_S)
        s0 = time.monotonic()
        for seq, (at, op, structural) in enumerate(ops, 1):
            time.sleep(max(0.0, s0 + at - time.monotonic()))
            sent.append((time.monotonic(), structural))
            _send(eng, sid, 10_000 + seq, op)
        time.sleep(max(0.0, s0 + EDIT_WINDOW_S - time.monotonic()))
        s1 = time.monotonic()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (eng._pending_patch is not None
                                               or len(probe.rebuilds) < len(sent)
                                               or not eng._patch.serves(eng.ws)):
            time.sleep(0.05)
        launches = _read(counters)
        final_ok = (eng._patch.structural_fingerprint
                    == compile_patch(eng.ws, eng.cfg, eng.block, dev).structural_fingerprint)
    finally:
        stop.set()
        eng.stop()
        for th in threads:
            th.join(timeout=5)
        cams.close()
    if len(probe.rebuilds) != len(sent):
        raise AssertionError(f"{len(sent)} ops sent, {len(probe.rebuilds)} rebuilds")
    to_adopt = []
    for (t_sent, structural), (t_done, gen, pending) in zip(sent, probe.rebuilds):
        if structural:
            # with a compile pending, the first adoption of this op's
            # generation or a later one; else (the op netted out to the
            # running program, or was adopted at once) the op's own end
            t_adopt = t_done if not pending else min(
                (t for t, g, _ in probe.adoptions if g >= gen and t >= t_sent), default=None)
            to_adopt.append(float("inf") if t_adopt is None else t_adopt - t_sent)
    return {"quiet": _window_stats(probe.window(q0, s0), EDIT_WINDOW_S),
            "storm": _window_stats(probe.window(s0, s1), EDIT_WINDOW_S),
            "to_adopt": to_adopt, "adoptions": len(probe.adoptions),
            "stale": sum(not serves for _, _, serves in probe.adoptions),
            "final_ok": final_ok, "launches": launches,
            "structural": sum(s for _, s in sent), "faders": sum(not s for _, s in sent)}


def _log_storm(np, card, label, r):
    for window in ("quiet", "storm"):
        w = r[window]
        log(f"edit path (a) {label}, {window} window {EDIT_WINDOW_S:.0f} s [{card}]: "
            f"{w['ticks']} ticks (fewest in a second {w['min_a_s']}), {w['over']} over "
            f"16.667 ms, {w['late']} late on the schedule, tick wall p50 {w['p50']:.3f} ms, "
            f"p99 {w['p99']:.3f} ms, {w['missed']} ticks without one crossfade launch")
    log(f"edit path (a) {label}, storm [{card}]: {r['structural']} structural ops "
        f"({EDIT_STRUCT_HZ}/s) and {r['faders']} fader edits ({EDIT_FADER_HZ}/s); "
        f"{r['adoptions']} adoptions, {r['stale']} of a stale program; op to adoption p50 "
        f"{np.median(r['to_adopt']) * 1e3:.3f} ms, max {max(r['to_adopt']) * 1e3:.3f} ms; "
        f"final program = the final workspace's: {r['final_ok']}; launches {r['launches']}")


def edit_storm(torch, np, dev, card):
    """(a) ``threaded_storm`` as the engine runs; then, for information, the
    same storm in direct drive (each op compiled and adopted at once on
    the thread that ticks), its ops and tick in one 1/60 s slot."""
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    r = threaded_storm(torch, np, dev, pool)
    _log_storm(np, card, "threaded", r)
    quiet, storm = r["quiet"], r["storm"]
    if (quiet["min_a_s"] < EDIT_MIN_TICKS_A_S or storm["min_a_s"] < EDIT_MIN_TICKS_A_S
            or r["stale"] or not r["final_ok"] or quiet["missed"] or storm["missed"]
            or not np.isfinite(max(r["to_adopt"]))):
        raise AssertionError(f"edit path (a): quiet {quiet}, storm {storm}, stale adoptions "
                             f"{r['stale']}, final program matches {r['final_ok']}, op to "
                             f"adoption max {max(r['to_adopt'])}")
    direct_storm(torch, np, dev, card, pool)
    return r["launches"]


def _no_warm(eng):
    """The attribution's variant: the compile worker stages each program
    without running it."""
    def stage(patch, gen, warm_args):
        with eng._pending_lock:
            if gen == eng._compile_gen:
                patch.first_inputs = warm_args[:2]
                eng._pending_patch = (patch, gen)
        return True

    eng._warm_and_stage = stage


def _beside_ticks(eng):
    """The attribution's variant: the compile worker's warm runs beside the
    ticks (the engine's tick lock a no-op)."""
    class _NoLock:
        def acquire(self, timeout=-1):
            return True

        def release(self):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    eng._tick_lock = _NoLock()


def _synchronous(eng):
    """The attribution's variant: every edit compiled and adopted on the
    engine thread at once, with no compile worker: the compile worker's queue adopts
    each job as it is put, with its first inputs."""
    class AdoptAtOnce(queue.Queue):
        def put(self, job, block=True, timeout=None):
            patch, _, warm_args = job
            eng._compiling = None
            patch.first_inputs = warm_args[:2]
            eng._adopt_patch(patch)

    eng._compile_q = AdoptAtOnce()


def edit_attribution() -> int:
    """Not in ``main``: phase 21 (a)'s threaded storm in turns as the engine
    runs, with the compile worker's warm beside the ticks (no tick lock),
    with the warm a no-op, and with every edit adopted at once on the engine
    thread, twice each.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.edit_attribution())'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch import kernels

    card, dev = card_line(), torch.device("cuda", torch.cuda.current_device())
    log(card)
    kernels.load()
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    variants = (("as it runs", None), ("warm beside the ticks", _beside_ticks),
                ("warm a no-op", _no_warm),
                ("adopted at once", _synchronous))
    for _ in range(2):
        for label, variant in variants:
            _log_storm(np, card, label, threaded_storm(torch, np, dev, pool, variant))
    return 0


def direct_storm(torch, np, dev, card, pool):
    """For information: the storm in direct drive, every edit compiled and
    adopted at once on the thread that ticks: each 1/60 s slot
    applies the ops due, publishes the cameras and runs ``tick_once``."""
    from mixlab_tpu_torch import protocol as p

    eng, ids, sid = realtime_engine(str(dev), ("d-cam1", "d-cam2"))
    cams = Cameras(("d-cam1", "d-cam2"))
    pipe = eng.monitor_pipe(ids["monitor"])
    ops = _storm_ops(p, ids, eng.ws.module_seq + 1, EDIT_WINDOW_S, EDIT_STRUCT_HZ, EDIT_FADER_HZ)
    slots, op_ms = [], []
    try:
        start, k, i = time.monotonic(), 0, 0
        while k < EDIT_WINDOW_S * 60:
            t = time.monotonic()
            while i < len(ops) and ops[i][0] <= k / 60:
                t_op = time.monotonic()
                eng.update(sid, p.WorkspaceMessage(20_000 + i, ops[i][1]))
                if ops[i][2]:
                    op_ms.append(time.monotonic() - t_op)
                i += 1
            cams.publish(eng.tick, pool[k % len(pool)], hold=EDIT_HOLD_TICKS)
            eng.tick_once()
            slots.append(time.monotonic() - t)
            pipe.q.get_nowait()
            k += 1
            time.sleep(max(0.0, start + k / 60 - time.monotonic()))
    finally:
        eng.stop()
        cams.close()
    log(f"edit path (a) direct drive, the storm [{card}]: {len(slots)} slots, "
        f"{sum(s > TICK_BUDGET_S for s in slots)} over 16.667 ms (the slot's ops and tick), "
        f"p50 {_ms(slots, 50):.3f} ms, p99 {_ms(slots, 99):.3f} ms; a structural op "
        f"(compiled and adopted at once) p50 {_ms(op_ms, 50):.3f} ms, max "
        f"{max(op_ms) * 1e3:.3f} ms")


def edit_mesh(torch, np, dev, card):
    """(b) the 48 kHz stems engine (the flagship, one stem an entry) over a
    2-entry mesh on the card in 16-tick blocks, threaded, takes one
    structural edit; the compile worker's warm is held EDIT_MESH_HOLD_S
    first, as a long compile: the running program's blocks go on with one
    region launch a shard each, the warm makes one a shard on the compile
    thread, and the blocks after the adoption one a shard again."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.engine import Engine
    from mixlab_tpu_torch.flagship import build_16_module_graph
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.stems import StemsPatch
    from mixlab_tpu_torch.server import monitor

    by_thread = {}
    real_launch = region_cuda._launch

    def launch(*a, **k):
        name = threading.current_thread().name
        by_thread[name] = by_thread.get(name, 0) + 1
        return real_launch(*a, **k)

    counters = launch_counters()
    real_monitor, monitor.MonitorPipeline = monitor.MonitorPipeline, NoCodec
    region_cuda._launch = launch
    eng = None
    try:
        eng = Engine(workspace=build_16_module_graph()[0], cfg=EngineConfig(sample_rate=48_000),
                     block_ticks=EDIT_MESH_TICKS, device=str(dev),
                     patch_compiler=StemsPatch.compiler(make_mesh(2, devices=[str(dev)])))
        sid = eng.connect_session()[0]
        blocks, warm = [], {}

        record = eng._stat.record_tick

        def record_tick(deadline, fn):
            n = by_thread.get("engine", 0)
            out = record(deadline, fn)
            blocks.append((time.monotonic(), by_thread.get("engine", 0) - n, eng._patch))
            return out

        def warm_and_stage(patch, gen, warm_args):
            warm["start"] = time.monotonic()
            time.sleep(EDIT_MESH_HOLD_S)
            n = by_thread.get("compile", 0)
            ok = Engine._warm_and_stage(eng, patch, gen, warm_args)
            warm.update(end=time.monotonic(), launches=by_thread.get("compile", 0) - n)
            return ok

        eng._stat.record_tick, eng._warm_and_stage = record_tick, warm_and_stage
        _reset(counters)
        eng.start()
        while len(blocks) < 3:
            time.sleep(0.05)
        first = eng._patch
        eng.update(sid, p.WorkspaceMessage(1, p.CreateModule(p.ModuleParams(
            "Oscillator", p.OscillatorParams(330.0, p.Waveform.SAW)), p.WindowGeometry())))
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and (eng._patch is first or sum(
                b[2] is not first for b in blocks) < 3):
            time.sleep(0.05)
    finally:
        if eng is not None:
            eng.stop()
        region_cuda._launch = real_launch
        monitor.MonitorPipeline = real_monitor
    launches = _read(counters)
    during = [b for b in blocks if warm.get("start", 0) <= b[0] <= warm.get("end", 0)]
    after = [b for b in blocks if b[2] is not first]
    log(f"edit path (b) stems engine over 2 entries of {dev}, {EDIT_MESH_TICKS}-tick blocks, "
        f"threaded [{card}]: {len(blocks)} blocks, region launches a block on the engine "
        f"thread {[n for _, n, _ in blocks]}; {len(during)} blocks while the warm (held "
        f"{EDIT_MESH_HOLD_S} s) ran, its launches on the compile thread "
        f"{warm.get('launches')}; {len(after)} blocks after the adoption; launches "
        f"{launches}")
    if not (after and len(during) >= 1 and all(n == 2 for _, n, _ in blocks)
            and warm.get("launches") == 2 and launches["eq_cascade"] == 0):
        raise AssertionError(f"edit path (b): blocks {[(n, b is first) for _, n, b in blocks]}, "
                             f"warm {warm}, launches {launches}")
    return launches


def edit_depth(torch, np, dev, card):
    """(c) ``pipeline_depth`` 0, 1 and 2 on the realtime engine in direct
    drive for EDIT_DEPTH_TICKS ticks on the same ingest: the routed Monitor
    items (audio and composite) identical to depth 0's, each d ticks later,
    ``flush_inflight`` routing the last d; each depth's tick wall for
    information."""
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    counters = launch_counters()
    base, walls, paths = None, {}, {}
    for d in EDIT_DEPTHS:
        names = (f"p{d}-cam1", f"p{d}-cam2")
        eng, ids, _ = realtime_engine(str(dev), names, pipeline_depth=d)
        cams = Cameras(names)
        pipe = eng.monitor_pipe(ids["monitor"])
        items, w = [], []
        try:
            _reset(counters)
            for tick in range(EDIT_DEPTH_TICKS):
                cams.publish(tick, pool[tick % len(pool)])
                t = time.perf_counter()
                eng.tick_once()
                w.append(time.perf_counter() - t)
                got = []
                while not pipe.q.empty():
                    got.append(pipe.q.get_nowait())
                if len(got) != (tick >= d):
                    raise AssertionError(f"depth {d}: {len(got)} items after tick {tick}")
                items += got
            eng.flush_inflight()
            while not pipe.q.empty():
                items.append(pipe.q.get_nowait())
            torch.cuda.synchronize()
            paths[f"edit_depth_{d}"] = _read(counters)
        finally:
            eng.stop()
            cams.close()
        if [t0 for t0, _, _ in items] != [k * RT_SPT for k in range(EDIT_DEPTH_TICKS)]:
            raise AssertionError(f"depth {d}: routed t0s {[t0 for t0, _, _ in items][:5]}...")
        if base is None:
            base = items
        else:
            for (t0, a, v), (_, a0, v0) in zip(items, base):
                if not (np.array_equal(a, a0) and all(
                        torch.equal(v.picture.planes[k], v0.picture.planes[k]) for k in "yuv")):
                    raise AssertionError(f"depth {d}: the item at t0 {t0} differs from depth 0's")
        walls[d] = w
    log(f"edit path (c) pipeline_depth {'/'.join(map(str, EDIT_DEPTHS))}, {EDIT_DEPTH_TICKS} "
        f"ticks in direct drive [{card}]: routed monitor audio and composites identical to "
        f"depth 0's, each d ticks later; tick_once p50 " + ", ".join(
            f"{_ms(w, 50):.3f}" for w in walls.values()) + " ms; launches " + ", ".join(
            f"{paths[f'edit_depth_{d}']['crossfade']}" for d in EDIT_DEPTHS) + " crossfades")
    return paths


def edit_codecs(torch, np, dev, card):
    """(d) whether the libavcodec shim builds and loads here, and the codec
    tier the port takes; where the shim is, the phase 17 clip (1080p30
    CAVLC intra and AAC-LC, 10 s) played through ``MediaPlayer._run_shim``
    onto ``dev``, unthrottled: its first pictures equal the port's H.264
    decoder's on the same access units, and its PCM the AAC decoder's within
    MEDIA_PCM_ATOL."""
    import io

    from mixlab_tpu_torch.av.codecs import codec_tier
    from mixlab_tpu_torch.av.h264dec import PureH264Decoder
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.feeds import MediaSourceFeed
    from mixlab_tpu_torch.engine.media_player import MediaPlayer
    from mixlab_tpu_torch.io_host import throttle
    from mixlab_tpu_torch.native import avshim

    available, tier = avshim.available(), codec_tier()
    reason = avshim.unavailable_reason()
    log(f"edit path (d) codecs [{card}]: libavcodec shim available {available}"
        + ("" if available else f" ({' '.join((reason or '').split())[:240]})") + f"; codec tier {tier}")
    if not available:
        if tier == "shim":
            raise AssertionError("the codec tier is the shim, which is unavailable")
        return
    units, _, dcr, _ = media_pictures(torch, np, dev)
    blob, ref, *_ = media_mp4(np, units, dcr)
    cfg = EngineConfig(sample_rate=RT_RATE)
    feed = MediaSourceFeed(cfg)
    player = MediaPlayer(io.BytesIO(blob), feed, cfg, dev)
    taken, real_run = [], MediaPlayer._run_shim
    saved = (throttle.AudioThrottle.send_samples, throttle.MediaThrottle.wait_until)
    MediaPlayer._run_shim = lambda self: taken.append(1) or real_run(self)
    throttle.AudioThrottle.send_samples = lambda self, n: None
    throttle.MediaThrottle.wait_until = lambda self, t: None
    audio, video = [], []
    try:
        player.start()
        deadline = time.monotonic() + 60
        while (sum(map(len, audio)) < RT_RATE or len(video) < MEDIA_CHECK_TICKS) \
                and time.monotonic() < deadline:
            for q, out in ((feed.queue, audio), (feed.video_q, video)):
                try:
                    out.append(q.get(timeout=0.01))
                except queue.Empty:
                    pass
    finally:
        player.stop()
        player.join(timeout=10)
        MediaPlayer._run_shim = real_run
        throttle.AudioThrottle.send_samples, throttle.MediaThrottle.wait_until = saved
    dec = PureH264Decoder(dcr)
    want = [dec.decode(u)[-1] for u in units[:MEDIA_CHECK_TICKS]]
    same = sum(all(np.array_equal(frame.picture.planes[k].cpu().numpy(), w[1 + i])
                   for i, k in enumerate("yuv")) and frame.picture.planes["y"].device == dev
               for (_, frame), w in zip(video, want))
    pcm = np.concatenate(audio)[:RT_RATE] if audio else np.zeros((0, 2), np.float32)
    err = float(np.abs(pcm - ref[:len(pcm)]).max()) if len(pcm) else float("inf")
    log(f"edit path (d) the phase 17 clip through _run_shim on {dev} [{card}]: "
        f"{len(video)} pictures, {same} of the first {len(want)} equal to the port's decoder's; "
        f"{len(pcm)} samples within {err:.3e} of the AAC decoder's (atol {MEDIA_PCM_ATOL})")
    if taken != [1] or same != len(want) or len(pcm) < RT_RATE or err > MEDIA_PCM_ATOL:
        raise AssertionError(f"edit path (d): _run_shim taken {taken}, {same} pictures equal, "
                             f"{len(pcm)} samples, err {err}")


def edit_phase() -> int:
    """Not in ``main`` alone: phase 21 by itself, after the build, with TF32
    off as ``main`` sets it.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.edit_phase())'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda", torch.cuda.current_device())
    log(card)
    kernels.load()
    edit_path(torch, np, dev, card)
    return 0


def edit_path(torch, np, dev, card):
    """Phase 21: -> {path: launches}."""
    t = time.perf_counter()
    paths = {"edit_storm": edit_storm(torch, np, dev, card),
             "edit_mesh": edit_mesh(torch, np, dev, card)}
    paths.update(edit_depth(torch, np, dev, card))
    edit_codecs(torch, np, dev, card)
    log(f"phase 21 (the edit path) took {time.perf_counter() - t:.1f} s")
    return paths


def ptxas_summary(text, names=("eq_cascade_kernel", "eq_rows_kernel", "region_kernel",
                               "region_rows_kernel", "region_lookback_kernel", "envelope_kernel",
                               "envelope_rows_kernel", "envelope_lookback_kernel")):
    """{kernel: (registers, stack bytes, spill store bytes, spill load
    bytes)} from the build log's ``-Xptxas -v`` lines."""
    import re

    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((n for n in names if n in m.group(1)), None)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            out.setdefault(current, [None, *map(int, m.groups())])
        m = re.search(r"Used (\d+) registers", line)
        if m and current and current in out and out[current][0] is None:
            out[current][0] = int(m.group(1))
            current = None
    return {k: tuple(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# phase 17: media playback on the card (the MediaPlayer and its decoders)
# ---------------------------------------------------------------------------

MEDIA_SIZE = (1920, 1080)
MEDIA_FPS = 30
MEDIA_SECONDS = 10
MEDIA_DISTINCT = 10       # distinct pictures, cycled: the stream is all-intra
MEDIA_QP = 30
MEDIA_PCM_ATOL = 1e-4
MEDIA_WINDOW_S = 5.0
MEDIA_CHECK_TICKS = 12
DECODE_TIMED = 10         # 1080p frames timed on the native tier
DECODE_PY_FRAMES = 2      # and on the Python tier (seconds each)
IMDCT_ATOL = 2e-3         # tests/test_vorbis.py:68


class _PythonDecodeTier:
    """The port's native library patched away while the block runs: each
    H.264 decoder takes its Python tier, as on a host without g++."""

    def __enter__(self):
        from mixlab_tpu_torch import native

        self.native, self.old = native, native._load
        native._load = lambda: None

    def __exit__(self, *exc):
        self.native._load = self.old


def _decode_all(data: bytes):
    from mixlab_tpu_torch.av.h264dec import PureH264Decoder

    dec = PureH264Decoder()
    return dec.decode_annexb(data) + dec.flush()


def _same_frames(np, a, b) -> bool:
    return len(a) == len(b) > 0 and all(
        fa[0] == fb[0] and all(x.shape == y.shape and np.array_equal(x, y)
                               for x, y in zip(fa[1:], fb[1:])) for fa, fb in zip(a, b))


def media_pictures(torch, np, dev):
    """The MEDIA_DISTINCT 1080p pictures (bars and gradients made on the
    card, fetched) encoded by the port's CAVLC intra encoder: -> (the
    avcc access units, one Annex B stream of them with SPS and PPS, the
    encoder's wall per frame)."""
    from mixlab_tpu_torch.av.h264enc import PureH264Stream, nal
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings
    from mixlab_tpu_torch.video.pattern import pattern_picture

    w, h = MEDIA_SIZE
    stream = PureH264Stream(PictureSettings(w, h), fps=MEDIA_FPS, mode="cavlc", qp=MEDIA_QP)
    units, t = [], 0.0
    for i in range(MEDIA_DISTINCT):
        kind = "bars" if i % 2 == 0 else "gradient"
        pic = Picture(PictureSettings(w, h),
                      pattern_picture(kind, w, h, 7 * i, device=dev).to_numpy())
        t0 = time.perf_counter()
        stream.feed(pic)
        ((_key, avcc),) = stream.poll_access_units()
        t += time.perf_counter() - t0
        units.append(avcc)
    sc = b"\x00\x00\x00\x01"
    annexb = sc + nal(7, stream.sps) + sc + nal(8, stream.pps) + b"".join(
        sc + u[4:] for u in units)
    return units, annexb, stream.dcr, 1e3 * t / MEDIA_DISTINCT


def media_decode(torch, np, dev, card, annexb: bytes) -> list:
    """Phase 17 (a): the native decode tier against the Python tier,
    bit-exact, on the committed x264 streams (``tests/data/h264/``: CAVLC
    and CABAC, P and B, the 8x8 transform) and on the port's 1080p CAVLC
    intra stream; then, for information, ms per 1080p frame by tier.
    -> the 1080p stream's frames decoded on the native tier."""
    from mixlab_tpu_torch import native

    if not native.available():
        raise AssertionError("the port's native library (the decode tier) did not build")
    names = []
    for path in sorted((ROOT / "tests" / "data" / "h264").glob("*.264")):
        data = path.read_bytes()
        nat = _decode_all(data)
        with _PythonDecodeTier():
            py = _decode_all(data)
        if not _same_frames(np, nat, py):
            raise AssertionError(f"{path.name}: the native decode tier disagrees with the "
                                 "Python tier")
        names.append(f"{path.stem} ({len(nat)} frames)")
    if len(names) < 5:
        raise AssertionError(f"only {len(names)} committed x264 streams: {names}")
    t = time.perf_counter()
    frames = _decode_all(annexb)
    ms_native = 1e3 * (time.perf_counter() - t) / len(frames)
    t = time.perf_counter()
    for _ in range(max(DECODE_TIMED // len(frames), 1)):
        _decode_all(annexb)
    ms_native = min(ms_native, 1e3 * (time.perf_counter() - t)
                    / (max(DECODE_TIMED // len(frames), 1) * len(frames)))
    sc = b"\x00\x00\x00\x01"
    head = sc.join(annexb.split(sc)[:3 + DECODE_PY_FRAMES])  # "", SPS, PPS, the IDRs
    t = time.perf_counter()
    with _PythonDecodeTier():
        py = _decode_all(head)
    ms_py = 1e3 * (time.perf_counter() - t) / len(py)
    if len(frames) != MEDIA_DISTINCT or not _same_frames(np, py, frames[:len(py)]):
        raise AssertionError("the 1080p CAVLC intra stream: the native decode tier disagrees "
                             "with the Python tier")
    log(f"media decode [{card}]: native tier == Python tier, bit-exact, on {', '.join(names)} "
        f"and the port's 1080p CAVLC intra stream ({len(frames)} frames, {DECODE_PY_FRAMES} "
        f"on the Python tier); ms per {MEDIA_SIZE[0]}x{MEDIA_SIZE[1]} frame: native "
        f"{ms_native:.3f}, "
        f"Python {ms_py:.1f}")
    return frames


def media_mp4(np, units, dcr):
    """The 1920x1080, 30 fps, 10 s MP4 with 44.1 kHz stereo AAC-LC, made here
    by the port's own encoders and fMP4 mux: the access units cycled, and
    10 s of a seeded tone through the AAC codec process.  -> (bytes, the
    AAC decoder's PCM of the track, the wall in s)."""
    from fractions import Fraction

    from mixlab_tpu_torch.av import mp4
    from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
    from mixlab_tpu_torch.av.aacdec import AacLcDecoder
    from mixlab_tpu_torch.av.codecs import PureAacStream
    from mixlab_tpu_torch.av.encode_stream import f32_to_i16
    from mixlab_tpu_torch.utils.mtime import MediaDuration

    t0 = time.perf_counter()
    n = MEDIA_SECONDS * RT_RATE
    rng = np.random.default_rng(17)
    ts = np.arange(n) / RT_RATE
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 440 * ts), 0.3 * np.sin(2 * np.pi * 554 * ts)], 1)
    pcm = (pcm + rng.normal(0, 0.02, pcm.shape)).astype(np.float32)
    aac = PureAacStream(RT_RATE, 2)
    try:
        aac.feed(f32_to_i16(pcm.reshape(-1)))
        frames = aac.poll_frames()
    finally:
        aac.close()
    w, h = MEDIA_SIZE
    mux, blob = mp4.Mp4Mux.create(mp4.Mp4Params(
        timescale=RT_RATE, width=w, height=h, dcr=dcr, sample_rate=RT_RATE, channels=2))
    blob = bytearray(blob)
    events = [(Fraction(k * 1024, RT_RATE), 0, k) for k in range(len(frames))]
    events += [(Fraction(k, MEDIA_FPS), 1, k) for k in range(MEDIA_SECONDS * MEDIA_FPS)]
    for _, kind, k in sorted(events):
        if kind == 0:
            blob += mux.write_track(MediaDuration.new(1024, RT_RATE), mp4.AdtsFrame(frames[k]))
        else:
            blob += mux.write_track(MediaDuration.new(1, MEDIA_FPS), mp4.AvcFrame(
                True, MediaDuration.zero(), units[k % len(units)]))
    asc = AudioSpecificConfiguration.lc_stereo(RT_RATE)
    dec = AacLcDecoder(asc)
    t1 = time.perf_counter()
    ref = np.concatenate([dec.decode_raw(f[7:], asc.sampling_frequency_index)
                          for f in frames]).astype(np.float32)
    ms_granule = 1e3 * (time.perf_counter() - t1) / len(frames)
    return bytes(blob), ref, time.perf_counter() - t0, ms_granule, [f[7:] for f in frames]


def media_session(torch, np, dev, card, tmp: Path, units, dcr, pictures, mp4=None,
                  then=({"aac": "noop"}, {"aac": "process", "client": "process"})) -> dict:
    """Phase 17 (b): the MP4 uploaded into a ``ProjectHandle`` on the card,
    ``run_server`` on an ephemeral port, and the script's WebSocket client
    builds ``flagship.realtime_video_ops`` with one 1080p camera (fed at 60
    fps) on the VideoMixer's channel A at fader 0, then a MediaSource of the
    upload on channel B.  The Monitor's codec thread is live (pure tier:
    the AAC codec process).  Then, with a client subscribed to the Monitor:

      * a window of MEDIA_WINDOW_S with the launch counts set to 0 and read
        on the engine thread: one crossfade launch per video tick;
      * MEDIA_CHECK_TICKS composites at fader 0 of ticks whose mixer holds
        a media picture, each copied to the host on the engine thread: every
        one is a decoded picture, exactly;
      * the fader set to 0.6 by a client op: MEDIA_CHECK_TICKS composites
        against the CPU twin on the mixer's stored pictures of the same
        tick, within 1 LSB;
      * the played PCM (what the engine's feed reads, underrun gaps left
        out) against the AAC decoder's PCM of the track, within 1e-4;
      * for information, the window's served tick_once p50/p99, share over
        16.667 ms, the Monitor pipe's dropped ticks, the feed's late frames
        and underrun ticks; then a window for each variant of ``then``, a
        dict: ``aac`` the AAC encoder a no-op (``"noop"``), on the codec
        thread (``"inprocess"``) or in its codec process (``"process"``);
        ``cached`` the decodes (``"audio"``, ``"video"``) the decode thread
        looks up instead of running; ``client`` ``"process"`` for the
        monitor client in a process of its own (``monitor_client``).

    -> the first window's launches and figures."""
    import asyncio

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine import engine as engine_mod
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.project import open_or_create
    from mixlab_tpu_torch.flagship import realtime_video_ops
    from mixlab_tpu_torch.server.app import run_server
    from mixlab_tpu_torch.video.blend import crossfade_torch

    from mixlab_tpu_torch.engine.media_player import _upload_planes

    blob, ref_pcm, mp4_wall, ms_granule, raws = mp4 or media_mp4(np, units, dcr)
    t = time.perf_counter()
    for _ in range(3):
        for pic in pictures:
            _upload_planes(*pic[1:], dev)
    ms_upload = 1e3 * (time.perf_counter() - t) / (3 * len(pictures))
    log(f"media mp4 [{card}]: {MEDIA_SIZE[0]}x{MEDIA_SIZE[1]} {MEDIA_FPS} fps {MEDIA_SECONDS} s, "
        f"{MEDIA_SECONDS * MEDIA_FPS} H.264 samples ({MEDIA_DISTINCT} distinct, cycled) and "
        f"{len(ref_pcm) // 1024} AAC-LC frames, {len(blob)} bytes, made in {mp4_wall:.3f} s; "
        f"the decode thread's other work, each alone: AAC-LC decode {ms_granule:.3f} ms per "
        f"1,024-sample granule ({ms_granule * RT_RATE / 1024:.1f} ms per second of audio, "
        f"Python), upload of a decoded picture to {dev} {ms_upload:.3f} ms")
    cam = ("media-cam1",)
    pool = [cam_frames(torch, np, dev, i, sizes=CAM_SIZES[:1]) for i in range(4)]
    counters = launch_counters()
    ref_y = {pic[1].tobytes(): i for i, pic in enumerate(pictures)}
    state = {"window": None, "check": None, "walls": [], "played": [], "underrun": 0,
             "late": 0, "released": 0, "dropped0": 0, "offset0": None}

    class CountingQueue(queue.Queue):
        """The feed's audio queue, counting the samples taken from it."""
        taken = 0

        def get_nowait(self):
            chunk = super().get_nowait()
            self.taken += len(chunk)
            return chunk

    pts_of = {}

    class PtsQueue(queue.Queue):
        """The feed's video queue, noting each frame's pts as it is taken."""

        def get_nowait(self):
            item = super().get_nowait()
            pts_of[id(item[1])] = item[0]
            return item

    class CountedFeed(engine_mod.MediaSourceFeed):
        """The MediaSource's feed with the engine thread's reads recorded:
        the samples each tick played (underrun gaps left out) and each
        released frame's delay on the wall clock behind its pts, beyond the
        first frame's (more than a frame's duration is late)."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.queue = CountingQueue(maxsize=self.queue.maxsize)
            self.video_q = PtsQueue(maxsize=self.video_q.maxsize)

        def fill_tick(self, n):
            carry0, taken0 = (0 if self.carry is None else len(self.carry)), self.queue.taken
            out = super().fill_tick(n)
            filled = (carry0 + self.queue.taken - taken0
                      - (0 if self.carry is None else len(self.carry)))
            state["played"].append(out[:filled].copy())
            win = state["window"]
            if win is not None and win["open"] and win["launches"] is None and filled < n:
                state["underrun"] += 1
            return out

        def take_video(self, n):
            frame = super().take_video(n)
            if frame is not None:
                # the release's delay on the wall clock behind its pts,
                # beyond the first frame's (the engine's clock drifts when
                # it falls behind, so its position is not the reference)
                delay = time.monotonic() - float(pts_of.pop(id(frame)).frac)
                if state["offset0"] is None:
                    state["offset0"] = delay
                win = state["window"]
                if win is not None and win["open"] and win["launches"] is None:
                    state["released"] += 1
                    state["late"] += delay - state["offset0"] > 1 / MEDIA_FPS
            return frame
    with _PureTier(), ThreadFaults() as faults:
        proj = open_or_create(tmp / "media.mixlab", EngineConfig(sample_rate=RT_RATE),
                              block_ticks=1, device=str(dev))
        eng = proj.engine
        media_id = proj.upload_media("clip.mp4", "video/mp4", [blob])
        tick_once = eng.tick_once

        def timed_tick(*args):
            t = time.perf_counter()
            out = tick_once(*args)
            state["walls"].append(time.perf_counter() - t)
            return out

        eng.tick_once = timed_tick
        cams, stop, tcp = None, threading.Event(), None

        def feeder():
            start, k = time.monotonic(), 0
            while not stop.is_set():
                cams.publish(k, pool[k % len(pool)])
                k += 1
                stop.wait(max(0.0, start + k / 60 - time.monotonic()))

        feed_thread = threading.Thread(target=feeder, name="media-feeder")
        loop = asyncio.new_event_loop()
        server_thread = threading.Thread(target=loop.run_forever, name="server-loop")
        server_thread.start()
        replaced = None
        try:
            tcp, _ = asyncio.run_coroutine_threadsafe(
                run_server(proj, "127.0.0.1", 0), loop).result(60)
            port = tcp.sockets[0].getsockname()[1]
            ops, ids = realtime_video_ops(p, cam, fader=0.0)
            geo = p.WindowGeometry()
            media_mid = p.ModuleId(int(ids["mixer"].value) + 1)
            ops += [p.CreateModule(p.ModuleParams("MediaSource", p.MediaSourceParams(media_id)),
                                   geo),
                    p.CreateConnection(p.InputId(ids["mixer"], 1), p.OutputId(media_mid, 0))]
            session = {}

            async def client_ops(op_list, first_seq):
                reader, writer = await ws_open(port, "/session")
                await ws_read(reader)  # WorkspaceState
                await ws_read(reader)  # MediaLibrary
                for seq, op in enumerate(op_list, first_seq):
                    for up in await ws_op(reader, writer, seq, op):
                        if up["t"] == "SUCreateModule" and up["params"]["kind"] == "Monitor":
                            session["socket_id"] = up["indication"]["value"]["socket_id"]
                writer.close()

            engine_mod.MediaSourceFeed = CountedFeed  # the feed the op creates
            try:
                asyncio.run_coroutine_threadsafe(client_ops(ops, 1), loop).result(120)
            finally:
                engine_mod.MediaSourceFeed = CountedFeed.__mro__[1]
            cams = Cameras(cam, sizes=CAM_SIZES[:1])  # the StreamInput listens now
            feed_thread.start()
            if media_mid not in eng._media_players or not eng._media_players[media_mid].is_alive():
                raise AssertionError("the MediaSource's decode thread did not start")
            if eng._media_players[media_mid].device != dev:
                raise AssertionError("the MediaPlayer uploads to "
                                     f"{eng._media_players[media_mid].device}, not {dev}")
            pipeline = eng._monitor_pipelines[ids["monitor"]]
            mixer = eng._video_mixers[ids["mixer"]]
            if not isinstance(eng._media_feeds[media_mid], CountedFeed):
                raise AssertionError("the MediaSource's feed is not the counted one")
            pipe = eng.monitor_pipe(ids["monitor"])
            push = pipe.push

            def counted_push(item):
                win, chk = state["window"], state["check"]
                if win is not None:
                    if win["armed"] and not win["open"]:
                        for fn in counters.values():
                            fn.launches = 0
                        win["open"] = True
                        state["walls"].clear()
                        state["released"] = state["late"] = state["underrun"] = 0
                        state["dropped0"] = pipe.dropped
                    elif win["open"] and win["launches"] is None:
                        win["video"] += item[2] is not None
                        win["items"] += 1
                        if not win["armed"]:
                            win["launches"] = {k: fn.launches for k, fn in counters.items()}
                elif chk is not None and len(chk["got"]) < MEDIA_CHECK_TICKS \
                        and item[2] is not None and mixer.channels[1].stored is not None:
                    # a tick whose composite holds a media picture
                    stored = [mixer.channels[i].stored for i in (0, 1)]
                    chk["got"].append((item[2].picture.to_numpy(),
                                       [None if s is None else s.to_numpy() for s in stored]))
                return push(item)

            pipe.push = counted_push
            if not pipeline.broadcast.ready.wait(60):
                raise AssertionError("the monitor's codecs were not ready in 60 s")
            deadline = time.monotonic() + 30
            while not any(len(x) for x in state["played"]) and time.monotonic() < deadline:
                time.sleep(0.01)

            def run_window(label, client="thread"):
                win = {"armed": False, "open": False, "video": 0, "items": 0, "launches": None}
                state["window"] = win

                def arm():
                    win["armed"] = True

                if client == "thread":
                    segments, elapsed = asyncio.run_coroutine_threadsafe(monitor_segments(
                        port, session["socket_id"], MEDIA_WINDOW_S, arm), loop).result(
                            MEDIA_WINDOW_S + 60)
                else:
                    proc = subprocess.Popen(
                        [sys.executable, "-c", "import chip_smoke as cs; cs.monitor_client("
                         f"{port}, {session['socket_id']!r}, {MEDIA_WINDOW_S})"],
                        cwd=ROOT, stdout=subprocess.PIPE, text=True)
                    try:
                        if proc.stdout.readline().strip() != "subscribed":
                            raise AssertionError("the monitor client process did not subscribe")
                        arm()
                        out = proc.communicate(timeout=MEDIA_WINDOW_S + 60)[0]
                    finally:
                        if proc.poll() is None:
                            proc.kill()
                            proc.wait()
                    got = json.loads(out.strip().splitlines()[-1])
                    segments, elapsed = got["segments"], got["elapsed"]
                win["armed"] = False
                deadline = time.monotonic() + 10
                while win["launches"] is None and time.monotonic() < deadline:
                    time.sleep(0.01)
                state["window"] = None
                if win["launches"] is None:
                    raise AssertionError(f"media window {label} did not close on the engine "
                                         "thread")
                w = np.sort(np.asarray(state["walls"][:win["items"]]) * 1e3)
                res = {"launches": win["launches"], "video": win["video"],
                       "ticks": win["items"], "segments_per_s": segments / elapsed,
                       "p50": float(np.percentile(w, 50)), "p99": float(np.percentile(w, 99)),
                       "over": float((w > TICK_BUDGET_MS).mean()),
                       "dropped": pipe.dropped - state["dropped0"], "late": state["late"],
                       "released": state["released"], "underrun": state["underrun"]}
                log(f"media playback window, {label} [{card}]: {res['ticks']} ticks, "
                    f"{res['video']} with video, {segments} monitor segments in "
                    f"{elapsed:.3f} s; served tick_once p50 {res['p50']:.3f} ms, p99 "
                    f"{res['p99']:.3f} ms, over {TICK_BUDGET_MS:.3f} ms "
                    f"{100 * res['over']:.2f}%; pipe dropped {res['dropped']}; media frames "
                    f"released {res['released']}, late {res['late']}; audio underrun ticks "
                    f"{res['underrun']}; launches {res['launches']}")
                return res

            first = run_window("AAC codec process on")

            def take_checks():
                state["check"] = {"got": []}
                deadline = time.monotonic() + 20
                while len(state["check"]["got"]) < MEDIA_CHECK_TICKS and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)
                got, state["check"] = state["check"]["got"], None
                if len(got) < MEDIA_CHECK_TICKS:
                    raise AssertionError(f"only {len(got)} composites copied for the check")
                return got

            shown = set()
            for comp, _stored in take_checks():
                i = ref_y.get(comp["y"].tobytes())
                if i is None or not all(np.array_equal(comp[k], pictures[i][j])
                                        for j, k in ((2, "u"), (3, "v"))):
                    raise AssertionError("a composite at fader 0 is not a decoded picture")
                shown.add(i)
            fade = int(RT_FADER * 255.0)
            asyncio.run_coroutine_threadsafe(client_ops([p.UpdateModuleParams(
                ids["mixer"], p.ModuleParams("VideoMixer", p.VideoMixerParams(
                    a=0, b=1, fader=RT_FADER)))], len(ops) + 1), loop).result(60)
            lsb = 0
            for comp, stored in take_checks():
                if any(s is None for s in stored):
                    raise AssertionError("a mixer channel held no picture in the check")
                for k in ("y", "u", "v"):
                    want = crossfade_torch(torch.from_numpy(stored[0][k]),
                                           torch.from_numpy(stored[1][k]), fade).numpy()
                    lsb = max(lsb, int(np.abs(comp[k].astype(np.int32) - want).max()))
            if lsb > COMPOSITE_LSB:
                raise AssertionError(f"composites at fader {RT_FADER} are {lsb} LSB from the "
                                     "CPU twin")
            replaced = pipeline._aac
            labels = {"process": "AAC codec process on", "noop": "AAC path a no-op",
                      "inprocess": "AAC encoder on the codec thread"}
            later = []
            from mixlab_tpu_torch.av import aacdec_worker, h264dec

            pcm_of = {raw: ref_pcm[k * 1024:(k + 1) * 1024] for k, raw in enumerate(raws)}
            pic_of = {unit: pic[1:] for unit, pic in zip(units, pictures)}
            real = aacdec_worker.AacDecodeProcess.decode_raw, h264dec.PureH264Decoder.decode
            for variant in then:
                aac, cached = variant["aac"], set(variant.get("cached", ()))
                client = variant.get("client", "thread")
                pipeline._aac = {"process": replaced, "noop": _NoAac(),
                                 "inprocess": _InProcessAac(RT_RATE, 2)}[aac]
                if "audio" in cached:  # the decode thread looks its PCM up
                    aacdec_worker.AacDecodeProcess.decode_raw = \
                        lambda self, raw, sfi: pcm_of[raw]
                if "video" in cached:  # and its pictures
                    h264dec.PureH264Decoder.decode = \
                        lambda self, packet, pts=0: [(pts, *pic_of[packet])]
                try:
                    later.append(run_window(labels[aac] + "".join(
                        f", {c} decode looked up" for c in sorted(cached)) + (
                        ", client in a process of its own" if client == "process" else ""),
                        client))
                finally:
                    aacdec_worker.AacDecodeProcess.decode_raw, h264dec.PureH264Decoder.decode = \
                        real
            pipeline._aac = replaced
        finally:
            stop.set()
            if feed_thread.is_alive():
                feed_thread.join(timeout=5)
            eng.stop()

            async def shut_down():
                if tcp is not None:
                    tcp.close()
                tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)

            asyncio.run_coroutine_threadsafe(shut_down(), loop).result(30)
            loop.call_soon_threadsafe(loop.stop)
            server_thread.join(timeout=10)
            loop.close()
            if cams is not None:
                cams.close()
            if replaced is not None and replaced is not pipeline._aac:
                replaced.close()
            proj.close()
        faults.check("media playback")
    played = np.concatenate(state["played"])
    n = min(len(played), len(ref_pcm))
    pcm_err = float(np.abs(played[:n] - ref_pcm[:n]).max())
    log(f"media playback checks [{card}]: {MEDIA_CHECK_TICKS} composites at fader 0 "
        f"are decoded pictures exactly ({len(shown)} distinct); at fader {RT_FADER} max "
        f"{lsb} LSB from the CPU twin (limit {COMPOSITE_LSB}); played PCM {n} samples, max abs "
        f"err {pcm_err:.3e} against the AAC decoder's (atol {MEDIA_PCM_ATOL})")
    if n < RT_RATE * MEDIA_WINDOW_S or pcm_err > MEDIA_PCM_ATOL:
        raise AssertionError(f"the played PCM ({n} samples) is {pcm_err:.3e} from the AAC "
                             "decoder's")
    for res in [first] + later:
        if res["launches"]["crossfade"] != res["video"] or res["video"] < 60:
            raise AssertionError(f"the media window launched the crossfade kernel "
                                 f"{res['launches']['crossfade']} times in {res['video']} "
                                 "video ticks")
    return first


def media_imdct(torch, np, dev, card):
    """Phase 17 (c): ``imdct_batch_torch`` on the card against the numpy
    ``imdct_batch`` (2e-3), and refused while cuBLAS may use TF32."""
    from mixlab_tpu_torch.av.vorbis import imdct_batch, imdct_batch_torch

    specs = np.random.default_rng(21).normal(size=(64, 1024)).astype(np.float32)
    got = imdct_batch_torch(specs, device=dev)
    if got.device.type != "cuda":
        raise AssertionError(f"imdct_batch_torch ran on {got.device}")
    err = float(np.abs(got.cpu().numpy() - imdct_batch(specs)).max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        imdct_batch_torch(specs, device=dev)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    log(f"media imdct [{card}]: imdct_batch_torch 64 x 1024 on {dev} vs numpy max abs err "
        f"{err:.3e} (atol {IMDCT_ATOL}); refused under TF32: {refused}")
    if err > IMDCT_ATOL or not refused:
        raise AssertionError(f"imdct_batch_torch: err {err:.3e}, refused under TF32 {refused}")


GIL_SECONDS = 2.0


def _gil_share(work, seconds=GIL_SECONDS) -> tuple:
    """``work()`` called in a loop on a thread for ``seconds`` while this
    thread counts a pure-Python loop: -> (the share of the interpreter lock
    the work held, 1 - count / the count alone, the mean of a count before
    and after; the work's calls a second).  Two threads that never release
    the lock share it about evenly, so a work of pure Python reads ~0.5."""
    def count(stop_at):
        n = 0
        while time.perf_counter() < stop_at:
            for _ in range(1000):
                n += 1
        return n

    alone = count(time.perf_counter() + seconds)
    stop, calls = threading.Event(), [0]

    def run():
        while not stop.is_set():
            work()
            calls[0] += 1

    thread = threading.Thread(target=run, name="gil-work")
    thread.start()
    time.sleep(0.2)  # the work warmed up
    c0 = calls[0]
    t = time.perf_counter()
    shared = count(t + seconds)
    rate = (calls[0] - c0) / (time.perf_counter() - t)
    stop.set()
    thread.join()
    alone = (alone + count(time.perf_counter() + seconds)) / 2
    return 1.0 - shared / alone, rate


def gil_attribution() -> int:
    """For information, not part of ``main``: the share of this process's
    interpreter lock each piece of phases 17 and 18 holds while it runs
    flat out on a thread of its own, beside its calls a second (a 1080p30
    stream needs 30 pictures and 43.07 AAC granules a second): the native
    1080p H.264 decode, the AAC-LC decode in process and through its codec
    process, the AAC-LC encode at 160 kb/s through its codec process, the
    publish tier's picture path (1080p fetched from the card, scaled to
    1120x700 on the host, CAVLC-encoded) and the upload of a decoded 1080p
    picture; at the interpreter's switch interval and at 0.5 ms (a thread
    that gives the lock up waits up to one interval to take it back while a
    Python thread runs).  Run from the repo's root:

        python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.gil_attribution())'
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import numpy as np

    from mixlab_tpu_torch import kernels, native
    from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
    from mixlab_tpu_torch.av.aacdec import AacLcDecoder
    from mixlab_tpu_torch.av.aacdec_worker import AacDecodeProcess
    from mixlab_tpu_torch.av.codecs import STREAM_PICTURE, PureAacStream
    from mixlab_tpu_torch.av.encode_stream import f32_to_i16
    from mixlab_tpu_torch.av.h264dec import PureH264Decoder
    from mixlab_tpu_torch.av.h264enc import PureH264Stream
    from mixlab_tpu_torch.device import resolve_device
    from mixlab_tpu_torch.engine.engine import _fetch_tree
    from mixlab_tpu_torch.engine.media_player import _upload_planes
    from mixlab_tpu_torch.precision import switch_tf32_off
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings
    from mixlab_tpu_torch.video.scale_host import scale_picture_host

    card = card_line()
    log(card)
    switch_tf32_off()
    dev = resolve_device("cuda")
    kernels.load()
    if not native.available():
        raise AssertionError("the port's native library did not build")
    units, annexb, dcr, _ = media_pictures(torch, np, dev)
    pictures = _decode_all(annexb)
    _, _, _, _, raws = media_mp4(np, units, dcr)
    asc = AudioSpecificConfiguration.lc_stereo(RT_RATE)
    sfi = asc.sampling_frequency_index
    rows = {}

    dec, k = PureH264Decoder(dcr), [0]

    def h264():
        dec.decode(units[k[0] % len(units)])
        k[0] += 1

    rows["H.264 1080p decode, native tier"] = h264
    here = AacLcDecoder(asc)
    rows["AAC-LC decode, in process"] = lambda: here.decode_raw(raws[k[0] % len(raws)], sfi)
    child = AacDecodeProcess(asc)
    rows["AAC-LC decode, codec process"] = lambda: child.decode_raw(raws[k[0] % len(raws)], sfi)
    enc = PureAacStream(RT_RATE, 2, bitrate=160_000)
    granule = f32_to_i16(np.random.default_rng(3).normal(0, 0.2, 2048).astype(np.float32))

    def aac_encode():
        enc.feed(granule)
        enc.poll_frames()

    rows["AAC-LC encode 160 kb/s, codec process"] = aac_encode
    card_pic = Picture(PictureSettings(*MEDIA_SIZE), _upload_planes(*pictures[0][1:], dev))
    h264s = PureH264Stream(STREAM_PICTURE, fps=30, profile="stream", qp=32)

    def publish_picture():
        src = Picture(card_pic.settings, _fetch_tree(dict(card_pic.planes)))
        h264s.feed(scale_picture_host(src, STREAM_PICTURE))
        h264s.poll_access_units()

    rows["publish picture: fetch, 1120x700 host scale, CAVLC"] = publish_picture
    rows["upload of a 1080p picture"] = lambda: _upload_planes(*pictures[0][1:], dev)
    old = sys.getswitchinterval()
    try:
        for switch in (old, 0.0005):
            sys.setswitchinterval(switch)
            for name, work in rows.items():
                share, rate = _gil_share(work)
                log(f"gil [{card}], switch interval {switch * 1e3:.1f} ms: {name}: holds "
                    f"{100 * share:.1f}% of the interpreter lock running flat out, {rate:.1f} "
                    "calls a second")
    finally:
        sys.setswitchinterval(old)
        child.close()
        enc.close()
    return 0


def media_attribution() -> int:
    """For information, not part of ``main``: phase 17 (b)'s served media
    playback with a window for each variant in turns: the AAC encoder on the
    codec thread, a no-op, in its codec process; then, with the encoder in
    its codec process, the monitor client in a process of its own, and with
    it the decode thread's video, audio or both decodes looked up instead of
    run (its uploads and pushes kept); twice.  Run from the repo's root:

        python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.media_attribution())'
    """
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import numpy as np

    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.device import resolve_device
    from mixlab_tpu_torch.precision import switch_tf32_off

    card = card_line()
    log(card)
    switch_tf32_off()
    dev = resolve_device("cuda")
    kernels.load()
    units, annexb, dcr, _ = media_pictures(torch, np, dev)
    pictures = _decode_all(annexb)
    then = ([{"aac": aac} for aac in ("inprocess", "noop", "process")]
            + [{"aac": "process", "client": "process"}]
            + [{"aac": "process", "client": "process", "cached": cached}
               for cached in (("video",), ("audio",), ("audio", "video"))]) * 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        media_session(torch, np, dev, card, Path(tmp), units, dcr, pictures, then=then)
    return 0


def media_paths(torch, np, dev, card, tmp: Path) -> dict:
    """Phase 17: (a) the decode tiers, (b) the served playback, (c) the
    IMDCT; then phase 18 on the same 1080p stream and AAC granules.
    -> {"media": (b)'s launches, "ingest": phase 18 (a)'s launches}."""
    t = time.perf_counter()
    units, annexb, dcr, ms_encode = media_pictures(torch, np, dev)
    frames = media_decode(torch, np, dev, card, annexb)
    mp4 = media_mp4(np, units, dcr)
    launches = media_session(torch, np, dev, card, tmp, units, dcr, frames, mp4)["launches"]
    media_imdct(torch, np, dev, card)
    log(f"phase 17 (media playback) took {time.perf_counter() - t:.1f} s; the port's CAVLC "
        f"encoder {ms_encode:.1f} ms per 1080p frame")
    t = time.perf_counter()
    ingest = ingest_session(torch, np, dev, card, tmp, units, dcr, frames, mp4[4])["launches"]
    log(f"phase 18 (live ingest and broadcast) took {time.perf_counter() - t:.1f} s")
    return {"media": launches, "ingest": ingest}


# ---------------------------------------------------------------------------
# phase 18: live ingest and broadcast on the card (RTMP, Icecast, StreamOutput)
# ---------------------------------------------------------------------------

INGEST_WINDOW_S = 5.0
INGEST_CHECK_TICKS = 12
INGEST_PCM_ATOL = 1e-4    # as MEDIA_PCM_ATOL: the feed plays i16 of the decoder's f32
BROADCAST_SECONDS = 4.0
BROADCAST_PICTURES = 5
BROADCAST_TONE_HZ = 15.0  # tests/test_stream_output_media.py:123
ICECAST_RATE = 48_000
ICECAST_SECONDS = 1
ICECAST_ATOL = 2e-6       # as RESAMPLE_ATOL


def split_picture(np, w=MEDIA_SIZE[0], h=MEDIA_SIZE[1]):
    """The broadcast's test picture: luma 210 on the left half and 16 on the
    right, neutral chroma (tests/test_stream_output_media.py:170-177)."""
    y = np.full((h, w), 16, np.uint8)
    y[:, : w // 2] = 210
    return {"y": y, "u": np.full((h // 2, w // 2), 128, np.uint8),
            "v": np.full((h // 2, w // 2), 128, np.uint8)}


def rtmp_publish(port: int, mount: str, path: str) -> None:
    """The body of the publisher process (``RtmpPublisher``): the port's
    RTMP client (``io_host/rtmp/client.py``) publishes to ``mount`` the AAC
    and AVC sequence headers, then at the wall clock's pace a video tag
    every 1/30 s (the access units of the pickle at ``path`` cycled, all key
    frames) and an AAC-LC tag every 1,024 samples (its raw granules cycled)
    with their 1 kHz timestamps, until its stdin ends.  Prints one JSON
    line: ``audio``, the granule of each audio tag the client's queue took;
    ``video``, the count of its video tags; ``refused``, the tags its full
    queue dropped; ``error``, what ended it early."""
    import asyncio
    import pickle

    from mixlab_tpu_torch.av import flv
    from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
    from mixlab_tpu_torch.io_host.rtmp import client as rtmp_client

    with open(path, "rb") as f:
        stream = pickle.load(f)
    video, audio = stream["video"], stream["audio"]
    sent = {"audio": [], "video": 0, "refused": 0, "error": None}
    key, nalu = flv.VideoFrameType.KEY_FRAME, flv.VideoPacketType.NALU
    stop = threading.Event()
    threading.Thread(target=lambda: (sys.stdin.read(), stop.set()), daemon=True).start()

    async def go():
        client = await rtmp_client.start("127.0.0.1", port, mount, "key")
        asc = AudioSpecificConfiguration.lc_stereo(RT_RATE)
        client.publish_audio(0, flv.AudioPacket(True, asc.to_bytes()).to_bytes())
        client.publish_video(0, flv.VideoPacket(
            key, flv.VideoPacketType.SEQUENCE_HEADER, 0, stream["dcr"]).to_bytes())
        t0, kv, ka = time.monotonic(), 0, 0
        while not stop.is_set():
            now_ms = (time.monotonic() - t0) * 1000
            while kv * 1000 / MEDIA_FPS <= now_ms:
                body = flv.VideoPacket(key, nalu, 0, video[kv % len(video)]).to_bytes()
                if client.publish_video(kv * 1000 // MEDIA_FPS, body):
                    sent["video"] += 1
                else:
                    sent["refused"] += 1
                kv += 1
            while ka * 1024 * 1000 / RT_RATE <= now_ms:
                body = flv.AudioPacket(False, audio[ka % len(audio)]).to_bytes()
                if client.publish_audio(ka * 1024 * 1000 // RT_RATE, body):
                    sent["audio"].append(ka % len(audio))
                else:
                    sent["refused"] += 1
                ka += 1
            await asyncio.sleep(0.002)
        await client.close()

    try:
        asyncio.run(go())
    except Exception as e:  # reported by the phase, which fails on it
        sent["error"] = f"{type(e).__name__}: {e}"
    print(json.dumps(sent), flush=True)


class RtmpPublisher:
    """The script's RTMP publisher in a process of its own, as an encoder
    such as OBS is (``rtmp_publish``): started with the stream's access
    units, raw AAC granules and DCR; ``stop()`` ends it and returns what it
    sent."""

    def __init__(self, port: int, mount: str, video, audio, dcr: bytes, tmp: Path):
        import pickle

        path = tmp / f"publish-{mount}.pkl"
        with open(path, "wb") as f:
            pickle.dump({"video": list(video), "audio": list(audio), "dcr": dcr}, f)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as cs; cs.rtmp_publish({port}, "
             f"{mount!r}, {str(path)!r})"],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self) -> dict:
        try:
            out = self.proc.communicate(input="", timeout=30)[0]  # its stdin ends
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        lines = out.strip().splitlines()
        sent = json.loads(lines[-1]) if lines else {"audio": [], "video": 0, "refused": 0,
                                                    "error": None}
        if self.proc.returncode != 0 and not sent["error"]:
            sent["error"] = f"the publisher process exited {self.proc.returncode}"
        return sent


class _RecordedRecv:
    """A mountpoint receiver whose reads are recorded into ``rec``."""

    def __init__(self, recv, rec):
        self.recv, self.rec = recv, rec

    @property
    def channel_name(self):
        return self.recv.channel_name

    def read_audio(self):
        frame = self.recv.read_audio()
        if frame is not None:
            self.rec["audio"].append(frame.data)
        return frame

    def read_video(self):
        frame = self.recv.read_video()
        if frame is not None:
            self.rec["pts"][id(frame.data)] = frame.source_time
        return frame

    def close(self):
        self.recv.close()


def ingest_session(torch, np, dev, card, tmp: Path, units, dcr, pictures, raws) -> dict:
    """Phase 18: live ingest and broadcast, on a ``ProjectHandle`` on the card
    behind ``run_server`` (an ephemeral port), the Monitor's codec thread
    live (pure tier).  The script's WebSocket client builds
    ``flagship.realtime_video_ops`` with a 1080p camera (fed at 60 fps: the
    bars, then in (b) a split test picture) on the VideoMixer's channel A
    and a StreamInput (RTMP, ``cam``) on channel B at fader 0, which shows
    channel B (``crossfade(A, B, 0) = B``), as phase 17's MediaSource; a
    StreamOutput takes the mixer's composite and ``cam``'s audio;
    StreamInputs listen on ``out`` (RTMP) and ``radio`` (Icecast).

      (a) RTMP ingest: the script's publisher (``RtmpPublisher``, a process
          of its own) sends
          phase 17's 1080p30 CAVLC stream with its 44.1 kHz stereo AAC-LC to
          ``rtmp://127.0.0.1:<port>/cam``.  In a window of INGEST_WINDOW_S,
          with the launch counts set to 0 and read on the engine thread and
          a client on the Monitor, one crossfade launch per video tick; the
          ingested pictures are tensors on the card; INGEST_CHECK_TICKS
          composites at fader 0 holding an ingested picture equal decoded
          pictures exactly; the PCM the feed played (every granule it read)
          is within 1e-4 of the AAC decoder's on the granules published;
          for information the served tick p50/p99 and share over 16.667 ms,
          the ingest's decode ms per frame, the feed's frames late on the
          wall clock and its underrun ticks;
      (b) broadcast: camera A turns to the split picture and a client op
          sets the fader to 1 (the composite is camera A's picture); once
          the mixer holds it, a client op connects the StreamOutput to
          ``rtmp://127.0.0.1:<port>/out`` on the same server; its Live
          indication must come over the session socket; in
          BROADCAST_SECONDS, ``out``'s pictures arrive on the card at
          1120x700, each the split picture's bright and dark halves (or
          black, where camera A's picture expired in the mixer; the split
          picture in most), and its audio holds the 440 Hz tone within 15
          Hz; for information the published video and AAC tags a second,
          the encode queue's dropped frames and the pipe's dropped ticks;
      (c) Icecast: a 48 kHz WAV SOURCE to ``radio`` reaches the feed at
          44.1 kHz, equal within 2e-6 to ``resample_block_np`` of the whole
          file with the listener's i16 conversion.

    Any exception in a server, codec, IO or engine thread, any ERROR log and
    any decode failure the ingest counts fails the phase.  -> (a)'s
    launches and figures."""
    import asyncio

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
    from mixlab_tpu_torch.av.aacdec import AacLcDecoder
    from mixlab_tpu_torch.dsp.resampler import context_len, resample_block_np
    from mixlab_tpu_torch.engine import engine as engine_mod
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.project import open_or_create
    from mixlab_tpu_torch.flagship import realtime_video_ops
    from mixlab_tpu_torch.io_host.wav import write_wav
    from mixlab_tpu_torch.protocol import wire
    from mixlab_tpu_torch.server.app import run_server

    cams = ("ingest-a", "cam")
    pool = [cam_frames(torch, np, dev, i, sizes=CAM_SIZES[:1]) for i in range(4)]
    split = split_picture(np)
    counters = launch_counters()
    ref_y = {pic[1].tobytes(): i for i, pic in enumerate(pictures)}
    rec = {}  # mountpoint -> what its feed read
    clock = {"offset0": None}
    state = {"window": None, "check": None, "walls": [], "stats0": None}

    class RecordedFeed(engine_mod.StreamInputFeed):
        """A StreamInput's feed with the engine thread's reads recorded by
        mountpoint: the audio frames, the pictures released (the first few
        kept), the frames late on the wall clock beyond the first one's
        delay, and the ticks whose PCM ran out (underruns)."""

        def set_recv(self, recv):
            if recv is not None:
                self.rec = rec.setdefault(recv.channel_name, {
                    "audio": [], "pictures": [], "pts": {}, "released": 0, "late": 0,
                    "underrun": 0})
                recv = _RecordedRecv(recv, self.rec)
            super().set_recv(recv)

        def fill_tick(self, t, n):
            pcm, video = super().fill_tick(t, n)
            r = getattr(self, "rec", None)
            if r is None:
                return pcm, video
            if r["audio"] and not pcm[-1].any():
                r["underrun"] += 1
            if video is not None:
                r["released"] += 1
                if len(r["pictures"]) < (240 if self.recv.channel_name == "out" else 4):
                    r["pictures"].append(video)
                # the release's delay on the wall clock behind the frame's
                # stream time, beyond the first frame's
                delay = time.monotonic() - float(r["pts"].pop(id(video)).frac)
                if self.recv.channel_name == "cam":
                    if clock["offset0"] is None:
                        clock["offset0"] = delay
                    r["late"] += delay - clock["offset0"] > 1 / MEDIA_FPS
            return pcm, video

    geo = p.WindowGeometry()
    on_card = torch.device(dev.type, torch.cuda.current_device() if dev.index is None
                           else dev.index) if dev.type == "cuda" else dev
    with _PureTier(), ThreadFaults() as faults:
        proj = open_or_create(tmp / "ingest.mixlab", EngineConfig(sample_rate=RT_RATE),
                              block_ticks=1, device=str(dev))
        eng = proj.engine
        tick_once = eng.tick_once

        def timed_tick(*args):
            t = time.perf_counter()
            out = tick_once(*args)
            state["walls"].append(time.perf_counter() - t)
            return out

        eng.tick_once = timed_tick
        cameras, stop, tcp, publisher = None, threading.Event(), None, None
        sent = {"audio": [], "video": 0, "refused": 0, "error": "not started"}
        loop = asyncio.new_event_loop()
        server_thread = threading.Thread(target=loop.run_forever, name="server-loop")
        server_thread.start()
        try:
            tcp, server = asyncio.run_coroutine_threadsafe(
                run_server(proj, "127.0.0.1", 0), loop).result(60)
            port = tcp.sockets[0].getsockname()[1]
            ops, ids = realtime_video_ops(p, cams, fader=0.0)
            first = int(ids["mixer"].value) + 1
            so, out_in, radio = (p.ModuleId(first + i) for i in range(3))
            ops += [
                p.CreateModule(p.ModuleParams("StreamOutput", p.StreamOutputParams()), geo),
                p.CreateModule(p.ModuleParams("StreamInput", p.StreamInputParams(
                    p.StreamProtocol.RTMP, "out")), geo),
                p.CreateModule(p.ModuleParams("StreamInput", p.StreamInputParams(
                    p.StreamProtocol.ICECAST, "radio")), geo),
                p.CreateConnection(p.InputId(so, 0), p.OutputId(ids["mixer"], 0)),
                p.CreateConnection(p.InputId(so, 1), p.OutputId(ids["cams"][1], 1)),
            ]
            session = {"seq": 0}

            async def client_ops(op_list, until_live=False):
                """The ops over a session socket of their own (a session
                left unread is dropped once its queue fills); with
                ``until_live``, then read it for the StreamOutput's
                indications until one says live.  -> (updates, lives)."""
                reader, writer = await ws_open(port, "/session")
                await ws_read(reader)  # WorkspaceState
                await ws_read(reader)  # MediaLibrary
                updates = []
                for op in op_list:
                    session["seq"] += 1
                    updates += await ws_op(reader, writer, session["seq"], op)
                lives = [u["indication"]["value"]["live"] for u in updates
                         if u["t"] == "SUUpdateModuleIndication" and u["module_id"] == so.value]
                t0 = time.monotonic()
                while until_live and "live" not in lives and time.monotonic() < t0 + 30:
                    kind, body = wire.parse_envelope(await ws_read(reader))
                    if kind == "Update" and body["t"] == "SUUpdateModuleIndication" \
                            and body["module_id"] == so.value:
                        lives.append(body["indication"]["value"]["live"])
                writer.close()
                return updates, lives

            engine_mod.StreamInputFeed = RecordedFeed  # the feeds the ops create
            try:
                updates, _ = asyncio.run_coroutine_threadsafe(client_ops(ops), loop).result(120)
            finally:
                engine_mod.StreamInputFeed = RecordedFeed.__mro__[1]
            for up in updates:
                if up["t"] == "SUCreateModule" and up["params"]["kind"] == "Monitor":
                    session["socket_id"] = up["indication"]["value"]["socket_id"]
            if sorted(rec) != ["cam", "ingest-a", "out", "radio"]:
                raise AssertionError(f"the StreamInputs listen on {sorted(rec)}")
            cameras = Cameras(("ingest-a",), sizes=CAM_SIZES[:1])

            def feeder():
                """Camera A at 60 fps: the bars, then the split picture."""
                start, k = time.monotonic(), 0
                while not stop.is_set():
                    planes, pcm = pool[k % len(pool)]
                    cameras.publish(k, ([split if state.get("split") else planes[0]], pcm))
                    k += 1
                    stop.wait(max(0.0, start + k / 60 - time.monotonic()))

            feed_thread = threading.Thread(target=feeder, name="ingest-feeder")
            feed_thread.start()
            publisher = RtmpPublisher(port, "cam", units, raws, dcr, tmp)
            pipeline = eng._monitor_pipelines[ids["monitor"]]
            mixer = eng._video_mixers[ids["mixer"]]
            pipe = eng.monitor_pipe(ids["monitor"])
            push = pipe.push

            def counted_push(item):
                win, chk = state["window"], state["check"]
                if win is not None:
                    if win["armed"] and not win["open"]:
                        for fn in counters.values():
                            fn.launches = 0
                        win["open"] = True
                        state["walls"].clear()
                        state["stats0"] = server.rtmp_stats.snapshot(), dict(rec["cam"])
                        win["dropped0"] = pipe.dropped
                    elif win["open"] and win["launches"] is None:
                        win["video"] += item[2] is not None
                        win["items"] += 1
                        if not win["armed"]:
                            win["launches"] = {k: fn.launches for k, fn in counters.items()}
                            win["stats1"] = server.rtmp_stats.snapshot(), dict(rec["cam"])
                elif chk is not None and len(chk) < INGEST_CHECK_TICKS \
                        and item[2] is not None and mixer.channels[1].stored is not None:
                    chk.append(item[2].picture.to_numpy())  # on the engine thread
                return push(item)

            pipe.push = counted_push
            if not pipeline.broadcast.ready.wait(60):
                raise AssertionError("the monitor's codecs were not ready in 60 s")
            deadline = time.monotonic() + 30
            while (not rec["cam"]["pictures"] or not rec["cam"]["audio"]) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            if not publisher.alive() or not rec["cam"]["pictures"]:
                raise AssertionError("no ingested picture reached the feed (publisher alive: "
                                     f"{publisher.alive()})")
            devices = {pl.device for pl in rec["cam"]["pictures"][0].picture.planes.values()}
            if devices != {on_card}:
                raise AssertionError(f"ingested pictures are on {devices}, not {dev}")

            # (a) the window
            win = {"armed": False, "open": False, "video": 0, "items": 0, "launches": None}
            state["window"] = win
            segments, elapsed = asyncio.run_coroutine_threadsafe(monitor_segments(
                port, session["socket_id"], INGEST_WINDOW_S, lambda: win.update(armed=True)),
                loop).result(INGEST_WINDOW_S + 60)
            win["armed"] = False
            deadline = time.monotonic() + 10
            while win["launches"] is None and time.monotonic() < deadline:
                time.sleep(0.01)
            state["window"] = None
            if win["launches"] is None:
                raise AssertionError("the ingest window did not close on the engine thread")
            w = np.sort(np.asarray(state["walls"][:win["items"]]) * 1e3)
            (s0, c0), (s1, c1) = state["stats0"], win["stats1"]
            frames = s1.get("video_frames", 0) - s0.get("video_frames", 0)
            res = {"launches": win["launches"], "video": win["video"], "ticks": win["items"],
                   "p50": float(np.percentile(w, 50)), "p99": float(np.percentile(w, 99)),
                   "over": float((w > TICK_BUDGET_MS).mean()),
                   "dropped": pipe.dropped - win["dropped0"],
                   "decode_ms": 1e3 * (s1.get("video_decode_s", 0) - s0.get("video_decode_s", 0))
                   / max(frames, 1), "frames": frames,
                   "released": c1["released"] - c0["released"],
                   "late": c1["late"] - c0["late"], "underrun": c1["underrun"] - c0["underrun"]}
            log(f"ingest window [{card}]: {res['ticks']} ticks, {res['video']} with video, "
                f"{segments} monitor segments in {elapsed:.3f} s; served tick_once p50 "
                f"{res['p50']:.3f} ms, p99 {res['p99']:.3f} ms, over {TICK_BUDGET_MS:.3f} ms "
                f"{100 * res['over']:.2f}%; pipe dropped {res['dropped']}; RTMP ingest "
                f"{frames} 1080p frames decoded at {res['decode_ms']:.3f} ms a frame on the "
                f"decode worker; cam frames released {res['released']}, late on the wall "
                f"clock {res['late']}; audio underrun ticks {res['underrun']}; launches "
                f"{res['launches']}")
            state["check"] = chk = []
            deadline = time.monotonic() + 20
            while len(chk) < INGEST_CHECK_TICKS and time.monotonic() < deadline:
                time.sleep(0.01)
            state["check"] = None
            if len(chk) < INGEST_CHECK_TICKS:
                raise AssertionError(f"only {len(chk)} composites copied for the check")
            shown = set()
            for comp in chk:
                i = ref_y.get(comp["y"].tobytes())
                if i is None or not all(np.array_equal(comp[k], pictures[i][j])
                                        for j, k in ((2, "u"), (3, "v"))):
                    raise AssertionError("a composite at fader 0 is not a decoded picture")
                shown.add(i)

            # (b) the broadcast: camera A's split picture through the mixer
            # at fader 1, then the connect
            ctl = eng._stream_outputs[so]
            state["split"] = True
            asyncio.run_coroutine_threadsafe(client_ops([p.UpdateModuleParams(
                ids["mixer"], p.ModuleParams("VideoMixer", p.VideoMixerParams(
                    a=0, b=1, fader=1.0)))]), loop).result(60)
            deadline = time.monotonic() + 20  # camera A's ring drained of its bars
            while time.monotonic() < deadline:
                stored = mixer.channels[0].stored
                y = None if stored is None else stored.planes["y"][MEDIA_SIZE[1] // 2]
                if y is not None and int(y[8]) == 210 and int(y[-8]) == 16:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError("the mixer never stored camera A's split picture")
            _, seen = asyncio.run_coroutine_threadsafe(client_ops([p.UpdateModuleParams(
                so, p.ModuleParams("StreamOutput", p.StreamOutputParams(
                    seq=2, connect_seq=2, rtmp_url=f"rtmp://127.0.0.1:{port}/out",
                    rtmp_stream_key="key")))], until_live=True), loop).result(60)
            if "live" not in seen:
                raise AssertionError(f"the StreamOutput's indications {seen} never said live")
            b0, d0, t0 = dict(ctl.stats), eng.monitor_pipe(so).dropped, time.monotonic()
            n0 = len(rec["out"]["audio"])
            time.sleep(BROADCAST_SECONDS)
            b1, d1, bt = dict(ctl.stats), eng.monitor_pipe(so).dropped, time.monotonic() - t0
            deadline = time.monotonic() + 20  # and at least BROADCAST_PICTURES back
            while len(rec["out"]["pictures"]) < BROADCAST_PICTURES \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            pics = list(rec["out"]["pictures"])
            out_pcm = np.concatenate(rec["out"]["audio"][n0:] or [np.zeros((0, 2), np.int16)])

            # (c) Icecast
            ts = np.arange(ICECAST_RATE * ICECAST_SECONDS) / ICECAST_RATE
            wav_pcm = (np.stack([np.sin(2 * np.pi * 700 * ts), np.sin(2 * np.pi * 300 * ts)], 1)
                       * 16000).astype(np.int16)
            write_wav(tmp / "radio.wav", ICECAST_RATE, wav_pcm)
            want_wav = resample_block_np(
                wav_pcm.astype(np.float32), np.zeros((context_len(ICECAST_RATE, RT_RATE), 2),
                                                     np.float32), ICECAST_RATE, RT_RATE)[0]
            want_wav = np.clip(want_wav, -32768, 32767).astype(np.int16)

            async def source():
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(b"SOURCE /radio HTTP/1.0\r\nContent-Type: audio/wav\r\n\r\n"
                             + (tmp / "radio.wav").read_bytes())
                await writer.drain()
                status = await reader.read(64)
                t = time.monotonic()
                while sum(map(len, rec["radio"]["audio"])) < len(want_wav) \
                        and time.monotonic() < t + 30:
                    await asyncio.sleep(0.02)
                writer.close()
                return status

            status = asyncio.run_coroutine_threadsafe(source(), loop).result(60)
            radio = np.concatenate(rec["radio"]["audio"] or [np.zeros((0, 2), np.int16)])
        finally:
            stop.set()
            if publisher is not None:
                sent = publisher.stop()
            if cameras is not None:
                feed_thread.join(timeout=5)
            eng.stop()

            async def shut_down():
                if tcp is not None:
                    tcp.close()
                tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)

            asyncio.run_coroutine_threadsafe(shut_down(), loop).result(30)
            loop.call_soon_threadsafe(loop.stop)
            server_thread.join(timeout=10)
            loop.close()
            if cameras is not None:
                cameras.close()
            proj.close()
        faults.check("live ingest and broadcast")
    failures = {k: v for k, v in server.rtmp_stats.snapshot().items()
                if k.endswith("failures") and v}
    if failures or sent["error"]:
        raise AssertionError(f"the RTMP ingest counted {failures}; publisher: {sent['error']}")

    # (a) the played PCM against the AAC decoder on the granules published
    played = np.concatenate(rec["cam"]["audio"]).astype(np.float32) / 32768.0
    asc = AudioSpecificConfiguration.lc_stereo(RT_RATE)
    dec = AacLcDecoder(asc)
    n = len(played) // 1024
    if n > len(sent["audio"]):
        raise AssertionError(f"the feed read {n} granules of {len(sent['audio'])} published")
    ref = np.concatenate([dec.decode_raw(raws[k], asc.sampling_frequency_index)
                          for k in sent["audio"][:n]])
    pcm_err = float(np.abs(played[:n * 1024] - ref).max())
    log(f"ingest checks [{card}]: {INGEST_CHECK_TICKS} composites at fader 0 are decoded "
        f"pictures exactly ({len(shown)} distinct); ingested pictures on {dev}; played PCM "
        f"{n} granules, max abs err {pcm_err:.3e} against the AAC decoder's (atol "
        f"{INGEST_PCM_ATOL}); publisher sent {sent['video']} video and {len(sent['audio'])} "
        f"audio tags, its queue refused {sent['refused']}")
    if n * 1024 < RT_RATE * INGEST_WINDOW_S or pcm_err > INGEST_PCM_ATOL:
        raise AssertionError(f"the ingested PCM ({n} granules) is {pcm_err:.3e} from the AAC "
                             "decoder's")
    if res["launches"]["crossfade"] != res["video"] or res["video"] < 60:
        raise AssertionError(f"the ingest window launched the crossfade kernel "
                             f"{res['launches']['crossfade']} times in {res['video']} video ticks")

    # (b) what came back on "out": each picture the split one, or black
    # where camera A's picture had expired in the mixer (a stalled source)
    if not pics:
        raise AssertionError("no picture of the broadcast came back on the out mountpoint")
    halves, sizes = [], set()
    for pic in pics:
        y = pic.picture.planes["y"]
        if y.device != on_card:
            raise AssertionError(f"the broadcast's pictures came back on {y.device}")
        y = y.cpu().numpy().astype(np.float64)
        hh, ww = y.shape
        sizes.add((ww, hh))
        mid = y[hh // 2 - 50: hh // 2 + 50]
        halves.append((float(mid[:, : ww // 4].mean()), float(mid[:, 3 * ww // 4:].mean())))
    n_split = sum(abs(b - 210) < 15 and abs(d - 16) < 15 for b, d in halves)
    n_black = sum(b == d == 0 for b, d in halves)
    bright, dark = halves[-1]
    body = out_pcm[2048:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(body * np.hanning(len(body)))) if len(body) > 4096 else None
    peak = float((np.argmax(spec[1:]) + 1) * RT_RATE / len(body)) if spec is not None else 0.0
    rates = {k: (b1[k] - b0[k]) / bt for k in ("video_tags", "audio_tags", "video_refused",
                                                 "audio_refused")}
    log(f"broadcast [{card}]: indications {seen}; out mountpoint {sorted(sizes)}, "
        f"{len(pics)} pictures: {n_split} the split picture, {n_black} black; the last's mid "
        f"rows bright half {bright:.1f}, dark half {dark:.1f}; tone peak {peak:.2f} Hz over "
        f"{len(body)} samples; published {rates['video_tags']:.2f} video and "
        f"{rates['audio_tags']:.2f} AAC tags/s in {bt:.3f} s, the client's full queue refused "
        f"{rates['video_refused']:.2f} and {rates['audio_refused']:.2f} a second; "
        f"{b1['video_dropped'] - b0['video_dropped']} video frames dropped by the encode "
        f"queue; the StreamOutput pipe dropped {d1 - d0} ticks")
    if sizes != {(1120, 700)} or n_split + n_black < len(pics) or 2 * n_split <= len(pics) \
            or abs(peak - 440.0) >= BROADCAST_TONE_HZ:
        raise AssertionError(f"the broadcast came back as {sorted(sizes)}, {n_split} of "
                             f"{len(pics)} pictures split ({n_black} black), tone {peak:.2f} Hz")

    # (c) the Icecast SOURCE
    m = min(len(radio), len(want_wav))
    radio_err = float(np.abs(radio[:m].astype(np.float32) - want_wav[:m]).max()) / 32768.0 \
        if m else float("inf")
    status_line = status.split(b"\r\n")[0]
    log(f"icecast [{card}]: {status_line!r}; {len(radio)} samples at {RT_RATE} Hz "
        f"of {len(want_wav)} from {len(wav_pcm)} at {ICECAST_RATE} Hz, max abs err "
        f"{radio_err:.3e} against resample_block_np (atol {ICECAST_ATOL})")
    if b"200 OK" not in status or len(radio) != len(want_wav) or radio_err > ICECAST_ATOL:
        raise AssertionError(f"the Icecast ingest gave {len(radio)} samples, err {radio_err:.3e}")
    return res


# ---------------------------------------------------------------------------
# phase 23: the last surface (the synth example, FLAC monitor audio, the
# fleet demo)
# ---------------------------------------------------------------------------

EXAMPLE_SECONDS = 5
EXAMPLE_LSB = 4          # CPU_RENDER_ATOL (1e-4) on the int16 WAV: 3.3 LSB, rounded up
FLEET_DEMO_TIMEOUT = 600


def synth_example(torch, np, card, tmp: Path, sr: int) -> dict:
    """``examples/torch_synth_patch.py`` for 5 s at ``sr`` on the card, with
    the launch counts set to 0 just before and read just after, then on the
    CPU: the int16 PCM within ``EXAMPLE_LSB``, rms over 0.01, some kernel
    launched.  -> the launches."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_synth_patch", ROOT / "examples" / "torch_synth_patch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = ["--seconds", str(EXAMPLE_SECONDS), "--sample-rate", str(sr)]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    pcm = example.main([str(tmp / f"synth_{sr}.wav"), *args, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in counters.items()}
    cpu = example.main([str(tmp / f"synth_cpu_{sr}.wav"), *args, "--device", "cpu"])
    err = int(np.abs(pcm.astype(np.int32) - cpu.astype(np.int32)).max())
    rms = float(np.sqrt(((pcm.astype(np.float64) / 32767.0) ** 2).mean()))
    log(f"synth example {sr} Hz [{card}]: {EXAMPLE_SECONDS} s on cuda in {wall:.3f} s, "
        f"launches {launches}; cuda vs cpu int16 PCM max abs err {err} LSB (tolerance "
        f"{EXAMPLE_LSB} LSB, phase 6's {CPU_RENDER_ATOL} on the int16 WAV), rms {rms:.4f}")
    if pcm.shape != (EXAMPLE_SECONDS * sr, 2) or cpu.shape != pcm.shape:
        raise AssertionError(f"the synth example gave {pcm.shape} on cuda, {cpu.shape} on cpu")
    if err > EXAMPLE_LSB:
        raise AssertionError(f"the synth example at {sr} Hz: cuda and cpu {err} LSB apart")
    if not rms > 0.01:
        raise AssertionError(f"the synth example at {sr} Hz rendered silence: rms {rms}")
    if not any(launches.values()):
        raise AssertionError(f"the synth example at {sr} Hz launched no kernel")
    return launches


def fleet_demo(card) -> None:
    """``examples/torch_fleet_demo.py`` as a subprocess (its workers on the
    card), in a session of its own: exit 0 within ``FLEET_DEMO_TIMEOUT``,
    the migrated line says the runtime state was restored, and no process
    of its session is left; prints its seconds."""
    import os
    import signal

    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / "torch_fleet_demo.py")],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=FLEET_DEMO_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t
    try:
        os.killpg(proc.pid, 0)
        left = True
    except ProcessLookupError:
        left = False
    if left:
        os.killpg(proc.pid, signal.SIGKILL)
    lines = out.splitlines()
    migrated = [line for line in lines if line.startswith("migrated: ")]
    placed = [line for line in lines if line.startswith("placed ")]
    log(f"fleet demo [{card}]: exit {proc.returncode} in {seconds:.2f} s; "
        f"{len(placed)} placed; {migrated[0] if migrated else 'no migrated line'}; "
        f"processes left in its session: {left}")
    if proc.returncode != 0 or left:
        raise AssertionError(f"the fleet demo exited {proc.returncode}, processes left "
                             f"{left}:\n{out[-2000:]}\n{err[-2000:]}")
    if len(placed) != 3 or len(migrated) != 1 or \
            not migrated[0].endswith("(runtime state restored: True)"):
        raise AssertionError(f"the fleet demo did not restore the migrated state:\n{out[-2000:]}")


def flac_lock(np, card, seconds: int = 2) -> None:
    """For information: the Monitor's FLAC encoder (``PureFlacStream``, fed
    a tick of 44.1 kHz stereo at a time, as the codec thread feeds it)
    alone on this thread, in ms per second of audio, then on a thread of
    its own beside a pure-Python counter: its share of the interpreter
    lock (``_gil_share``)."""
    from mixlab_tpu_torch.av.flacenc import PureFlacStream

    rng = np.random.default_rng(23)
    n = seconds * RT_RATE
    tone = 9000 * np.sin(2 * np.pi * 440.0 * np.arange(n) / RT_RATE)
    pcm = np.clip(np.stack([tone, -tone], 1) + rng.normal(0, 3000, (n, 2)),
                  -32768, 32767).astype(np.int16)
    stream = PureFlacStream(RT_RATE, 2, 1024)
    t = time.perf_counter()
    for i in range(0, n, RT_SPT):
        stream.feed(pcm[i:i + RT_SPT].reshape(-1))
        stream.poll_frames()
    ms = 1e3 * (time.perf_counter() - t) / seconds
    tick = pcm[:RT_SPT].reshape(-1)

    def work():
        stream.feed(tick)
        stream.poll_frames()

    share, rate = _gil_share(work)
    log(f"FLAC encoder [{card}]: {ms:.3f} ms per second of audio alone on one thread "
        f"({seconds} s in ticks of {RT_SPT}); on a thread of its own beside a pure-Python "
        f"counter it held {share:.3f} of the interpreter lock ({rate:.1f} ticks a second)")


def last_surface(torch, np, dev, card, tmp: Path) -> dict:
    """Phase 23: (a) the synth example at 48 and 44.1 kHz; (b) the served
    realtime workspace's Monitor with ``MIXLAB_PURE_AUDIO=flac``, then with
    AAC, in turns, and the FLAC encoder's share of the interpreter lock;
    (c) the fleet demo.  -> the launches of (a)'s paths and
    of the FLAC session's window."""
    t = time.perf_counter()
    paths = {f"example_{sr}": synth_example(torch, np, card, tmp, sr) for sr in (48_000, 44_100)}
    served = {}
    for audio in ("flac", "aac"):
        (tmp / audio).mkdir()
        served[audio] = served_session(torch, np, dev, card, tmp / audio, pure_audio=audio)
    log(f"served FLAC vs AAC in turns [{card}]: " + "; ".join(
        f"{audio}: {r['segments_per_s']:.2f} segments/s, encoder {r['ms_audio_s']:.3f} ms per "
        f"second of audio, tick p50 {r['p50']:.3f} ms, p99 {r['p99']:.3f} ms, over "
        f"{100 * r['over']:.2f}%, dropped {r['dropped']} of {r['ticks']} ticks, crossfade "
        f"launches {r['launches']['crossfade']}" for audio, r in served.items()))
    paths["served_flac"] = served["flac"]["launches"]
    flac_lock(np, card)
    fleet_demo(card)
    log(f"phase 23 (the last surface) took {time.perf_counter() - t:.1f} s")
    return paths


def last_surface_phase() -> int:
    """Not in ``main`` alone: phase 23 by itself, after the build.
    ``python3 -c 'import chip_smoke as cs, sys; sys.exit(cs.last_surface_phase())'``"""
    import numpy as np
    import torch

    from mixlab_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, dev = card_line(), torch.device("cuda", 0)
    log(card)
    kernels.load()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = last_surface(torch, np, dev, card, Path(tmp))
    log(json.dumps(paths))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))  # tests/oracle.py
    import numpy as np

    from mixlab_tpu_torch import kernels
    from mixlab_tpu_torch.device import resolve_device
    from mixlab_tpu_torch.engine.project import ProjectBase
    from mixlab_tpu_torch.flagship import build_16_module_graph

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    dev = resolve_device("cuda")

    t = time.perf_counter()
    kernels.load()
    log(f"kernels built and loaded in {time.perf_counter() - t:.2f} s: {kernels.library_path().name}")
    build_log = kernels.library_path().with_suffix(".log")
    if build_log.exists():
        text = build_log.read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())
        for name, (regs, stack, stores, loads) in ptxas_summary(text).items():
            log(f"ptxas {name}: {regs} registers, {stack} bytes stack, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")

    errs = {"envelope": check_envelope(torch, np, dev), "eq_cascade": check_eq(torch, np, dev),
            "region": check_region(torch, np, dev), "crossfade": check_crossfade(torch, np, dev)}
    errs["resize"] = errs["passthrough"] = check_resize(torch, np, dev)
    check_scale(torch, np, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        proj = tmp / "flagship.mixlab"
        with ProjectBase(proj) as base:
            base.write_workspace(build_16_module_graph()[0].to_persist())
        paths = {str(sr): main_path(torch, np, proj, tmp, sr) for sr in (44_100, 48_000)}
        paths["mp4"] = mp4_path(torch, proj, tmp)
        paths["realtime"] = realtime_path(torch, np, dev)
        paths["composite"] = composite_path(torch, np, dev, card)
        paths["profile"] = profile_path(torch, dev, card)
        times = timing(torch, np, dev, card, proj)
        times.update(realtime_timing(torch, np, dev, card))
        times.update(video_timing(torch, np, dev, card))
        paths.update(edit_path(torch, np, dev, card))
        # phase 16 before phase 15: after the served session's threads the
        # profiler in this process has recorded no device kernel
        batched_errs, batched_times, batched_launches, _ = batched_paths(torch, np, dev, card)
        paths.update(batched_launches)
        for key, err in batched_errs.items():
            errs[key] = max(errs[key], err)
        err, batched_times["region"], region_launches, _ = batched_region(torch, np, dev, card)
        errs["region"] = max(errs["region"], err)
        paths.update(region_launches)
        for key, err in lookback_numbers(torch, np, dev, card).items():
            errs[key] = max(errs[key], err)
        paths.update(scale_out(torch, np, dev, card, tmp))
        paths["served"] = served_session(torch, np, dev, card, tmp)["launches"]
        codec_timing(torch, np, dev, card)
        paths.update(media_paths(torch, np, dev, card, tmp))
        paths.update(last_surface(torch, np, dev, card, tmp))
        served_subprocess(tmp)

    # each kernel's launches on the main path that carries it
    launches = {"envelope": paths["44100"]["envelope"], "eq_cascade": paths["44100"]["eq_cascade"],
                "region": paths["48000"]["region"], "crossfade": paths["realtime"]["crossfade"],
                "resize": paths["composite"]["resize"],
                "passthrough": paths["profile"]["passthrough"]}
    rows = (("envelope", "envelope_block", "mixlab_tpu_torch/csrc/envelope.cu",
             "mixlab_tpu/dsp/envelope_pallas.py:347"),
            ("eq_cascade", "eq_cascade", "mixlab_tpu_torch/csrc/eq_cascade.cu",
             "mixlab_tpu/dsp/eq_pallas.py:261"),
            ("region", "region_part", "mixlab_tpu_torch/csrc/region.cu",
             "mixlab_tpu/engine/pallas_graph.py:377"),
            ("crossfade", "crossfade", "mixlab_tpu_torch/csrc/crossfade.cu",
             "mixlab_tpu/video/blend.py:86"),
            ("resize", "resize_picture", "mixlab_tpu_torch/csrc/resize.cu",
             "mixlab_tpu/video/resize_pallas.py:143"),
            ("passthrough", "passthrough", "mixlab_tpu_torch/csrc/passthrough.cu",
             "tools/profile_env_eq.py:221"))
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[key], "max_abs_err": errs[key],
         "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"],
         "bound_ms": times[key]["bound_ms"], "bound_by": times[key]["bound_by"],
         "library_ms": times[key].get("library_ms"),
         "launches_by_path": {name: counts[key] for name, counts in paths.items()},
         **({"batched": batched_times[key]} if key in batched_times else {})}
        for key, name, source, replaces in rows
    ]}
    log(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
