#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mixlab_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA toolkit) and the repository checkout; it
imports no jax.  It checks and does not measure: the port's numbers come
from the benchmark (``python3 -m portbench.run``, recorded in ``PERF.md``
and the ledger).  Phases (numbered by name; there is no 7, 10 or 14), any
failure of which exits non-zero:

  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels (csrc/*.cu) and print ptxas's lines
     (registers, stack and spill bytes of each entry);
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
 15. the served session on the card, the realtime engine's Monitor codec
     threads live (pure tier): (a) in this process a ``ProjectHandle`` on
     cuda and ``run_server`` on an ephemeral port; a WebSocket client of the
     script's own builds ``flagship.realtime_video_ops`` (cameras fed at
     60 fps), reads the Monitor's socket id from its indication and
     subscribes to ``/_monitor/<id>`` for 5 s: the init packet, then at
     least 10 segments a second that walk as ``moof``/``mdat``; exactly one
     crossfade launch per video tick (counts set to 0 and read on the
     engine thread), the native CAVLC tier, and the pictures fed to the
     encoder within 1 LSB of the engine's composites; then the native and
     numpy CAVLC tiers give the same bytes on the cameras' pictures scaled
     on the card; (b) ``python -m mixlab_tpu_torch --listen
     127.0.0.1:<port>`` at its default device: ``GET /`` with the port's
     ``index.html``, one client op, SIGTERM -> exit 0 within 15 s with the
     op persisted.  Any exception in a server, codec or engine thread fails
     the phase;
 16. the batched paths, each with the launch counts set to 0 just before and
     read just after: (a) the batched eq kernel (B = 1, 2, 32, 133, 1,024
     and the B either side of each switch of the plan's form x S = 8,192,
     12,000, 44,100, 96,000: the cooperative grid, one CTA a row) and the
     batched envelope kernel (B = 1, 2, 32, 1,024 and the B either side of
     each switch of the plan's form x S = 4,097 (a last tile of one
     sample), 12,000, 32,768, 48,000, 96,000; dense and sparse gates; every
     form the plan takes: the cooperative grid, one CTA a block, the
     look-back) against their batched twins over 3 carried blocks (EQ_TOL,
     ENV_ATOL), exactly one device launch a call for every B (profiler);
     (b) the fleet: the flagship at 48 kHz in 15-tick blocks, N = 1,024
     sessions with their own params, one eq launch and one envelope launch
     a block, four slots against single-patch renders on the card
     (EQ_TOL); (c) fleet serving: a ``FleetEngine`` of 1,024 slots on the
     card behind a ``FleetServeApp``, 16 WebSocket clients for 5 s: joins,
     states, framed i16 PCM, one edit and its Sync, every unedited session
     within 1 LSB of a dedicated render from its join; (d)
     ``stem_parallel_step`` with 16 stems (master = 16 x one stem within
     2e-4, one eq launch), the resampler against ``resample_block_np``
     within 2e-6 (refused under cuDNN TF32);
 17. media playback, after phase 15: (a) the port's native H.264 decode
     tier against its Python tier, bit-exact, on the x264 streams committed
     under ``tests/data/h264/`` (CAVLC and CABAC, P and B, the High
     profile's 8x8 transform) and on a 1080p CAVLC intra stream of the
     port's encoder; (b) a 1920x1080, 30 fps, 10 s MP4 with 44.1 kHz stereo
     AAC-LC made here by the port's encoders and mux, uploaded into a
     ``ProjectHandle`` on cuda behind ``run_server``; the script's
     WebSocket client builds the realtime workspace with one 1080p camera
     on the VideoMixer's channel A at fader 0 and a MediaSource of the
     upload on channel B, and subscribes to the Monitor: one crossfade
     launch per video tick in a 5 s window (counts set to 0 and read on the
     engine thread); 12 composites holding a media picture equal decoded
     pictures exactly; at fader 0.6, 12 composites within 1 LSB of the CPU
     twin on the mixer's stored pictures; the PCM the engine's feed played
     equal to the AAC decoder's within 1e-4 (the MediaPlayer decodes
     AAC-LC in its codec process); (c) ``imdct_batch_torch`` on the card
     against the numpy ``imdct_batch`` within 2e-3, refused under TF32;
 18. live ingest and broadcast, after phase 17 on its 1080p30 stream and
     AAC granules (``ingest_session``), behind ``run_server`` on a
     ``ProjectHandle`` on cuda: (a) the script's RTMP publisher (the port's
     client) sends the stream with its AAC-LC to ``cam``, a StreamInput on
     the VideoMixer's channel B at fader 0 with a 1080p camera on A: one
     crossfade launch per video tick in a 5 s window (counts set to 0 and
     read on the engine thread), ingested pictures on the card, 12
     composites equal decoded pictures exactly, the played PCM within 1e-4
     of the AAC decoder's; (b) a StreamOutput connected by a client op to
     ``out`` on the same server: Live over the session socket, 1120x700
     pictures of a split test picture and the 440 Hz tone back on ``out``;
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
     fleet at N = 8,192 over a 4-entry mesh: every session's taps equal to
     the one-device fleet's bit for bit, one eq launch a shard; (c)
     ``row_sharded_blend`` over 4 entries at 1080p and heights that do not
     divide by 4: equal to the twin, one crossfade launch a shard; (d) the
     live ``Engine`` with ``StemsPatch.compiler`` over a 2-entry mesh, 60
     ticks in direct drive with a structural edit at tick 30: taps 5 x the
     one-device engine's within 1e-6; (e) two processes in a ``gloo`` group
     (``mesh_worker``), each a 2-entry mesh on the card: the master's
     checksum within 1e-3 relative of one process's 4-entry mesh, the
     region kernel twice a process at 16 ticks, and over ``nccl`` across
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
     flagship's plan); (b) the fleet at 48 kHz with per-instance params on
     the region program, 16 ticks (N = 1,024 and 8,192) and 48 ticks
     (N = 1,024): region 1, eq 0, envelope 1 a block; taps and state within
     2e-5 of the same fleet on the regular program and four slots of
     single-patch region renders; (c) fleet serving in 16-tick blocks: one
     region launch a block, slot PCM within 1 LSB of dedicated renders;
     (d) the fleet of 8,192 over a 4-entry mesh at 16 ticks: 4 region
     launches a block, taps bit-equal to one device's;
 21. the live engine's edit path, after phase 9 and before phase 16 (and
     phase 15's threads), each path with the launch counts set to 0 just
     before and read just after: (a) the threaded realtime engine (the
     flagship, 1080p and 720p cameras fed at 60 fps, the VideoMixer, the
     crossfade kernel) for a 5 s quiet window, then 5 s of 10 structural
     ops a second (create an oscillator, connect it to the Mixer, delete
     it) and 30 VideoMixer fader edits a second: for each window the ticks,
     the fewest in a second (at least 30), ticks without exactly one
     crossfade launch (none allowed); every structural op adopted, no stale
     program adopted, the final program the final workspace's; (b) the
     48 kHz stems engine over a 2-entry mesh in 16-tick blocks, threaded,
     one structural edit with the compile worker's warm held 0.6 s: one
     region launch a shard every block before, during and after the warm,
     two on the compile thread; (c) ``pipeline_depth`` 0, 1 and 2 on the
     realtime engine in direct drive for 120 ticks: the routed Monitor
     audio and composites identical, each d ticks later; (d) whether the
     libavcodec shim builds here and the codec tier taken; where it does,
     the phase 17 clip through ``MediaPlayer._run_shim``;
 22. the look-back's launch number on the device (``csrc/rows.cuh``), after
     phase 20: for the envelope and region kernels, a batched launch at a
     shape whose plan takes the look-back (envelope 32 x 96,000, region 64 x
     102,400), after two calls on a side stream, captured on that stream
     into a CUDA graph and replayed 4 times with new inputs copied into its
     static tensors and an eager look-back call between replays, every
     replay and call against the twin on its inputs (the envelope bit for
     bit, the region within 2e-5), and the scratch's count of ended
     launches equal to the launches made on it; then two host threads of
     200 look-back calls each on one stream, every call against the twin;
 23. the last surface, after phase 18 and before phase 15 (b), each path with
     the launch counts set to 0 just before and read just after: (a)
     ``examples/torch_synth_patch.py`` for 5 s at 48 and 44.1 kHz on the
     card (its ``main``; the launches of each kernel printed, none assumed,
     some kernel must launch), then on the CPU: the int16 PCM within 4 LSB
     (phase 6's 1e-4 on the WAV), rms over 0.01; (b) phase 15 (a)'s served
     session with ``MIXLAB_PURE_AUDIO=flac`` (lossless FLAC encoded on the
     codec thread), 5 s: the init packet's mime names ``flac`` and holds
     ``fLaC`` and ``dfLa``, every audio sample of every segment the client
     read decodes by ``av/flacdec.py`` to exactly the int16 PCM fed to the
     encoder, one crossfade launch a video tick; (c)
     ``examples/torch_fleet_demo.py`` as a subprocess on the card (600 s
     timeout): exit 0, the migrated workspace's runtime state restored, no
     process of its session left.

One phase alone, after the build and with TF32 off as in ``main``:
``python3 chip_smoke.py --phase NAME``, NAME one of ``region`` (phase 20),
``lookback`` (22), ``edit`` (21) and ``last_surface`` (23).

TF32 is switched off for matrix products and cuDNN (the eq twin's Toeplitz
products must be IEEE f32, as the JAX package's Precision.HIGHEST).
The next-to-last line is a JSON object with one entry per kernel: its
launches on each path, its largest error against its twin; the last line is
``{"ok": true, "device": {...}}``.
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
if str(ROOT / "tests") not in sys.path:  # tests/oracle.py, tests/torch_support.py
    sys.path.append(str(ROOT / "tests"))

from torch_support import (REGION_ATOL, HoldRegion, fleet_workspaces,  # noqa: E402
                           fmp4_boxes, launch_tiles, parse_fmp4, peaks_exact, region_inputs,
                           region_plans, rows_err, run_blocks, same_bits, sink_zoo,
                           tile_edge_gates, tree_err)

ENV_ATOL = 2e-5          # tests/test_envelope_pallas.py
EQ_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_eq_pallas.py:110
ORACLE_ATOL = 3e-3       # tests/test_whole_graph_oracle.py:55
CPU_RENDER_ATOL = 1e-4
MS_PER_SAMPLE = 1000.0 / 44_100
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


# --------------------------------------------------------------------------
# kernel vs twin checks


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
            sm, tm = run_blocks(pm, ws, 3, feeds)
        if hold.launches != 3 * parts:
            raise AssertionError(f"{name}: {hold.launches} region launches, want {3 * parts}")
        pr = compile_patch(ws, cfg, block, dev, mega=False)
        sr, tr = run_blocks(pr, ws, 3, feeds)
        prog_err = max(tree_err(sm, sr, "state"),
                       *(tree_err(a, b, "taps") for a, b in zip(tm, tr)))
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
    audio = render_cli.main([str(proj), str(out_wav), "--seconds", "10",
                             "--sample-rate", str(sample_rate)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"main path {sample_rate} Hz: render_cli 10 s on cuda, launches {launches}")
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
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        cams.close()
        ref_cams.close()
        eng.stop()
        ref.stop()
    log(f"realtime main path: Engine(device={dev}) {n_ticks} ticks with 1080p + 720p ingest, "
        f"launches {launches}; every composite "
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


def composite_path(torch, np, dev, n_frames=COMPOSITE_FRAMES):
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
    frames = [composite_frame(torch, i, dev, resize_picture_polyphase) for i in range(n_frames)]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    h, w = COMPOSITE_SRC
    log(f"composite main path: {n_frames} config-5 frames ({w}x{h} -> {2 * w}x{2 * h}, "
        f"polyphase resize, roll, crossfade at {COMPOSITE_FADE}) on {dev}, "
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


def profile_path(torch, dev):
    """The profiling tool's nine rows at 48 kHz (S = 384,000) on a short
    slope, the launch counts set to 0 just before and read just after."""
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.tools import profile_env_eq as tool

    S = BlockSpec(tool.BLOCK_TICKS).n_samples(EngineConfig(sample_rate=tool.SAMPLE_RATE))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    rows = tool.profile_rows(str(dev), reps=1, n1=2, n2=10,
                             log=lambda line: log(f"profile tool {line}"))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"profile tool path: {len(rows)} rows, launches {launches}")
    regions = {"chain", "full", "full_noosc", "no_env"}
    for r in rows:
        log(f"profile tool row {r['name']}: {r['program']} program, {r['blocks']} blocks of "
            f"{S} samples, launches {r['launches']}")
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


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# the .mp4 export and the served session


MP4_SECONDS = 2


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
        render_cli.main([str(proj), str(out), "--seconds", str(MP4_SECONDS)])
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
    walk = parse_fmp4(out.read_bytes())
    n_blocks = MP4_SECONDS * 60 // 60
    want = {"mp4a": MP4_SECONDS * RT_RATE // 1024, "avc1": MP4_SECONDS * 60 // 6}
    log(f"mp4 path: render_cli {MP4_SECONDS} s .mp4 on cuda, "
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


def served_session(torch, np, dev, tmp: Path, pure_audio: str = "aac") -> dict:
    """Phase 15 (a): a ``ProjectHandle`` on the card and ``run_server`` on an
    ephemeral port in this process.  A client of the script's own builds
    ``flagship.realtime_video_ops`` over the session socket, a feeder thread
    publishes both cameras at 60 fps, and the client subscribes to the
    Monitor's ``/_monitor/<socket id>`` for 5 s.  The launch counts are
    set to 0 and read on the engine thread, at the Monitor's pipe pushes
    that open and close the window, so the crossfade count must equal the
    video ticks in it exactly.

    ``pure_audio="flac"`` muxes lossless FLAC (``MIXLAB_PURE_AUDIO=flac``),
    encoded on the codec thread: the init packet must name ``flac`` and hold
    ``fLaC`` and ``dfLa``, and every audio sample of every segment the client
    read must decode by the port's ``av/flacdec.py`` to exactly the int16
    PCM the codec thread fed its encoder (``_RecordedFlac``).  -> the
    window's kernel launches under ``"launches"`` and its segments."""
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
    fed, kept = [], {} if pure_audio == "flac" else None
    with _PureTier(pure_audio), _RecordedFlac(fed), ThreadFaults() as faults:
        proj = open_or_create(tmp / "served.mixlab", EngineConfig(sample_rate=RT_RATE),
                              block_ticks=1, device=str(dev))
        eng = proj.engine
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
        tcp = None
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

            def arm():
                window["armed"] = True

            segments, elapsed = asyncio.run_coroutine_threadsafe(monitor_segments(
                port, socket_id, SERVED_SECONDS, arm, kept), loop).result(SERVED_SECONDS + 60)
            window["armed"] = False
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
            proj.close()
        faults.check("served session")
    if window["launches"] is None:
        raise AssertionError("the served window did not close on the engine thread")
    launches = window["launches"]
    log(f"served session{', FLAC audio' if pure_audio == 'flac' else ''}: codec tier "
        f"{codec_tier()}, CAVLC tier {cavlc}; {segments} segments in {elapsed:.3f} s; "
        f"{window['items']} ticks in the window, {window['video']} with video; launches "
        f"{launches}; {checked} fed pictures within 1 LSB of the engine's composites scaled "
        f"on the host")
    if cavlc != "NativeCavlcIntraEncoder":
        raise AssertionError(f"the monitor's CAVLC tier is {cavlc}, not the native encoder")
    if launches["crossfade"] != window["video"] or window["video"] < 60:
        raise AssertionError(f"the served window launched the crossfade kernel "
                             f"{launches['crossfade']} times in {window['video']} video ticks")
    if segments < 10 * SERVED_SECONDS:
        raise AssertionError(f"only {segments} monitor segments in {elapsed:.1f} s")
    if pure_audio == "flac":
        flac_segments(np, kept, fed, segments)
    return {"launches": launches, "segments": segments}


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


def check_cavlc_tiers(torch, np, dev):
    """The CAVLC tiers on the card's host give the same bytes: the native
    C++ encoder and the numpy one, on 560x350 pictures of the cameras'
    content scaled on the card."""
    from mixlab_tpu_torch.av.codecs import MONITOR_PICTURE
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
    units = {name: [enc.encode_frame(pic) for pic in pics]
             for name, enc in (("native", NativeCavlcIntraEncoder(30)),
                               ("numpy", FastCavlcIntraEncoder(30)))}
    if units["native"] != units["numpy"]:
        raise AssertionError("the native and numpy CAVLC tiers disagree")
    log(f"CAVLC tiers: native and numpy give the same bytes for {len(pics)} pictures")


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
        rc = proc.wait(15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader_thread.join(timeout=5)
    with ProjectBase(path) as base:
        saved = base.read_workspace()
    log(f"served subprocess: GET / 200 with the port's index.html, one op, SIGTERM -> exit "
        f"{rc} within 15 s; workspace row "
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
BATCH_EQ = ((1, 2, 32, 133, 1024), (8192, 12_000, 44_100, 96_000))
# the envelope's S: whole tiles of 4,096 (32,768), a last tile of one
# sample (4,097), cut ones; its B: these and where the plan switches form
BATCH_ENV = ((1, 2, 32, 1024), (4_097, 12_000, 32_768, 48_000, 96_000))
RESAMPLE_ATOL = 2e-6
MIX_ATOL = 2e-4          # tests/test_multichip.py:29
SERVED_SLOTS = 1024
SERVED_CLIENTS = 16
SERVED_SECONDS = 5.0


def kernel_launches(torch, fn, n=10):
    """(kernel launches per call, kernel name) from the profiler over ``n``
    calls of ``fn``: the launches are the CUDA runtime's launch calls traced
    on the host (the device rows of a profile in this process have come up
    short), and every device kernel seen must be the one named.  Where
    three profiles in a row recorded no device row at all but traced the
    launch calls, the name is None ("not recorded"): the launches a call
    still come from the host."""
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
        return launches / n, None
    if len(rows) != 1 or rows[0].count > n:
        raise AssertionError(f"device kernels seen: {[(e.key[:60], e.count) for e in rows]}")
    # without traced launch calls, the device rows count them
    return (launches or rows[0].count) / n, rows[0].key


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


def _close(torch, got, want, tol):
    err = (got.float() - want.float()).abs()
    return bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all()), err.max().item()


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


def batched_kernels(torch, np, dev):
    """(a) the batched eq and envelope kernels against their batched twins
    at every B x S of the lists, 3 carried blocks; one device launch per
    call for every B."""
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
                per_call, name = kernel_launches(
                    torch, lambda: eqc.eq_cascade_batched(x, xd, pk, gains, *f))
                if per_call != 1:
                    raise AssertionError(f"batched eq B={B} S={S}: {per_call} device launches "
                                         "a call")
                launch = f", 1 device launch a call ({name})"
            log(f"batched eq kernel vs twin B={B} S={S} ({chosen}): ok (3 blocks){launch}")
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
                per_call, name = kernel_launches(
                    torch, lambda: envc.envelope_block_batched(xs[0], sk, params, 1000 / 48_000))
                if per_call != 1:
                    raise AssertionError(f"batched envelope B={B} S={S}: {per_call} device "
                                         "launches a call")
                launch = f", 1 device launch a call ({name})"
            log(f"batched envelope kernel vs twin B={B} S={S} ({chosen}): ok (dense, sparse; "
                f"3 blocks){launch}")

    return worst


def fleet_path(torch, np, dev):
    """(b) the fleet: the flagship at 48 kHz in 15-tick blocks, N = 1,024
    sessions with their own params, counts set to 0 just before a block and
    read just after (one eq launch, one envelope launch); four slots against
    single-patch renders on the card."""
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(FLEET_TICKS)
    spb = block.n_samples(cfg)
    counters = launch_counters()
    n = FLEET_N[0]
    wss = fleet_workspaces(n)
    fleet = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, device=str(dev))
    fleet.run_block(0)  # first block: allocations
    torch.cuda.synchronize()
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
    return launches


def fleet_served(torch, np, dev, ticks_a_block=FLEET_TICKS):
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
        eng = FleetEngine(template, SERVED_SLOTS, cfg, block_ticks=ticks_a_block,
                          device=str(dev))
        kernel = "region" if eng.fleet.patch._mega else "eq_cascade"
        log(f"fleet serving: FleetEngine of {SERVED_SLOTS} slots, {ticks_a_block}-tick blocks "
            f"({kernel} kernel)")
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
            tick0 = eng.tick
            res = await asyncio.gather(*(client(port, k) for k in range(SERVED_CLIENTS)))
            launches = {name: fn.launches for name, fn in counters.items()}
            await app.shutdown()
            return res, launches, eng.tick - tick0

        eng.start()
        try:
            results, launches, ticks = asyncio.run(go())
        finally:
            eng.stop()
        faults.check("fleet serving")
    blocks = ticks // ticks_a_block
    log(f"fleet serving: {SERVED_CLIENTS} clients for {SERVED_SECONDS:g} s, {blocks} blocks, "
        f"launches {launches}")
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
    return launches


def stems_path(torch, np, dev):
    """(d) stems: ``stem_parallel_step`` with 16 stems of the flagship
    (counts set to 0 just before and read just after: one eq launch for all
    16); the resampler on the card against ``resample_block_np`` with the
    precision guard active."""
    from mixlab_tpu_torch.dsp import resampler as rs
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
    return launches


def batched_paths(torch, np, dev):
    """Phase 16: -> (errors, {path: launches})."""
    errs = batched_kernels(torch, np, dev)
    paths = {"fleet": fleet_path(torch, np, dev),
             "fleet_served": fleet_served(torch, np, dev),
             "stems": stems_path(torch, np, dev)}
    return errs, paths


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


def region_edges(torch, np, dev):
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
    (``peaks_exact``); the flagship's plan one launch a call and no memset
    at every B (``launches_a_call``).  -> the max abs err."""
    from mixlab_tpu_torch.engine import region_cuda as rc
    from mixlab_tpu_torch.engine.region_graph import _partition

    g = torch.Generator(device=dev).manual_seed(20)
    plans = region_plans(torch)
    resident = rc.resident_tiles(dev.index or 0)
    worst = 0.0
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
                    ops, pf = region_inputs(torch, g, plan, row, B, S, dev, shared,
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
                            errs.append(max(rows_err(torch, g, w) for g, w in zip(got, want)))
                            staps = staps and peaks_exact(torch, plan, part, got[0], got[1])
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
                    f"plan: {chosen}; forms {['the plan' if f is None else f for f in forms]}), "
                    f"3 blocks: max abs err {err:.3e}, scalar taps exact {staps}"
                    + (", 1 launch a call, no memset" if key == "flagship" and not shared
                       else ""))
                if not (err <= REGION_ATOL and staps):
                    raise AssertionError(f"batched region {name} B={B} S={S}: max err {err}, "
                                         f"scalar taps exact {staps}")
                worst = max(worst, err)
    return worst


def region_fleet(torch, np, dev):
    """(b) the fleet at 48 kHz with per-instance params on the region program
    (16 ticks: N = 1,024 and 8,192; 48 ticks: N = 1,024) beside the same
    fleet on the regular batched program (``mega=False``): one block's
    launches with the counts set to 0 just before and read just after
    (region 1, eq 0, envelope 1: a batch takes it at any length), taps and state
    within REGION_ATOL of the regular fleet's over 2 blocks, four slots
    within REGION_ATOL of single-patch region renders.  -> {path: launches}."""
    from mixlab_tpu_torch.convert import tree_leaves
    from mixlab_tpu_torch.engine.compiler import compile_patch
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.engine.region_graph import _partition
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, counters = EngineConfig(sample_rate=48_000), launch_counters()
    paths = {}
    for ticks, ns in zip(REGION_FLEET_TICKS, (FLEET_N, FLEET_N[:1])):
        block = BlockSpec(ticks)
        spb = block.n_samples(cfg)
        parts = len(_partition(spb))
        for n in ns:
            wss = fleet_workspaces(n)
            fleets = {"region": Fleet.build(wss[0], n, cfg, block, per_instance_params=wss,
                                            device=str(dev)),
                      "regular": Fleet.build(wss[0], n, cfg, block, per_instance_params=wss,
                                             device=str(dev), mega=False)}
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
            log(f"region fleet N={n} at {ticks} ticks: taps vs the regular fleet max err "
                f"{err:.3e}, state "
                f"{st_err:.3e}; four slots vs single-patch region renders {slot_err:.3e} "
                f"(2 blocks, atol {REGION_ATOL})")
            if not max(err, st_err, slot_err) <= REGION_ATOL:
                raise AssertionError(f"region fleet N={n}: vs regular {err} / {st_err}, vs "
                                     f"single renders {slot_err}")
            del fleets, taps, ref
            torch.cuda.empty_cache()
    return paths


def batched_region(torch, np, dev):
    """Phase 20: -> (max abs err, {path: launches})."""
    err = region_edges(torch, np, dev)
    paths = region_fleet(torch, np, dev)
    paths["fleet_served_16"] = fleet_served(torch, np, dev,
                                            ticks_a_block=REGION_FLEET_TICKS[0])
    paths["mesh_fleet_16"] = mesh_fleet(torch, np, dev, ticks=REGION_FLEET_TICKS[0])
    return err, paths


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
        same = all(same_bits(torch, a, b) if a.is_floating_point() else torch.equal(a, b)
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
        ops, pf = region_inputs(torch, g, rplan, row, B, S, dev)
        return [*ops, pf, rand(g, B, rplan.n_ef, lo=-0.1, hi=0.1)]

    def region_check(got, want):
        err = max(rows_err(torch, a, b) for a, b in zip(got, want))
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


def lookback_numbers(torch, np, dev) -> dict:
    """Phase 22: for each look-back kernel, the captured launch replayed
    (``lookback_replays``) and two threads on one stream
    (``lookback_threads``).  -> {kernel: max error}."""
    errs = {}
    for kernel in LOOKBACK_SHAPES:
        e_graph = lookback_replays(torch, dev, kernel)
        e_threads = lookback_threads(torch, dev, kernel)
        errs[kernel] = max(e_graph, e_threads)
        log(f"look-back {kernel}: a captured launch at {LOOKBACK_SHAPES[kernel]} "
            f"replayed {LOOKBACK_REPLAYS} times with new inputs, an eager call after each: each "
            f"the twin's (max err {e_graph:.3e}), every launch counted on the device; 2 threads "
            f"x {LOOKBACK_THREAD_CALLS} calls on one stream: each the twin's (max err "
            f"{e_threads:.3e}), every launch counted")
    return errs


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


def mesh_stems(torch, np, dev):
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
                _, master = fn(*args)
                torch.cuda.synchronize()
                launches = _read(counters)
                want = master if want is None else want
                err = (master.to(want.device) - want).abs().max().item()
                err_twin = (master.cpu() - twin).abs().max().item()
                log(f"mesh stems: {n_stems} stems over {name}, {ticks}-tick blocks: "
                    f"master vs the twins' (one CPU entry) max err {err_twin:.3e}, vs the "
                    f"one-entry card mesh's {err:.3e} (atol {MIX_ATOL}), launches {launches}")
                if not (err <= MIX_ATOL and err_twin <= MIX_ATOL
                        and bool(torch.isfinite(master).all())
                        and launches[kernel] == len(mesh) and launches[other] == 0
                        and launches["envelope"] == len(mesh)):
                    raise AssertionError(f"mesh stems over {name}: err {err}, vs the twins "
                                         f"{err_twin}, launches "
                                         f"{launches} (want {len(mesh)} a kernel)")
                paths[f"mesh_stems_{key}_{ticks}"] = launches
    return paths


def mesh_fleet(torch, np, dev, ticks=FLEET_TICKS):
    """(b) the fleet as phase 16 (b) runs it, N = 8,192 sessions with their
    own params in 15-tick blocks (phase 20 (d): 16, on the region program),
    over a 4-entry mesh on the card: one launch a shard a block of the block
    program's kernel (the batched eq's, or the region's where it was chosen;
    counts set to 0 just before the block, read just after), every session's
    taps equal to the one-device fleet's bit for bit over two carried blocks
    where both run the kernel in the same form, else within REGION_ATOL."""
    from mixlab_tpu_torch.engine import region_cuda
    from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu_torch.parallel import make_mesh
    from mixlab_tpu_torch.parallel.fleet import Fleet

    cfg, block = EngineConfig(sample_rate=48_000), BlockSpec(ticks)
    spb, n = block.n_samples(cfg), FLEET_N[-1]
    counters = launch_counters()
    wss = fleet_workspaces(n)
    one = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, device=str(dev))
    mesh = make_mesh(MESH_FLEET_SHARDS, axis="fleet", devices=[str(dev)])
    four = Fleet.build(wss[0], n, cfg, block, per_instance_params=wss, mesh=mesh, axis="fleet")
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
    log(f"mesh fleet: N={n} over {MESH_FLEET_SHARDS} shards of {dev}, {ticks}-tick blocks: "
        f"taps equal bit for bit {same} (max err {worst:.3e}; the kernel in the same form on "
        f"both sides {same_form}), launches a block {launches}")
    if not (same if same_form else worst <= REGION_ATOL):
        raise AssertionError(f"mesh fleet taps differ from the one-device fleet's: {worst}")
    del one, four
    torch.cuda.empty_cache()
    return launches


def mesh_blend(torch, np, dev):
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
    log(f"mesh blend: {list(BLEND_SIZES)} over 4 shards of {dev}, fades {BLEND_FADES}: "
        f"equal to the twin, one crossfade launch a shard")
    return launches


def mesh_engine(torch, np, dev):
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
    log(f"mesh engine: {len(taps[0])} blocks of 2 ticks over 2 shards of {dev}, a saw "
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


def mesh_processes(torch, np, dev):
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
        for proc, (out, err) in zip(procs, outs):
            if proc.returncode != 0:
                raise AssertionError(f"mesh worker ({backend}) exited {proc.returncode}:\n"
                                     + err[-3000:])
        res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        rel = max(abs(r["checksum"] - want) / max(1.0, abs(want)) for r in res)
        log(f"mesh processes ({backend}): 2 processes x {res[0]['mesh']} = "
            f"{res[0]['size']} shards, 8 stems: checksum {res[0]['checksum']:.6f} vs one "
            f"process's 4-entry mesh {want:.6f}, rel err {rel:.3e} (limit {CHECKSUM_RTOL}), "
            f"rms {res[0]['rms']:.4f}, launches {[r['launches'] for r in res]}")
        if not rel <= CHECKSUM_RTOL or not res[0]["rms"] > 0.01 \
                or res[0]["checksum"] != res[1]["checksum"]:
            raise AssertionError(f"mesh processes ({backend}): {res} vs {want}")
        for r in res:
            if r["launches"][kernel] != 2 or r["launches"][other]:
                raise AssertionError(f"mesh worker launched {r['launches']} (want {kernel} 2)")
        paths[f"mesh_processes_{backend}"] = res[0]["launches"]
    return paths


def mesh_controller(torch, np, dev, tmp: Path):
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
        status, body = await http_call(url + "/workspaces/w", "POST", timeout=180.0)
        if status != 200:
            raise AssertionError(f"placement answered {status}: {body[:300]!r}")
        placed = json.loads(body)
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
        status, body = await http_call(url + "/migrate/w", "POST",
                                       json.dumps({"to": other}).encode(), timeout=180.0)
        if status != 200:
            raise AssertionError(f"migration answered {status}: {body[:300]!r}")
        moved = json.loads(body)
        status, blob = await http_call(moved["url"] + "/_checkpoint", timeout=30.0)
        route = json.loads((await http_call(url + "/route/w"))[1])
        return placed, moved, route, before, decode_checkpoint(blob)

    try:
        procs.append(subprocess.Popen(roles[0], cwd=ROOT, start_new_session=True,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
        placed, moved, route, before, after = asyncio.run(drive())
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
    log(f"fleet controller: placed on {placed['host']}, migrated to "
        f"{moved['host']} (restored {moved.get('restored')}), route "
        f"{route['host']}; tick {before['tick']} before, {after['tick']} after; the EqThree's "
        f"state vs the checkpoint continued on the card: max err {worst:.3e} (EQ_TOL); exits "
        f"{rcs[::-1]}")
    if not (moved.get("restored") is True and route["host"] == moved["host"] != placed["host"]
            and after["tick"] >= before["tick"] > 0 and len(ref_state) == len(after["dsp_state"])
            and ok and any(np.abs(w).max() > 0 for w in after["dsp_state"])
            and rcs == [0, 0, 0]):
        raise AssertionError(f"fleet controller: {placed}, {moved}, {route}, ticks "
                             f"{before['tick']} -> {after['tick']}, state err {worst}, exits {rcs}")


def scale_out(torch, np, dev, tmp: Path):
    """Phase 19: -> {path: launches}."""
    paths = mesh_stems(torch, np, dev)
    paths["mesh_fleet"] = mesh_fleet(torch, np, dev)
    paths["mesh_blend"] = mesh_blend(torch, np, dev)
    paths["mesh_engine"] = mesh_engine(torch, np, dev)
    paths.update(mesh_processes(torch, np, dev))
    mesh_controller(torch, np, dev, tmp)
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
    """Ticks, the fewest ticks in any second of the window, and ticks
    without exactly one crossfade launch."""
    t0 = ticks[0][0] if ticks else 0.0
    per_s = [sum(1 for x in ticks if t0 + s <= x[0] < t0 + s + 1) for s in range(int(seconds))]
    return {"ticks": len(ticks), "min_a_s": min(per_s, default=0),
            "missed": sum(n != 1 for *_, n in ticks)}


def threaded_storm(torch, np, dev, pool):
    """The threaded realtime engine (flagship, 1080p and 720p cameras fed at
    60 fps by a feeder thread, the VideoMixer, the monitor pipe read by a
    thread) for a quiet window, then a storm window of structural ops and
    fader edits.  -> the windows' stats, each structural op's
    seconds to its adoption, stale adoptions, whether the final program is
    the final workspace's, the launches of both windows."""
    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine.compiler import compile_patch

    eng, ids, sid = realtime_engine(str(dev), ("e-cam1", "e-cam2"))
    cams = Cameras(("e-cam1", "e-cam2"))
    pipe = eng.monitor_pipe(ids["monitor"])
    probe = EditProbe(eng)
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


def edit_storm(torch, np, dev):
    """(a) ``threaded_storm`` as the engine runs."""
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    r = threaded_storm(torch, np, dev, pool)
    quiet, storm = r["quiet"], r["storm"]
    log(f"edit path (a): quiet window {quiet}, storm window {storm} "
        f"({EDIT_WINDOW_S:.0f} s each); {r['structural']} structural ops "
        f"({EDIT_STRUCT_HZ}/s) and {r['faders']} fader edits ({EDIT_FADER_HZ}/s); "
        f"{r['adoptions']} adoptions, {r['stale']} of a stale program; final program = the "
        f"final workspace's: {r['final_ok']}; launches {r['launches']}")
    if (quiet["min_a_s"] < EDIT_MIN_TICKS_A_S or storm["min_a_s"] < EDIT_MIN_TICKS_A_S
            or r["stale"] or not r["final_ok"] or quiet["missed"] or storm["missed"]
            or not np.isfinite(max(r["to_adopt"]))):
        raise AssertionError(f"edit path (a): quiet {quiet}, storm {storm}, stale adoptions "
                             f"{r['stale']}, final program matches {r['final_ok']}, op to "
                             f"adoption max {max(r['to_adopt'])}")
    return r["launches"]


def edit_mesh(torch, np, dev):
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
        f"threaded: {len(blocks)} blocks, region launches a block on the engine "
        f"thread {[n for _, n, _ in blocks]}; {len(during)} blocks while the warm (held "
        f"{EDIT_MESH_HOLD_S} s) ran, its launches on the compile thread "
        f"{warm.get('launches')}; {len(after)} blocks after the adoption; launches "
        f"{launches}")
    if not (after and len(during) >= 1 and all(n == 2 for _, n, _ in blocks)
            and warm.get("launches") == 2 and launches["eq_cascade"] == 0):
        raise AssertionError(f"edit path (b): blocks {[(n, b is first) for _, n, b in blocks]}, "
                             f"warm {warm}, launches {launches}")
    return launches


def edit_depth(torch, np, dev):
    """(c) ``pipeline_depth`` 0, 1 and 2 on the realtime engine in direct
    drive for EDIT_DEPTH_TICKS ticks on the same ingest: the routed Monitor
    items (audio and composite) identical to depth 0's, each d ticks later,
    ``flush_inflight`` routing the last d."""
    pool = [cam_frames(torch, np, dev, i) for i in range(8)]
    counters = launch_counters()
    base, paths = None, {}
    for d in EDIT_DEPTHS:
        names = (f"p{d}-cam1", f"p{d}-cam2")
        eng, ids, _ = realtime_engine(str(dev), names, pipeline_depth=d)
        cams = Cameras(names)
        pipe = eng.monitor_pipe(ids["monitor"])
        items = []
        try:
            _reset(counters)
            for tick in range(EDIT_DEPTH_TICKS):
                cams.publish(tick, pool[tick % len(pool)])
                eng.tick_once()
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
    log(f"edit path (c) pipeline_depth {'/'.join(map(str, EDIT_DEPTHS))}, {EDIT_DEPTH_TICKS} "
        f"ticks in direct drive: routed monitor audio and composites identical to "
        f"depth 0's, each d ticks later; launches " + ", ".join(
            f"{paths[f'edit_depth_{d}']['crossfade']}" for d in EDIT_DEPTHS) + " crossfades")
    return paths


def edit_codecs(torch, np, dev):
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
    log(f"edit path (d) codecs: libavcodec shim available {available}"
        + ("" if available else f" ({' '.join((reason or '').split())[:240]})") + f"; codec tier {tier}")
    if not available:
        if tier == "shim":
            raise AssertionError("the codec tier is the shim, which is unavailable")
        return
    units, _, dcr = media_pictures(torch, np, dev)
    blob, ref, _ = media_mp4(np, units, dcr)
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
    log(f"edit path (d) the phase 17 clip through _run_shim on {dev}: "
        f"{len(video)} pictures, {same} of the first {len(want)} equal to the port's decoder's; "
        f"{len(pcm)} samples within {err:.3e} of the AAC decoder's (atol {MEDIA_PCM_ATOL})")
    if taken != [1] or same != len(want) or len(pcm) < RT_RATE or err > MEDIA_PCM_ATOL:
        raise AssertionError(f"edit path (d): _run_shim taken {taken}, {same} pictures equal, "
                             f"{len(pcm)} samples, err {err}")


def edit_path(torch, np, dev):
    """Phase 21: -> {path: launches}."""
    paths = {"edit_storm": edit_storm(torch, np, dev),
             "edit_mesh": edit_mesh(torch, np, dev)}
    paths.update(edit_depth(torch, np, dev))
    edit_codecs(torch, np, dev)
    return paths


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
DECODE_PY_FRAMES = 2      # 1080p frames on the Python tier (seconds each)
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
    decoder configuration record)."""
    from mixlab_tpu_torch.av.h264enc import PureH264Stream, nal
    from mixlab_tpu_torch.video.frame import Picture, PictureSettings
    from mixlab_tpu_torch.video.pattern import pattern_picture

    w, h = MEDIA_SIZE
    stream = PureH264Stream(PictureSettings(w, h), fps=MEDIA_FPS, mode="cavlc", qp=MEDIA_QP)
    units = []
    for i in range(MEDIA_DISTINCT):
        kind = "bars" if i % 2 == 0 else "gradient"
        pic = Picture(PictureSettings(w, h),
                      pattern_picture(kind, w, h, 7 * i, device=dev).to_numpy())
        stream.feed(pic)
        ((_key, avcc),) = stream.poll_access_units()
        units.append(avcc)
    sc = b"\x00\x00\x00\x01"
    annexb = sc + nal(7, stream.sps) + sc + nal(8, stream.pps) + b"".join(
        sc + u[4:] for u in units)
    return units, annexb, stream.dcr


def media_decode(torch, np, dev, annexb: bytes) -> list:
    """Phase 17 (a): the native decode tier against the Python tier,
    bit-exact, on the committed x264 streams (``tests/data/h264/``: CAVLC
    and CABAC, P and B, the 8x8 transform) and on the port's 1080p CAVLC
    intra stream.  -> the 1080p stream's frames decoded on the native tier."""
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
    frames = _decode_all(annexb)
    sc = b"\x00\x00\x00\x01"
    head = sc.join(annexb.split(sc)[:3 + DECODE_PY_FRAMES])  # "", SPS, PPS, the IDRs
    with _PythonDecodeTier():
        py = _decode_all(head)
    if len(frames) != MEDIA_DISTINCT or not _same_frames(np, py, frames[:len(py)]):
        raise AssertionError("the 1080p CAVLC intra stream: the native decode tier disagrees "
                             "with the Python tier")
    log(f"media decode: native tier == Python tier, bit-exact, on {', '.join(names)} "
        f"and the port's 1080p CAVLC intra stream ({len(frames)} frames, {DECODE_PY_FRAMES} "
        f"on the Python tier)")
    return frames


def media_mp4(np, units, dcr):
    """The 1920x1080, 30 fps, 10 s MP4 with 44.1 kHz stereo AAC-LC, made here
    by the port's own encoders and fMP4 mux: the access units cycled, and
    10 s of a seeded tone through the AAC codec process.  -> (bytes, the
    AAC decoder's PCM of the track, the raw AAC granules)."""
    from fractions import Fraction

    from mixlab_tpu_torch.av import mp4
    from mixlab_tpu_torch.av.aac import AudioSpecificConfiguration
    from mixlab_tpu_torch.av.aacdec import AacLcDecoder
    from mixlab_tpu_torch.av.codecs import PureAacStream
    from mixlab_tpu_torch.av.encode_stream import f32_to_i16
    from mixlab_tpu_torch.utils.mtime import MediaDuration

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
    ref = np.concatenate([dec.decode_raw(f[7:], asc.sampling_frequency_index)
                          for f in frames]).astype(np.float32)
    return bytes(blob), ref, [f[7:] for f in frames]


def media_session(torch, np, dev, tmp: Path, units, dcr, pictures, mp4=None) -> dict:
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
        out) against the AAC decoder's PCM of the track, within 1e-4.

    -> the window's launches, its video ticks and ticks."""
    import asyncio

    from mixlab_tpu_torch import protocol as p
    from mixlab_tpu_torch.engine import engine as engine_mod
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.project import open_or_create
    from mixlab_tpu_torch.flagship import realtime_video_ops
    from mixlab_tpu_torch.server.app import run_server
    from mixlab_tpu_torch.video.blend import crossfade_torch

    blob, ref_pcm, _ = mp4 or media_mp4(np, units, dcr)
    log(f"media mp4: {MEDIA_SIZE[0]}x{MEDIA_SIZE[1]} {MEDIA_FPS} fps {MEDIA_SECONDS} s, "
        f"{MEDIA_SECONDS * MEDIA_FPS} H.264 samples ({MEDIA_DISTINCT} distinct, cycled) and "
        f"{len(ref_pcm) // 1024} AAC-LC frames, {len(blob)} bytes")
    cam = ("media-cam1",)
    pool = [cam_frames(torch, np, dev, i, sizes=CAM_SIZES[:1]) for i in range(4)]
    counters = launch_counters()
    ref_y = {pic[1].tobytes(): i for i, pic in enumerate(pictures)}
    state = {"window": None, "check": None, "played": []}

    class CountingQueue(queue.Queue):
        """The feed's audio queue, counting the samples taken from it."""
        taken = 0

        def get_nowait(self):
            chunk = super().get_nowait()
            self.taken += len(chunk)
            return chunk

    class CountedFeed(engine_mod.MediaSourceFeed):
        """The MediaSource's feed with the samples each tick played recorded
        (underrun gaps left out)."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.queue = CountingQueue(maxsize=self.queue.maxsize)

        def fill_tick(self, n):
            carry0, taken0 = (0 if self.carry is None else len(self.carry)), self.queue.taken
            out = super().fill_tick(n)
            filled = (carry0 + self.queue.taken - taken0
                      - (0 if self.carry is None else len(self.carry)))
            state["played"].append(out[:filled].copy())
            return out

    with _PureTier(), ThreadFaults() as faults:
        proj = open_or_create(tmp / "media.mixlab", EngineConfig(sample_rate=RT_RATE),
                              block_ticks=1, device=str(dev))
        eng = proj.engine
        media_id = proj.upload_media("clip.mp4", "video/mp4", [blob])
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

            def run_window():
                win = {"armed": False, "open": False, "video": 0, "items": 0, "launches": None}
                state["window"] = win

                def arm():
                    win["armed"] = True

                segments, elapsed = asyncio.run_coroutine_threadsafe(monitor_segments(
                    port, session["socket_id"], MEDIA_WINDOW_S, arm), loop).result(
                        MEDIA_WINDOW_S + 60)
                win["armed"] = False
                deadline = time.monotonic() + 10
                while win["launches"] is None and time.monotonic() < deadline:
                    time.sleep(0.01)
                state["window"] = None
                if win["launches"] is None:
                    raise AssertionError("the media window did not close on the engine thread")
                log(f"media playback window: {win['items']} ticks, {win['video']} with video, "
                    f"{segments} monitor segments in {elapsed:.3f} s; launches "
                    f"{win['launches']}")
                return {"launches": win["launches"], "video": win["video"],
                        "ticks": win["items"]}

            first = run_window()

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
            # the PCM check below reads at least MEDIA_WINDOW_S of played audio,
            # and the engine plays media slower than its clock
            deadline = time.monotonic() + 60
            while sum(map(len, state["played"])) < RT_RATE * MEDIA_WINDOW_S and \
                    time.monotonic() < deadline:
                time.sleep(0.1)
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
            proj.close()
        faults.check("media playback")
    played = np.concatenate(state["played"])
    n = min(len(played), len(ref_pcm))
    pcm_err = float(np.abs(played[:n] - ref_pcm[:n]).max())
    log(f"media playback checks: {MEDIA_CHECK_TICKS} composites at fader 0 "
        f"are decoded pictures exactly ({len(shown)} distinct); at fader {RT_FADER} max "
        f"{lsb} LSB from the CPU twin (limit {COMPOSITE_LSB}); played PCM {n} samples, max abs "
        f"err {pcm_err:.3e} against the AAC decoder's (atol {MEDIA_PCM_ATOL})")
    if n < RT_RATE * MEDIA_WINDOW_S or pcm_err > MEDIA_PCM_ATOL:
        raise AssertionError(f"the played PCM ({n} samples) is {pcm_err:.3e} from the AAC "
                             "decoder's")
    if first["launches"]["crossfade"] != first["video"] or first["video"] < 60:
        raise AssertionError(f"the media window launched the crossfade kernel "
                             f"{first['launches']['crossfade']} times in {first['video']} "
                             "video ticks")
    return first


def media_imdct(torch, np, dev):
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
    log(f"media imdct: imdct_batch_torch 64 x 1024 on {dev} vs numpy max abs err "
        f"{err:.3e} (atol {IMDCT_ATOL}); refused under TF32: {refused}")
    if err > IMDCT_ATOL or not refused:
        raise AssertionError(f"imdct_batch_torch: err {err:.3e}, refused under TF32 {refused}")


def media_paths(torch, np, dev, tmp: Path) -> dict:
    """Phase 17: (a) the decode tiers, (b) the served playback, (c) the
    IMDCT; then phase 18 on the same 1080p stream and AAC granules.
    -> {"media": (b)'s launches, "ingest": phase 18 (a)'s launches}."""
    units, annexb, dcr = media_pictures(torch, np, dev)
    frames = media_decode(torch, np, dev, annexb)
    mp4 = media_mp4(np, units, dcr)
    launches = media_session(torch, np, dev, tmp, units, dcr, frames, mp4)["launches"]
    media_imdct(torch, np, dev)
    ingest = ingest_session(torch, np, dev, tmp, units, dcr, frames, mp4[2])["launches"]
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
        return self.recv.read_video()

    def close(self):
        self.recv.close()


def ingest_session(torch, np, dev, tmp: Path, units, dcr, pictures, raws) -> dict:
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
      (b) broadcast: camera A turns to the split picture and a client op
          sets the fader to 1 (the composite is camera A's picture); once
          the mixer holds it, a client op connects the StreamOutput to
          ``rtmp://127.0.0.1:<port>/out`` on the same server; its Live
          indication must come over the session socket; in
          BROADCAST_SECONDS, ``out``'s pictures arrive on the card at
          1120x700, each the split picture's bright and dark halves (or
          black, where camera A's picture expired in the mixer; the split
          picture in most), and its audio holds the 440 Hz tone within 15
          Hz;
      (c) Icecast: a 48 kHz WAV SOURCE to ``radio`` reaches the feed at
          44.1 kHz, equal within 2e-6 to ``resample_block_np`` of the whole
          file with the listener's i16 conversion.

    Any exception in a server, codec, IO or engine thread, any ERROR log and
    any decode failure the ingest counts fails the phase.  -> (a)'s
    launches, video ticks and ticks."""
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
    state = {"window": None, "check": None}

    class RecordedFeed(engine_mod.StreamInputFeed):
        """A StreamInput's feed with the engine thread's reads recorded by
        mountpoint: the audio frames and the first pictures released."""

        def set_recv(self, recv):
            if recv is not None:
                self.rec = rec.setdefault(recv.channel_name, {"audio": [], "pictures": []})
                recv = _RecordedRecv(recv, self.rec)
            super().set_recv(recv)

        def fill_tick(self, t, n):
            pcm, video = super().fill_tick(t, n)
            r = getattr(self, "rec", None)
            if r is not None and video is not None and \
                    len(r["pictures"]) < (240 if self.recv.channel_name == "out" else 4):
                r["pictures"].append(video)
            return pcm, video

    geo = p.WindowGeometry()
    on_card = torch.device(dev.type, torch.cuda.current_device() if dev.index is None
                           else dev.index) if dev.type == "cuda" else dev
    with _PureTier(), ThreadFaults() as faults:
        proj = open_or_create(tmp / "ingest.mixlab", EngineConfig(sample_rate=RT_RATE),
                              block_ticks=1, device=str(dev))
        eng = proj.engine
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
                    elif win["open"] and win["launches"] is None:
                        win["video"] += item[2] is not None
                        win["items"] += 1
                        if not win["armed"]:
                            win["launches"] = {k: fn.launches for k, fn in counters.items()}
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
            res = {"launches": win["launches"], "video": win["video"], "ticks": win["items"]}
            log(f"ingest window: {res['ticks']} ticks, {res['video']} with video, "
                f"{segments} monitor segments in {elapsed:.3f} s; launches {res['launches']}")
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
            n0 = len(rec["out"]["audio"])
            time.sleep(BROADCAST_SECONDS)
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
    log(f"ingest checks: {INGEST_CHECK_TICKS} composites at fader 0 are decoded "
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
    log(f"broadcast: indications {seen}; out mountpoint {sorted(sizes)}, "
        f"{len(pics)} pictures: {n_split} the split picture, {n_black} black; the last's mid "
        f"rows bright half {bright:.1f}, dark half {dark:.1f}; tone peak {peak:.2f} Hz over "
        f"{len(body)} samples")
    if sizes != {(1120, 700)} or n_split + n_black < len(pics) or 2 * n_split <= len(pics) \
            or abs(peak - 440.0) >= BROADCAST_TONE_HZ:
        raise AssertionError(f"the broadcast came back as {sorted(sizes)}, {n_split} of "
                             f"{len(pics)} pictures split ({n_black} black), tone {peak:.2f} Hz")

    # (c) the Icecast SOURCE
    m = min(len(radio), len(want_wav))
    radio_err = float(np.abs(radio[:m].astype(np.float32) - want_wav[:m]).max()) / 32768.0 \
        if m else float("inf")
    status_line = status.split(b"\r\n")[0]
    log(f"icecast: {status_line!r}; {len(radio)} samples at {RT_RATE} Hz "
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


def synth_example(torch, np, tmp: Path, sr: int) -> dict:
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
    pcm = example.main([str(tmp / f"synth_{sr}.wav"), *args, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    cpu = example.main([str(tmp / f"synth_cpu_{sr}.wav"), *args, "--device", "cpu"])
    err = int(np.abs(pcm.astype(np.int32) - cpu.astype(np.int32)).max())
    rms = float(np.sqrt(((pcm.astype(np.float64) / 32767.0) ** 2).mean()))
    log(f"synth example {sr} Hz: {EXAMPLE_SECONDS} s on cuda, "
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


def fleet_demo() -> None:
    """``examples/torch_fleet_demo.py`` as a subprocess (its workers on the
    card), in a session of its own: exit 0 within ``FLEET_DEMO_TIMEOUT``,
    the migrated line says the runtime state was restored, and no process
    of its session is left."""
    import os
    import signal

    proc = subprocess.Popen([sys.executable, str(ROOT / "examples" / "torch_fleet_demo.py")],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=FLEET_DEMO_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
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
    log(f"fleet demo: exit {proc.returncode}; "
        f"{len(placed)} placed; {migrated[0] if migrated else 'no migrated line'}; "
        f"processes left in its session: {left}")
    if proc.returncode != 0 or left:
        raise AssertionError(f"the fleet demo exited {proc.returncode}, processes left "
                             f"{left}:\n{out[-2000:]}\n{err[-2000:]}")
    if len(placed) != 3 or len(migrated) != 1 or \
            not migrated[0].endswith("(runtime state restored: True)"):
        raise AssertionError(f"the fleet demo did not restore the migrated state:\n{out[-2000:]}")


def last_surface(torch, np, dev, tmp: Path) -> dict:
    """Phase 23: (a) the synth example at 48 and 44.1 kHz; (b) the served
    realtime workspace's Monitor with ``MIXLAB_PURE_AUDIO=flac``; (c) the
    fleet demo.  -> the launches of (a)'s paths and of the FLAC session's
    window."""
    paths = {f"example_{sr}": synth_example(torch, np, tmp, sr) for sr in (48_000, 44_100)}
    (tmp / "flac").mkdir()
    paths["served_flac"] = served_session(torch, np, dev, tmp / "flac",
                                          pure_audio="flac")["launches"]
    fleet_demo()
    return paths


PHASES_ALONE = {
    "region": lambda torch, np, dev, tmp: batched_region(torch, np, dev),
    "lookback": lambda torch, np, dev, tmp: lookback_numbers(torch, np, dev),
    "edit": lambda torch, np, dev, tmp: edit_path(torch, np, dev),
    "last_surface": last_surface,
}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="The port's checks on one NVIDIA GPU.")
    parser.add_argument("--phase", choices=sorted(PHASES_ALONE),
                        help="run this phase alone after the build")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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

    kernels.load()
    log(f"kernels built and loaded: {kernels.library_path().name}")
    build_log = kernels.library_path().with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())
    if args.phase:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            log(json.dumps(PHASES_ALONE[args.phase](torch, np, dev, Path(tmp)),
                           default=str))
        return 0

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
        paths["composite"] = composite_path(torch, np, dev)
        paths["profile"] = profile_path(torch, dev)
        paths.update(edit_path(torch, np, dev))
        # phase 16 before phase 15: after the served session's threads the
        # profiler in this process has recorded no device kernel
        batched_errs, batched_launches = batched_paths(torch, np, dev)
        paths.update(batched_launches)
        for key, err in batched_errs.items():
            errs[key] = max(errs[key], err)
        err, region_launches = batched_region(torch, np, dev)
        errs["region"] = max(errs["region"], err)
        paths.update(region_launches)
        for key, err in lookback_numbers(torch, np, dev).items():
            errs[key] = max(errs[key], err)
        paths.update(scale_out(torch, np, dev, tmp))
        paths["served"] = served_session(torch, np, dev, tmp)["launches"]
        check_cavlc_tiers(torch, np, dev)
        paths.update(media_paths(torch, np, dev, tmp))
        paths.update(last_surface(torch, np, dev, tmp))
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
         "launches_by_path": {name: counts[key] for name, counts in paths.items()}}
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
