"""Offline render CLI (port of ``mixlab_tpu/render_cli.py``).

``python -m mixlab_tpu_torch.render_cli project.mixlab out.wav --seconds 10``

Loads the workspace from a project file and renders the first Monitor
module offline on ``--device`` (``cuda`` by default; ``cpu`` only when
asked for).  The output format follows the extension, as in the JAX CLI:

  * ``.flac`` — 16-bit PCM written losslessly by the port's pure FLAC
    encoder (``av/flacenc.py``);
  * ``.mp4``  — full A/V export: the realtime engine on ``--device`` ticks
    unthrottled in direct drive, ``--block-ticks`` ticks a block, with
    back-pressure against the Monitor's codec thread (no drop-on-lag), and
    the fMP4 stream (the live monitor's tiers: the ffmpeg CLI when present,
    else the pure AAC-LC + CAVLC H.264, FLAC in place of AAC under
    ``MIXLAB_PURE_AUDIO=flac``) is written as a playable file;
  * any other extension (``.wav``, ``.pcm``, ...) — a 16-bit PCM WAV file.

``--sample-rate 48000`` renders 60-tick blocks of 48,000 samples, a whole
number of 128-sample chunks, so ``compile_patch`` engages the whole-graph
region kernel there, as the JAX package does; the CLI's 44.1 kHz default
runs the regular program.

The CLI owns its process, so it switches TF32 off before it renders: the
EqThree's f32 products then run in IEEE f32 (``precision.py``).
"""

from __future__ import annotations

import argparse

import numpy as np


def render_project(project: str, seconds: float, sample_rate: int,
                   block_ticks: int, device):
    """Render the project's first Monitor; returns ``(cfg, audio)`` with
    audio a float32 ``[frames, 2]`` array."""
    from mixlab_tpu_torch.dsp.base import interleave_tap
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.engine.project import ProjectBase
    from mixlab_tpu_torch.engine.scan_render import render_scanned

    with ProjectBase(project) as base:
        saved = base.read_workspace()
    if saved is None:
        raise SystemExit("project has no workspace")
    ws = Workspace.from_persist(saved)
    monitors = [mid for mid, e in ws.modules.items() if e.params.kind == "Monitor"]
    if not monitors:
        raise SystemExit("no Monitor module in the patch")
    mon = monitors[0]

    cfg = EngineConfig(sample_rate=sample_rate)
    n_ticks = int(seconds * cfg.ticks_per_second)
    n_ticks -= n_ticks % block_ticks
    if n_ticks == 0:
        n_ticks = block_ticks
    print(f"rendering {n_ticks} ticks ({n_ticks / cfg.ticks_per_second:.1f}s) "
          f"at {cfg.sample_rate} Hz on {device} ...")
    _, (_, taps) = render_scanned(ws, n_ticks, cfg, block_ticks=block_ticks,
                                  device=device)
    audio = interleave_tap(taps[str(mon.value)]["audio"]).reshape(-1, 2)
    return cfg, audio


def write_audio(path: str, sample_rate: int, audio: np.ndarray) -> None:
    if path.lower().endswith(".flac"):
        from mixlab_tpu_torch.av.flacenc import FlacEncoder
        from mixlab_tpu_torch.io_host.wav import pcm_f32_to_i16

        block = 4096  # the last frame may be shorter (spec-legal)
        enc = FlacEncoder(sample_rate, 2, block_size=block)
        pcm = pcm_f32_to_i16(audio)
        with open(path, "wb") as f:
            f.write(enc.stream_header())
            for i in range(0, len(pcm), block):
                f.write(enc.encode_frame(pcm[i:i + block]))
    else:
        from mixlab_tpu_torch.io_host.wav import write_wav

        write_wav(path, sample_rate, audio)


def _render_mp4(project_path: str, cfg, n_ticks: int, out_path: str,
               block_ticks: int, device) -> None:
    """A/V export: direct-drive engine + monitor pipeline, back-pressured
    against the codec thread so no tick is dropped.

    The JAX package's ``_render_mp4``, with the engine on ``device`` and
    ``block_ticks`` ticks a block (the JAX CLI runs one tick a block).  The
    port's engine reads its feeds and runs its video pass once per tick of
    a block, and the codec thread encodes a block's item tick by tick, so
    the video is that of one-tick blocks: a picture every
    ``VIDEO_TICK_DIVISOR`` ticks.  A MediaSource's decode thread paces its
    media in realtime, as in the JAX package, while the export ticks as
    fast as the codec thread takes the items."""
    import queue
    import time

    from mixlab_tpu_torch.av.codecs import codec_tier
    from mixlab_tpu_torch.engine.project import open_or_create

    codec_tier()  # an unavailable forced tier raises here, not on the codec thread
    proj = open_or_create(project_path, cfg, block_ticks=block_ticks,
                          device=str(device))
    try:
        eng = proj.engine
        monitors = [mid for mid, e in eng.ws.modules.items()
                    if e.params.kind == "Monitor"]
        if not monitors:
            raise SystemExit("no Monitor module in the patch")
        mon = monitors[0]
        pipe = eng.monitor_pipe(mon)
        pipeline = eng._monitor_pipelines[mon]
        sub = pipeline.broadcast.subscribe()
        segments = []

        def drain():
            while True:
                try:
                    pkt = sub.get_nowait()
                except queue.Empty:
                    return
                header, _, body = pkt.partition(b"\n")
                if b'"segment"' in header:
                    segments.append(body)

        for _ in range(n_ticks // block_ticks):
            # offline back-pressure: never outrun the codec queue (the
            # live path drops on lag instead — monitor.rs:164-176); a dead
            # codec thread must fail the export, not hang it
            bp_deadline = time.monotonic() + 30.0
            while not pipe.q.empty():
                if not pipeline.is_alive():
                    raise SystemExit("monitor codec thread died mid-export")
                if time.monotonic() > bp_deadline:
                    raise SystemExit("monitor codec stalled >30 s")
                time.sleep(0.001)
            eng.tick_once()
            drain()
        if pipe.dropped:
            raise SystemExit(f"the monitor pipe dropped {pipe.dropped} blocks")
        deadline = time.time() + 30.0
        while not pipe.q.empty() and time.time() < deadline:
            if not pipeline.is_alive():
                raise SystemExit("monitor codec thread died mid-export")
            time.sleep(0.01)
        time.sleep(0.3)  # let the codec thread finish the tail
        pipeline.stop()
        pipeline.join(timeout=5)
        drain()
        init = pipeline.broadcast.init_packet
        header = init.partition(b"\n")[0].decode()
        if '"fmp4"' not in header:
            raise SystemExit(f"monitor is not in fmp4 mode: {header}")
        with open(out_path, "wb") as f:
            f.write(init.partition(b"\n")[2])
            for seg in segments:
                f.write(seg)
        print(f"wrote {out_path}: {len(segments)} segments, "
              f"mime {header.split('mime')[-1][3:90]}")
    finally:
        proj.engine.stop()
        proj.close()


def main(argv=None) -> "np.ndarray | None":
    """CLI entry point; returns the rendered float32 ``[frames, 2]`` audio
    (``None`` for an ``.mp4`` export)."""
    parser = argparse.ArgumentParser(prog="mixlab_tpu_torch.render_cli")
    parser.add_argument("project", help="project file (.mixlab)")
    parser.add_argument("output", help="output path (.flac, .mp4; .wav or any "
                        "other extension writes WAV)")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--sample-rate", type=int, default=44_100)
    parser.add_argument("--block-ticks", type=int, default=60)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from mixlab_tpu_torch.device import resolve_device
    from mixlab_tpu_torch.precision import switch_tf32_off

    switch_tf32_off()
    device = resolve_device(args.device)
    if args.output.lower().endswith(".mp4"):
        from mixlab_tpu_torch.engine.config import EngineConfig

        cfg = EngineConfig(sample_rate=args.sample_rate)
        n_ticks = int(args.seconds * cfg.ticks_per_second)
        n_ticks = max(n_ticks - n_ticks % args.block_ticks, args.block_ticks)
        print(f"exporting {n_ticks} ticks ({n_ticks / cfg.ticks_per_second:.1f}s) at "
              f"{cfg.sample_rate} Hz on {device}, {args.block_ticks} ticks a block ...")
        _render_mp4(args.project, cfg, n_ticks, args.output, args.block_ticks, device)
        return None
    cfg, audio = render_project(args.project, args.seconds, args.sample_rate,
                                args.block_ticks, device)
    write_audio(args.output, cfg.sample_rate, audio)
    peak = float(np.abs(audio).max())
    print(f"wrote {args.output}: {audio.shape[0]} frames, peak {peak:.3f}")
    return audio


if __name__ == "__main__":
    main()
