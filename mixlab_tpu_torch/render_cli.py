"""Offline render CLI (port of ``mixlab_tpu/render_cli.py``).

``python -m mixlab_tpu_torch.render_cli project.mixlab out.wav --seconds 10``

Loads the workspace from a project file and renders the first Monitor
module offline on ``--device`` (``cuda`` by default; ``cpu`` only when
asked for).  The output format follows the extension, as in the JAX CLI:

  * ``.flac`` — 16-bit PCM written losslessly by the port's pure FLAC
    encoder (``av/flacenc.py``);
  * ``.mp4``  — refused: the export reads the Monitor's pipe through the
    fMP4 codec pipeline (``MonitorPipeline``), which the port does not
    carry yet (ROADMAP.md queue 1, MonitorPipeline);
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


def main(argv=None) -> np.ndarray:
    """CLI entry point; returns the rendered float32 ``[frames, 2]`` audio."""
    parser = argparse.ArgumentParser(prog="mixlab_tpu_torch.render_cli")
    parser.add_argument("project", help="project file (.mixlab)")
    parser.add_argument("output", help="output path (.flac; .wav or any other "
                        "extension writes WAV)")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--sample-rate", type=int, default=44_100)
    parser.add_argument("--block-ticks", type=int, default=60)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    if args.output.lower().endswith(".mp4"):
        raise SystemExit(
            ".mp4 export is not ported: it needs the Monitor's fMP4 codec pipeline "
            "(ROADMAP.md queue 1, MonitorPipeline); write .wav or .flac")

    from mixlab_tpu_torch.device import resolve_device
    from mixlab_tpu_torch.precision import switch_tf32_off

    switch_tf32_off()
    device = resolve_device(args.device)
    cfg, audio = render_project(args.project, args.seconds, args.sample_rate,
                                args.block_ticks, device)
    write_audio(args.output, cfg.sample_rate, audio)
    peak = float(np.abs(audio).max())
    print(f"wrote {args.output}: {audio.shape[0]} frames, peak {peak:.3f}")
    return audio


if __name__ == "__main__":
    main()
