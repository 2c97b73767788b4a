"""The port's offline render with host feeds and its two entry examples
against the JAX package.

* ``engine.render.render(..., ext_feeds_fn=...)``: a StreamInput ->
  Amplifier -> Monitor graph fed seeded int16 PCM block by block, a short
  tail block included, against the JAX ``render`` with the same feeds.
* ``examples/torch_synth_patch.py`` on the CPU against
  ``examples/synth_patch.py`` on CPU JAX at 44.1 and 48 kHz.  At 44.1 kHz
  (the regular program) the JAX example runs op by op
  (``jax.disable_jit()``): jitted, XLA's CPU backend contracts the
  oscillator's phase ``base + i * delta`` into one FMA where the port rounds
  the product and the sum apart, so a saw's wrap can land one sample apart
  and the EqThree's recursion carries the jump on.  At 48 kHz both take the
  region program, the JAX one jitted (Pallas in interpret mode).
* ``examples/torch_fleet_demo.py`` with CPU workers: it exits 0 and the
  migrated workspace resumes from its runtime checkpoint.
"""

import importlib.util
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MODULE_TOL = 2e-6  # a module alone, as the port's per-module tests hold it
# the synth's WAV: both sides truncate their float taps to int16; where a tap
# sits within its float error of an integer the two truncate one apart
SYNTH_LSB = 1


def example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def feed_graph(p, workspace_cls):
    """StreamInput (its audio) -> Amplifier -> Monitor, in either package."""
    ws = workspace_cls()
    src = ws.create_module(p.ModuleParams("StreamInput", p.StreamInputParams(
        p.StreamProtocol.RTMP, "feeds-test")))
    amp = ws.create_module(p.ModuleParams("Amplifier", p.AmplifierParams(amplitude=0.8,
                                                                         mod_depth=0.0)))
    mon = ws.create_module(p.ModuleParams("Monitor", None))
    ws.connect(p.InputId(amp, 0), p.OutputId(src, 1))
    ws.connect(p.InputId(mon, 1), p.OutputId(amp, 0))
    return ws, src, mon


def block_pcm(t0: int, n: int) -> np.ndarray:
    """Seeded channel-major int16 [2, n] for the block at sample ``t0``."""
    rng = np.random.default_rng(t0)
    tone = 15000 * np.sin(2 * np.pi * 220.0 * (t0 + np.arange(n)) / 44_100.0)
    pcm = np.stack([tone, -0.5 * tone]) + rng.normal(0, 2000, (2, n))
    return np.clip(pcm, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("n_ticks,block_ticks", [(7, 3), (5, 5)])
def test_render_with_host_feeds_matches_the_jax_render(n_ticks, block_ticks):
    """The feeds are asked for once a block with the block's start and its
    ``BlockSpec`` (the tail block's own size included), and the Monitor's
    audio equals the JAX render's with the same feeds within the tolerance
    of a module alone."""
    from mixlab_tpu import protocol as jp
    from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
    from mixlab_tpu.engine.graph import Workspace as JaxWorkspace
    from mixlab_tpu.engine.render import render as jax_render
    from mixlab_tpu_torch import protocol as tp
    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.engine.render import render

    def feeds_fn(calls, key):
        def fn(t0, block):
            n = block.n_samples(cfg)
            calls.append((t0, block.n_ticks))
            return {key: {"pcm": block_pcm(t0, n)}}
        return fn

    cfg = EngineConfig(sample_rate=44_100)
    ws, src, mon = feed_graph(tp, Workspace)
    jws, jsrc, jmon = feed_graph(jp, JaxWorkspace)
    calls, jcalls = [], []
    got = render(ws, n_ticks, cfg, block_ticks=block_ticks, device=CPU,
                 ext_feeds_fn=feeds_fn(calls, str(src.value))).monitor_audio(mon)
    want = jax_render(jws, n_ticks, JaxEngineConfig(sample_rate=44_100),
                      block_ticks=block_ticks,
                      ext_feeds_fn=feeds_fn(jcalls, str(jsrc.value))).monitor_audio(jmon)
    spt = cfg.samples_per_tick
    blocks = [min(block_ticks, n_ticks - b) for b in range(0, n_ticks, block_ticks)]
    assert calls == jcalls == [(b * spt, n) for b, n in zip(
        range(0, n_ticks, block_ticks), blocks)]
    assert got.shape == want.shape == (n_ticks * spt, 2)
    fed = np.concatenate([block_pcm(t0, n * spt) for t0, n in calls], axis=1).T
    assert np.abs(got - 0.8 * fed / 32768.0).max() < 1e-6  # the feeds arrived
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=MODULE_TOL)


def read_wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, w.getnchannels())


@pytest.mark.parametrize("sample_rate", [44_100, 48_000])
def test_synth_example_matches_the_jax_example(tmp_path, sample_rate, capsys):
    """One second of the synth patch: the port's example on the CPU returns
    the int16 PCM it wrote, which is within ``SYNTH_LSB`` of the JAX
    example's WAV (the JAX example op by op at 44.1 kHz, see above), and
    prints the JAX example's line."""
    import jax

    jax_example, port_example = example("synth_patch"), example("torch_synth_patch")
    args = ["--seconds", "1", "--sample-rate", str(sample_rate)]
    with jax.disable_jit(sample_rate == 44_100):
        assert jax_example.main([str(tmp_path / "jax.wav"), *args]) == 0
    jax_line = capsys.readouterr().out.strip()
    pcm = port_example.main([str(tmp_path / "port.wav"), *args, "--device", "cpu"])
    port_line = capsys.readouterr().out.strip()
    assert port_line.split(":", 1)[1] == jax_line.split(":", 1)[1]
    want = read_wav(tmp_path / "jax.wav")
    assert pcm.dtype == np.int16 and pcm.shape == want.shape == (sample_rate, 2)
    assert np.array_equal(read_wav(tmp_path / "port.wav"), pcm)
    assert int(np.abs(pcm.astype(int) - want.astype(int)).max()) <= SYNTH_LSB


def test_fleet_demo_migrates_with_its_runtime_state(tmp_path):
    """The demo with CPU workers: three workspaces placed on two agents, one
    migrated, its runtime state restored."""
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_fleet_demo.py"),
                           "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("placed ") for line in lines) == 3
    assert "workers on cpu" in lines[0]
    migrated = [line for line in lines if line.startswith("migrated: ")]
    assert len(migrated) == 1 and migrated[0].endswith("(runtime state restored: True)")
    assert lines[-1] == "done"
