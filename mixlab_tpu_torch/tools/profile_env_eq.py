"""Where a 48 kHz block's time goes: the envelope and the EqThree each alone,
the two in a chain, the flagship graph and variants of it without each, and
the flagship with a same-shape passthrough kernel in the EqThree's place
(port of ``tools/profile_env_eq.py``).

Every row runs blocks of 480 ticks (S = 384,000 samples at 48 kHz) and
reports wall time per second of audio as the slope between 8 and 248 blocks
(fixed costs cancel), the best of ``reps`` rounds.  Each block's taps are
summed on the device into one scalar that is read at the end, so nothing
per block crosses to the host and nothing is stacked.  Graph rows say
which program they took: the region program (one kernel launch per part
for the EqThree and everything downstream) or the regular one.

  * ``passthrough_cuda`` — ``out = x * 1.0000001`` through the hand-written
    kernel (``csrc/passthrough.cu``) for a CUDA tensor, which replaces the
    tool's TPU kernel ``_dummy_kernel`` (``tools/profile_env_eq.py:221``);
    the plain twin ``passthrough_torch`` for a CPU tensor; any other device
    raises.
  * ``EqDummy`` — a module kind that runs the passthrough, registered only
    while the rows are built and run (``registry.registered``).

Run: python -m mixlab_tpu_torch.tools.profile_env_eq [reps] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.dsp import registry
from mixlab_tpu_torch.dsp.base import ModuleDef, expect_mono
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.flagship import build_16_module_graph
from mixlab_tpu_torch.precision import switch_tf32_off

ROWS = ("env", "eq", "chain", "full", "full_noosc", "full_dummy_eq", "no_env", "no_eq",
        "no_both")
SAMPLE_RATE = 48_000
BLOCK_TICKS = 480
GAIN = np.float32(1.0000001)  # the f32 the TPU kernel's literal becomes


def passthrough_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain twin: ``x * float32(1.0000001)``, one f32 product per sample."""
    return x * float(GAIN)


def passthrough_cuda(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.0000001`` over a contiguous 1-D f32 tensor: ONE launch of the
    CUDA kernel on the current stream for a CUDA tensor, the plain twin for
    a CPU tensor."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        if isinstance(x, torch.Tensor) and x.is_cpu:
            return passthrough_torch(x)
        kernels.cuda_index(x, "passthrough")  # raises: any other device
    n = x.numel()
    if not (x.dtype is torch.float32 and x.dim() == 1 and 0 < n < 2 ** 31
            and x.is_contiguous()):
        raise ValueError("passthrough: want a contiguous non-empty 1-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    kernels.launch("mixlab_passthrough", "passthrough kernel launch", x.get_device(),
                   x.data_ptr(), out.data_ptr(), n)
    passthrough_cuda.launches += 1
    return out


passthrough_cuda.launches = 0


class EqDummyDef(ModuleDef):
    """Mono in, mono out through the passthrough: the EqThree's place in
    the graph with a kernel boundary and no filter work."""

    kind = "EqDummy"

    def terminals(self, params):
        return [p.LineType.MONO.unlabeled()], [p.LineType.MONO.unlabeled()]

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        x = expect_mono(inputs[0], block.n_samples(cfg), device)
        return state, [passthrough_cuda(x.contiguous())], {}


# --------------------------------------------------------------------------
# timing


def timed_slope(make: Callable[[int], Callable[[], float]], n1: int, n2: int,
                reps: int = 3) -> float:
    """Two-point timing: ``make(n)`` returns a zero-argument thunk doing n
    units of work and ending in a scalar read (which waits for the device).
    Returns seconds per unit as (t(n2) - t(n1)) / (n2 - n1): fixed costs
    cancel.  Each thunk runs once untimed first."""
    f1, f2 = make(n1), make(n2)
    f1()
    f2()

    def wall(f):
        t = time.perf_counter()
        f()
        return time.perf_counter() - t

    t1 = min(wall(f1) for _ in range(reps))
    t2 = min(wall(f2) for _ in range(reps))
    return max((t2 - t1) / (n2 - n1), 1e-12)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _checksum(taps) -> torch.Tensor:
    return sum(t.to(torch.float32).sum() for t in _leaves(taps))


@dataclass
class Row:
    """``make(n)`` -> a thunk running n blocks and returning their checksum;
    ``program``: "module" (one module's ``run_block``), "region" or
    "regular"; ``blocks``: blocks run so far."""

    make: Callable[[int], Callable[[], float]]
    program: str
    blocks: int = 0


# --------------------------------------------------------------------------
# the rows


def _module_row(kind, params, x, cfg, block, device) -> Row:
    """One module's ``run_block`` on the same input every block, its state
    carried."""
    d = registry.get_def(kind)
    aux, state0 = d.prepare(params, cfg, device), d.init_state(params, cfg, device)
    row = Row(None, "module")

    def make(n):
        def run():
            st, total = state0, torch.zeros((), device=device)
            for _ in range(n):
                st, (out,), _ = d.run_block(params, aux, None, st, [x], cfg, block, device)
                total = total + out.sum()
                row.blocks += 1
            return total.item()
        return run

    row.make = make
    return row


def _graph_row(ws: Workspace, cfg, block, device) -> Row:
    patch = compile_patch(ws, cfg, block, device)
    aux, state0 = patch.prepare_aux(ws), patch.init_state(ws)
    spb = block.n_samples(cfg)
    row = Row(None, "region" if patch._mega else "regular")

    def make(n):
        hosts = [patch.host_aux(i * spb) for i in range(n)]

        def run():
            st, total = state0, torch.zeros((), device=device)
            for h in hosts:
                st, taps = patch.run(aux, h, st)
                total = total + _checksum(taps)
                row.blocks += 1
            return total.item()
        return run

    row.make = make
    return row


def _eq_params():
    return p.EqThreeParams(p.Decibel(4.0), p.Decibel(0.0), p.Decibel(4.0))


def _workspace(modules, links) -> Workspace:
    """``modules``: (name, kind, params) in creation order; ``links``:
    ((input name, index), (output name, index))."""
    ws = Workspace()
    ids = {name: ws.create_module(p.ModuleParams(kind, params)) for name, kind, params in modules}
    for (im, ii), (om, oi) in links:
        ws.connect(p.InputId(ids[im], ii), p.OutputId(ids[om], oi))
    return ws


def _flagship_variant(env: bool = True, osc: bool = True,
                      eq_kind: Optional[str] = "EqThree") -> Workspace:
    """The flagship topology, optionally without the envelope (the amps and
    the FM read the trigger), with Trigger constants in place of the
    oscillators (the amps' audio inputs then stay unconnected) and with
    ``eq_kind`` (or nothing) between the splitter and the panner."""
    modules = [("trig", "Trigger", p.GateState.OPEN)]
    links = []
    ctrl = "trig"
    if env:
        modules.append(("env", "Envelope", p.EnvelopeParams()))
        links.append((("env", 0), ("trig", 0)))
        ctrl = "env"
    for i in range(4):
        modules.append((f"src{i}", "Oscillator", p.OscillatorParams(
            110.0 * (i + 1), p.Waveform.SINE)) if osc else (f"src{i}", "Trigger",
                                                              p.GateState.OPEN))
    modules.append(("fm", "FmSine", p.FmSineParams(440.0, 880.0)))
    modules += [(f"amp{i}", "Amplifier", p.AmplifierParams(amplitude=0.5, mod_depth=0.3))
                for i in range(4)]
    if eq_kind:
        modules.append(("eq", eq_kind, _eq_params() if eq_kind == "EqThree" else None))
    modules += [("split", "StereoSplitter", None), ("pan", "StereoPanner", None),
                ("mixer", "Mixer", p.MixerParams.with_channels(8)), ("mon", "Monitor", None)]
    for i in range(4):
        if osc:
            links.append(((f"amp{i}", 0), (f"src{i}", 1)))
        links += [((f"amp{i}", 1), (ctrl, 0)), (("mixer", i), (f"amp{i}", 0))]
    links += [(("fm", 0), (ctrl, 0)), (("mixer", 4), ("fm", 0)), (("split", 0), ("amp0", 0))]
    if eq_kind:
        links += [(("eq", 0), ("split", 0)), (("pan", 0), ("eq", 0))]
    else:
        links.append((("pan", 0), ("split", 0)))
    links += [(("pan", 1), ("split", 1)), (("mixer", 5), ("pan", 0)),
              (("mixer", 6), ("amp1", 0)), (("mixer", 7), ("amp2", 0)), (("mon", 1), ("mixer", 0))]
    return _workspace(modules, links)


def _chain() -> Workspace:
    """trig -> env -> eq -> panner -> monitor: both kernels, no elementwise
    mass."""
    return _workspace(
        [("trig", "Trigger", p.GateState.OPEN), ("env", "Envelope", p.EnvelopeParams()),
         ("eq", "EqThree", _eq_params()), ("pan", "StereoPanner", None),
         ("mon", "Monitor", None)],
        [(("env", 0), ("trig", 0)), (("eq", 0), ("env", 0)), (("pan", 0), ("eq", 0)),
         (("pan", 1), ("eq", 0)), (("mon", 1), ("pan", 0))])


def build_rows(device: torch.device, block_ticks: int = BLOCK_TICKS,
               names: Sequence[str] = ROWS) -> Dict[str, Row]:
    """The rows named in ``names``; ``EqDummy`` must be registered (inside
    ``registry.registered(EqDummyDef())``) for ``full_dummy_eq``."""
    cfg = EngineConfig(sample_rate=SAMPLE_RATE)
    block = BlockSpec(block_ticks)
    S = block.n_samples(cfg)
    tt = np.arange(S, dtype=np.int64)
    gate = torch.from_numpy(((tt * 4 // cfg.sample_rate) % 2).astype(np.float32)).to(device)
    xin = torch.from_numpy(
        np.random.default_rng(0).uniform(-1, 1, S).astype(np.float32)).to(device)
    makers = {
        "env": lambda: _module_row("Envelope", p.EnvelopeParams(), gate, cfg, block, device),
        "eq": lambda: _module_row("EqThree", _eq_params(), xin, cfg, block, device),
        "chain": lambda: _chain(),
        "full": lambda: build_16_module_graph()[0],
        "full_noosc": lambda: _flagship_variant(osc=False),
        "full_dummy_eq": lambda: _flagship_variant(eq_kind="EqDummy"),
        "no_env": lambda: _flagship_variant(env=False),
        "no_eq": lambda: _flagship_variant(eq_kind=None),
        "no_both": lambda: _flagship_variant(env=False, eq_kind=None),
    }
    rows = {}
    for name in names:
        made = makers[name]()
        rows[name] = made if isinstance(made, Row) else _graph_row(made, cfg, block, device)
    return rows


def launch_counts() -> Dict[str, int]:
    from mixlab_tpu_torch.dsp.envelope_cuda import envelope_block_cuda
    from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_cuda
    from mixlab_tpu_torch.engine.region_cuda import region_part_cuda

    return {"envelope": envelope_block_cuda.launches, "eq_cascade": eq_cascade_cuda.launches,
            "region": region_part_cuda.launches, "passthrough": passthrough_cuda.launches}


def profile_rows(device="cuda", reps: int = 3, n1: int = 8, n2: int = 248,
                 block_ticks: int = BLOCK_TICKS, names: Sequence[str] = ROWS,
                 log: Callable[[str], None] = print) -> List[dict]:
    """Time each row ``reps`` rounds (``timed_slope(n1, n2, reps=2)`` per
    round, rows in turn) and keep its best.  Returns per row: ``name``,
    ``program``, ``us_per_s`` (wall per second of audio), ``blocks`` run and
    the kernel ``launches`` made while it ran."""
    device = resolve_device(device)
    block_seconds = BlockSpec(block_ticks).n_samples(EngineConfig(sample_rate=SAMPLE_RATE)) \
        / SAMPLE_RATE
    with registry.registered(EqDummyDef()):
        rows = build_rows(device, block_ticks, names)
        best = {k: float("inf") for k in rows}
        launches = {k: dict.fromkeys(launch_counts(), 0) for k in rows}
        for r in range(reps):
            line = [f"pair {r}:"]
            for k, row in rows.items():
                before = launch_counts()
                s = timed_slope(row.make, n1, n2, reps=2)
                for name, n in launch_counts().items():
                    launches[k][name] += n - before[name]
                best[k] = min(best[k], s)
                line.append(f"{k} {1e6 * s / block_seconds:7.2f}")
            log("  ".join(line))
    return [{"name": k, "program": row.program, "us_per_s": 1e6 * best[k] / block_seconds,
             "blocks": row.blocks, "launches": launches[k]} for k, row in rows.items()]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(prog="python -m mixlab_tpu_torch.tools.profile_env_eq",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    switch_tf32_off()  # the tool owns its process: IEEE f32 products
    res = profile_rows(args.device, args.reps)
    print("best us/s:", "  ".join(f"{r['name']} {r['us_per_s']:.2f}" for r in res))
    for r in res:
        print(f"  {r['name']}: {r['program']} program, {r['blocks']} blocks, "
              f"launches {r['launches']}")
    return res


if __name__ == "__main__":
    main()
