"""The offline render: one session's project rendered through
``engine/render.py`` ``render`` (``render_cli``'s path: the patch compiled,
then its block program block by block with the state carried and each
block's Monitor audio fetched to host memory), again and again for the whole
window.  No file is written.

Traffic (``params`` of the cell): ``projects`` (sessions drawn from the
seed; render i renders project i mod ``projects``), ``project_ticks`` and
``block_ticks``.  The check compares the first render of every project and
the last render of the window, whole, with the plain reference.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from portbench import judge, sessions
from portbench.reference import audio as ref


def setup(cell, config, seed, device, tracer):
    import torch

    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.engine.render import render

    tr = cell["params"]
    sps = sessions.draw(config, seed, int(tr["projects"]))
    wss, mon = sessions.workspaces(sps)
    ctx = SimpleNamespace(cfg=EngineConfig(sample_rate=config["sample_rate"]), sps=sps, wss=wss,
                          mon=mon, tr=tr, cell=cell, seed=seed, torch=torch,
                          device=torch.device(device), kept={}, render=render)
    _render(ctx, 0)  # every shape the window uses: one whole render
    return ctx


def _render(ctx, i):
    k = i % len(ctx.wss)
    res = ctx.render(ctx.wss[k], n_ticks=int(ctx.tr["project_ticks"]), cfg=ctx.cfg,
                     block_ticks=int(ctx.tr["block_ticks"]), device=ctx.device)
    return k, res.monitor_audio(ctx.mon)


def window(ctx, seconds, tracer):
    from mixlab_tpu_torch.engine import render as render_mod
    from mixlab_tpu_torch.engine.compiler import CompiledPatch

    tracer.wrap(render_mod, "compile_patch", "render.compile")
    tracer.wrap(CompiledPatch, "host_aux", "render.host_aux")
    tracer.wrap(CompiledPatch, "run", "render.block")
    ctx.kept.clear()
    n_projects = len(ctx.wss)
    t_open = time.perf_counter()
    close = t_open + seconds
    i, done_at = 0, t_open
    while done_at < close:
        with tracer.span("render.render"):
            k, audio = _render(ctx, i)
        done_at = time.perf_counter()
        if i < n_projects:
            ctx.kept[i] = (k, audio)
        last = (k, audio)
        i += 1
    ctx.kept[i - 1] = last
    spt = ctx.cfg.samples_per_tick
    project_s = int(ctx.tr["project_ticks"]) * spt / ctx.cfg.sample_rate
    blocks = i * -(-int(ctx.tr["project_ticks"]) // int(ctx.tr["block_ticks"]))
    return {"end_to_end": {"render_x_realtime": i * project_s / (done_at - t_open)},
            "attempted": i, "failed": 0, "units": blocks, "facts": {"blocks": blocks}}


def release(ctx):
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def check(ctx, control=None):
    """The kept renders' stereo float32 Monitor audio, whole, against the
    plain reference of their project: ``audio_gap`` beyond what the FmSine's
    float32 phase allows, ``side_gap`` of left minus right.  With
    ``control`` (a ``quant`` of the reference) the reference at that
    precision gives the answers in the program's place."""
    lim = ctx.cell["limits"]
    sr, spt = ctx.cfg.sample_rate, ctx.cfg.samples_per_tick
    n = int(ctx.tr["project_ticks"]) * spt
    want, low = {}, {}
    gap = side = 0.0
    for k, audio in ctx.kept.values():
        if k not in want:
            (w,), st = ref.session_monitor(ctx.sps[k], sr, spt, [(0, n)])
            want[k] = w, st["fm_allow"][0]
            if control:
                low[k] = ref.session_monitor(ctx.sps[k], sr, spt, [(0, n)], quant=control)[0][0]
        w, allow = want[k]
        got = low[k] if control else audio
        gap = max(gap, judge.gap_beyond(got, w, allow))
        side = max(side, judge.side_gap(got, w))
    return {"audio_gap": {"value": gap, "limit": lim["audio_gap"]},
            "side_gap": {"value": side, "limit": lim["side_gap"]}}
