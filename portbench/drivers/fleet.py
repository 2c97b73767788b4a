"""The fleet: N live sessions of one graph, each with its own params, in
blocks back to back (closed loop) through the fleet server's own block step,
``FleetEngine._block_once`` (``server/fleet_serve.py``): ``Fleet.host_aux``,
the batched program (the region program where the block qualifies), the
taps as i16 PCM on the device, and one block's pinned fetch kept in flight.
The window neither sleeps to the deadline nor opens a socket: the step's
fan-out to the sessions' sockets is replaced by the benchmark's reader,
which takes each block's PCM as it reaches the host.

Traffic (``params`` of the cell): ``sessions``, ``block_ticks``,
``warm_blocks`` (blocks run before the window), ``sample_sessions`` (the
sessions whose PCM the check compares, half from each half of the fleet)
and ``sample_blocks`` (blocks a sampled session is compared on, the last
delivered among them).

The check's numbers: ``pcm_gap_lsb``, the widest i16 gap beyond what the
FmSine's float32 phase allows (``reference/audio.py``); ``side_gap_lsb``,
the widest gap of left minus right, where the FmSine and amplifiers 1-3
cancel, so nothing allows for the phase (read where neither channel can
clip, the FmSine's allowance counted in); ``state_gap``, the EqThree's poles
and history; ``env_state_off``, the sessions whose envelope state differs.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from portbench import judge, sessions
from portbench.reference import audio as ref

MONITOR = "16"  # the flagship's Monitor module id
PCM_SCALE = 32767.0  # i16 steps a unit of float audio
CLIP = 0.999  # the side gap reads the samples that neither channel clips


def setup(cell, config, seed, device, tracer):
    import torch

    from mixlab_tpu_torch.engine.config import EngineConfig
    from mixlab_tpu_torch.server.fleet_serve import FleetEngine

    tr = cell["params"]
    n = int(tr["sessions"])
    cfg = EngineConfig(sample_rate=config["sample_rate"])
    sps = sessions.draw(config, seed, n)
    wss, _ = sessions.workspaces(sps)
    eng = FleetEngine(wss[0], n, cfg, block_ticks=int(tr["block_ticks"]), device=device)
    for i, ws in enumerate(wss):  # each session's params: the server's param edit
        eng.fleet.update_instance_aux(i, ws)
    rng = np.random.default_rng([1, seed])
    k = int(tr["sample_sessions"])
    half = n // 2
    rows = np.sort(np.concatenate([rng.choice(half, k // 2, replace=False),
                                   half + rng.choice(n - half, k - k // 2, replace=False)]))
    ctx = SimpleNamespace(eng=eng, cfg=cfg, sps=sps, rows=rows, seed=seed, tr=tr, cell=cell,
                          spb=eng.block.n_samples(cfg), got={}, torch=torch, device=device,
                          delivered=0, delivered_at=0.0)
    eng._fan_out = lambda t0, taps: _deliver(ctx, t0, taps)
    for _ in range(int(tr["warm_blocks"])):
        eng._block_once()
    _sync(ctx)
    return ctx


def _sync(ctx):
    if ctx.device != "cpu":
        ctx.torch.cuda.synchronize()


def _deliver(ctx, t0, taps):
    """The reader: a block's i16 PCM has reached the host; keep the sampled
    sessions' rows."""
    ctx.delivered_at = time.perf_counter()
    ctx.delivered += 1
    l, r = taps[MONITOR]["audio"]
    k = len(ctx.rows)
    ctx.got[t0] = np.stack([l[ctx.rows].reshape(k, -1), r[ctx.rows].reshape(k, -1)], axis=-1)


def window(ctx, seconds, tracer):
    from mixlab_tpu_torch.server import fleet_serve

    eng = ctx.eng
    tracer.wrap(eng.fleet, "host_aux", "fleet.host_aux")
    tracer.wrap(eng.fleet, "step", "fleet.step")
    tracer.wrap(fleet_serve, "_finish_fetch", "fleet.fetch_wait")
    ctx.got.clear()
    ctx.delivered = 0
    t_open = time.perf_counter()
    close = t_open + seconds
    ctx.delivered_at = t_open
    while ctx.delivered_at < close or ctx.delivered == 0:
        with tracer.span("fleet.block"):
            eng._block_once()
    span = ctx.delivered_at - t_open
    n, sr = eng.capacity, ctx.cfg.sample_rate
    blocks = ctx.delivered
    # the state the check reads: after the last block issued
    st = eng.fleet.state[0]
    ctx.t_state = eng.tick * ctx.cfg.samples_per_tick
    ctx.state = {k: v[ctx.rows].cpu().numpy() for k, v in
                 (("poles", st["12"]["poles"]), ("hist", st["12"]["hist"]),
                  ("mode_on", st["2"]["mode_on"]), ("on_pos", st["2"]["on_pos"]),
                  ("off_amp", st["2"]["off_amp"]))}
    return {"end_to_end": {"fleet_x_realtime": blocks * n * ctx.spb / sr / span},
            "attempted": blocks * n, "failed": 0, "units": blocks, "facts": _shapes(ctx, blocks)}


def _shapes(ctx, blocks) -> dict:
    """The window's shapes, for the metrics' arithmetic: sessions, samples a
    block, blocks delivered, and the bytes of the fleet's state and params."""
    from mixlab_tpu_torch.convert import tree_leaves

    eng = ctx.eng
    return {"sessions": eng.capacity, "samples_per_block": ctx.spb, "blocks": blocks,
            "state_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(eng.fleet.state)),
            "param_bytes": sum(np.asarray(x).nbytes for x in tree_leaves(eng.fleet.aux))}


def release(ctx):
    ctx.eng = None
    if ctx.device != "cpu":
        ctx.torch.cuda.empty_cache()


def check(ctx, control=None):
    """Each sampled session's i16 PCM on ``sample_blocks`` of the delivered
    blocks (drawn from the seed, the last always among them) and its carried
    state after the last block issued, against the plain reference.  With
    ``control`` (a ``quant`` of the reference) the reference at that
    precision gives the answers in the program's place."""
    lim = ctx.cell["limits"]
    spb, sr, spt = ctx.spb, ctx.cfg.sample_rate, ctx.cfg.samples_per_tick
    t0s = sorted(ctx.got)
    rng = np.random.default_rng([2, ctx.seed])
    m = min(int(ctx.tr["sample_blocks"]), len(t0s))
    pick = sorted(set(rng.choice(len(t0s) - 1, m - 1, replace=False).tolist())
                  | {len(t0s) - 1}) if len(t0s) > 1 else [0]
    blocks = [t0s[i] for i in pick]
    ranges = [(t, t + spb) for t in blocks]
    pcm = side = state = 0.0
    env_off = 0
    for j, row in enumerate(ctx.rows):
        sp = ctx.sps[row]
        want, st = ref.session_monitor(sp, sr, spt, ranges, t_state=ctx.t_state)
        if control:
            low, lst = ref.session_monitor(sp, sr, spt, ranges, quant=control, t_state=ctx.t_state)
            got = [ref.to_i16(w) for w in low]
            poles, hist = lst["eq_poles"], lst["eq_hist"]
            # the reference's envelope: open from sample 0, never released
            mode_on, on_pos, off_amp = True, -ctx.t_state, 0.0
        else:
            got = [ctx.got[t0][j] for t0 in blocks]
            poles, hist = ctx.state["poles"][j], ctx.state["hist"][j]
            mode_on, on_pos, off_amp = (ctx.state[k][j] for k in ("mode_on", "on_pos", "off_amp"))
        for g, w, allow in zip(got, want, st["fm_allow"]):
            pcm = max(pcm, judge.gap_beyond(g, ref.to_i16(w), allow, scale=PCM_SCALE))
            side = max(side, judge.side_gap(g, w, scale=PCM_SCALE, clip=CLIP, allow=allow))
        state = max(state, judge.gap(poles, st["eq_poles"]), judge.gap(hist, st["eq_hist"]))
        env_off += int(not (bool(mode_on) and int(on_pos) == -ctx.t_state
                            and float(off_amp) == 0.0))
    return {"pcm_gap_lsb": {"value": pcm, "limit": lim["pcm_gap_lsb"]},
            "side_gap_lsb": {"value": side, "limit": lim["side_gap_lsb"]},
            "state_gap": {"value": state, "limit": lim["state_gap"]},
            "env_state_off": {"value": env_off, "limit": 0}}
