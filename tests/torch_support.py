"""Helpers that the port's tests and ``chip_smoke.py`` share: inputs at a
kernel's edges (gates, the sink zoo, region plans and their rows, the
fleet's workspaces), the region kernel held to its twin launch by launch,
comparisons of trees and rows, and a walk of the fragmented MP4 the
monitor writes.  It imports neither jax nor the JAX package, and the port
(so torch) only inside its functions."""

REGION_ATOL = 2e-5       # tests/test_pallas_graph.py:85


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


def run_blocks(patch, ws, n_blocks, feeds=None):
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


def tree_err(a, b, what):
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


def region_inputs(torch, g, plan, row, B, S, dev, shared=(), nan=False):
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


def rows_err(torch, got, want):
    """Max |got - want| where both are numbers; inf if their NaNs differ."""
    if not torch.equal(got.isnan(), want.isnan()):
        return float("inf")
    d = (got - want).abs().nan_to_num(nan=0.0)
    return d.max().item() if d.numel() else 0.0


def same_bits(torch, got, want):
    return torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0)) and torch.equal(
        got.isnan(), want.isnan())


def peaks_exact(torch, plan, part, taps, stap):
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
        if not same_bits(torch, stap[:, a[0]], want):
            return False
    return True


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
