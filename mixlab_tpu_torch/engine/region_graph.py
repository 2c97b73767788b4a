"""Whole-graph region program: ONE kernel launch per part for the region
(port of ``mixlab_tpu/engine/pallas_graph.py``).

Region selection (static, per compile), as in the JAX package:

  1. seeds   = every EqThree (graphs without one keep the regular program).
  2. region  = downstream closure of the seeds over audio wires.  If any
               member has no :class:`~mixlab_tpu_torch.dsp.base.MegaSpec`,
               the graph keeps the regular program.
  3. expand  = repeatedly absorb any spec-capable module ALL of whose
               consumers are already in the region (amplifiers, triggers,
               external feeds...).  Oscillator / FmSine / Envelope have no
               spec: they run before the region (the prelude), and their
               outputs are the region's crossing operands.

No region output is consumed outside the region, so the kernel's only
exports are taps and scalar state.  A wire whose producer runs after its
consumer (a cycle's back-edge) reads zeros, inside the region and across
its boundary.

The region's modules emit one :class:`~mixlab_tpu_torch.dsp.base.RegionPlan`
(``region_cuda`` runs it).  A block is cut into parts of at most
``MAX_LAUNCH_S`` samples, each a whole number of 128-sample chunks, one
launch each; part N's exit row (the eq poles and delay history) is part
N+1's state row by the layout law.  Taps are concatenated over the parts
and reshaped to ``[T, spt]``; scalar taps combine with max.  The program is
a drop-in ``program(aux, dev_aux, state)`` for the regular one, with taps
and state of the same structure and dtypes.  As the JAX fleet runs
``jax.vmap`` of its region program, ``engine.compiler.batched_program``
maps this program over the instances with ``torch.func.vmap``: each part is
then one launch for every instance (``region_cuda.region_part_cuda``'s custom
op), the operands an instance shares read once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.dsp.base import OP_PEAK, OP_TAP, EmitCtx, MegaSpec, Peak, RegionPlan
from mixlab_tpu_torch.dsp.registry import get_def
from mixlab_tpu_torch.engine import region_cuda
from mixlab_tpu_torch.engine.compiler import _mid_key, run_modules
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.protocol import InputId, LineType, OutputId

ALIGN_S = 128  # parts are whole chunks
# engage only where the standalone eq kernel would: realtime-sized blocks
# keep the regular program
MIN_S = 8192
# samples per launch at most (the JAX package's value; not re-measured here)
MAX_LAUNCH_S = 192 * 1024

KERNEL_SEEDS = ("EqThree",)


def _audio_consumers(entries, connections):
    """producer module id -> [consumer module ids], audio wires only."""
    consumers: Dict[Any, List[Any]] = {}
    for iid, oid in connections.items():
        term = entries[iid.module_id].inputs[iid.index]
        if term.line_type == LineType.VIDEO:
            continue
        consumers.setdefault(oid.module_id, []).append(iid.module_id)
    return consumers


def _select_region(order, entries, connections, cfg, block):
    """Returns (region set, specs dict) or None if the graph doesn't
    qualify."""
    seeds = [m for m in order if entries[m].params.kind in KERNEL_SEEDS]
    if not seeds:
        return None
    consumers = _audio_consumers(entries, connections)

    region = set()
    stack = list(seeds)
    while stack:
        m = stack.pop()
        if m in region:
            continue
        region.add(m)
        stack.extend(consumers.get(m, ()))

    def make_spec(mid):
        e = entries[mid]
        connected = tuple(InputId(mid, i) in connections for i in range(len(e.inputs)))
        return get_def(e.params.kind).mega_spec(e.params.params, cfg, block, connected)

    specs: Dict[Any, MegaSpec] = {}
    for mid in region:
        spec = make_spec(mid)
        if spec is None:
            return None  # the closure reached a module that can't run inside
        specs[mid] = spec

    # absorb producers whose every consumer is already in the region
    changed = True
    while changed:
        changed = False
        for mid in order:
            if mid in region:
                continue
            cons = consumers.get(mid, ())
            if not cons or not all(c in region for c in cons):
                continue
            spec = make_spec(mid)
            if spec is None:
                continue
            region.add(mid)
            specs[mid] = spec
            changed = True

    return region, specs


def _partition(S: int) -> Optional[List[Tuple[int, int]]]:
    """Contiguous ALIGN_S-aligned part ranges, each <= MAX_LAUNCH_S (+ one
    chunk of rounding)."""
    if S % ALIGN_S != 0 or S < MIN_S:
        return None
    n = max(1, -(-S // MAX_LAUNCH_S))
    base = S // n
    bounds = [0] + [(base * i) // ALIGN_S * ALIGN_S for i in range(1, n)] + [S]
    parts = [(bounds[i], bounds[i + 1]) for i in range(n)]
    if any(b - a <= 0 or (b - a) % ALIGN_S or b - a > MAX_LAUNCH_S + ALIGN_S
           for a, b in parts):
        return None
    return parts


def _flat(items) -> List[torch.Tensor]:
    return [torch.as_tensor(it).reshape(-1) for it in items]


def build_mega_program(ws, cfg: EngineConfig, block: BlockSpec, device: torch.device):
    """Returns ``program(aux, dev_aux, state) -> (new_state, taps)`` with
    the region run as one launch per part, or None if the graph / block
    doesn't qualify.  Drop-in for the regular program of
    ``engine.compiler.compile_patch``; ``dev_aux`` is the block's host
    arrays on the device (``compiler.upload_all``)."""
    S = block.n_samples(cfg)
    parts = _partition(S)
    if parts is None:
        return None

    order = ws.run_order()
    entries = {mid: ws.modules[mid] for mid in order}
    connections = dict(ws.connections)
    sel = _select_region(order, entries, connections, cfg, block)
    if sel is None:
        return None
    region, specs = sel

    region_order = [m for m in order if m in region]
    prelude_order = [m for m in order if m not in region]
    order_ix = {m: i for i, m in enumerate(order)}
    used = {
        mid: tuple(OutputId(mid, j) in connections.values()
                   for j in range(len(entries[mid].outputs)))
        for mid in region_order
    }
    # per module: its exits' offset and count (the layout law: == its state
    # scalars); the exit row is the state row
    exit_at: Dict[Any, Tuple[int, int]] = {}
    n_ef = 0
    for mid in region_order:
        d = specs[mid].declare
        if d["exit_i"]:
            raise NotImplementedError("the region plan carries no int state")
        exit_at[mid] = (n_ef, d["exit_f"])
        n_ef += d["exit_f"]

    def program(aux, dev_aux, state):
        # the prelude: the modules outside the region, through run_block
        buffers, new_state, taps_all = run_modules(
            prelude_order, entries, connections, aux, dev_aux, state, cfg, block, device)

        # ---- operands: whole-block tensors, deduplicated by identity -------
        operand_vals: List[torch.Tensor] = []
        slot_of: Dict[int, int] = {}

        def op_slot(v):
            if id(v) not in slot_of:
                slot_of[id(v)] = len(operand_vals)
                operand_vals.append(v)
            return slot_of[id(v)]

        # crossing wires (prelude -> region); a producer that runs after its
        # consumer is a back-edge and reads zeros
        crossing: Dict[Tuple[Any, int], Any] = {}
        for mid in region_order:
            for i, term in enumerate(entries[mid].inputs):
                if term.line_type == LineType.VIDEO:
                    continue
                out_id = connections.get(InputId(mid, i))
                if out_id is None or out_id.module_id in region:
                    continue
                if order_ix[out_id.module_id] > order_ix[mid]:
                    continue
                v = buffers.get(out_id)
                if v is None:
                    continue
                crossing[(mid, i)] = (tuple(op_slot(c) for c in v)
                                      if isinstance(v, tuple) else op_slot(v))

        mod_ops: Dict[Any, Dict[str, int]] = {}
        pf_items: List[torch.Tensor] = []
        sf_items: List[torch.Tensor] = []
        mod_pf: Dict[Any, List[int]] = {}
        mod_sf: Dict[Any, List[int]] = {}
        n_pf = n_sf = 0
        for mid in region_order:
            k = _mid_key(mid)
            spec = specs[mid]
            mod_ops[mid] = {name: op_slot(v)
                            for name, v in spec.operands(aux[k], dev_aux[k]).items()}
            f, _ = spec.param_scalars(aux[k], dev_aux[k])
            f = _flat(f)
            n = sum(t.numel() for t in f)
            mod_pf[mid] = list(range(n_pf, n_pf + n))
            pf_items += f
            n_pf += n
            f, i_ = spec.state_scalars(state[k])
            f = _flat(f)
            n = sum(t.numel() for t in f)
            # layout law: exits feed the next part's state scalars
            if (n, len(i_)) != (exit_at[mid][1], 0):
                raise ValueError(f"module {k}: {n} state scalars for "
                                 f"{exit_at[mid][1]} exits")
            mod_sf[mid] = list(range(n_sf, n_sf + n))
            sf_items += f
            n_sf += n

        # ---- the plan ------------------------------------------------------
        plan = RegionPlan(len(operand_vals), n_pf, n_ef)
        kbuffers: Dict[OutputId, Any] = {}
        tap_slots: List[Tuple[Any, str, Optional[int]]] = []
        stap_slots: List[Tuple[Any, str]] = []
        for mid in region_order:
            entry = entries[mid]
            ins: List[Optional[Any]] = []
            for i, term in enumerate(entry.inputs):
                out_id = connections.get(InputId(mid, i))
                if term.line_type == LineType.VIDEO:
                    ins.append(None)
                elif out_id is not None and out_id in kbuffers:
                    ins.append(kbuffers[out_id])
                else:
                    ins.append(crossing.get((mid, i)))
            e0, en = exit_at[mid]
            ctx = EmitCtx(plan, cfg, block, pf=mod_pf[mid], sf=mod_sf[mid],
                          ef=list(range(e0, e0 + en)), operands=mod_ops[mid],
                          used=used[mid])
            outs, taps = specs[mid].emit(ctx, ins)
            for i, buf in enumerate(outs):
                if buf is not None:
                    kbuffers[OutputId(mid, i)] = buf
            for name, chans in specs[mid].declare["taps"]:
                v = taps[name]
                if chans == 0:
                    if not isinstance(v, Peak):
                        raise TypeError(f"scalar tap {name} must be a Peak")
                    plan.add(OP_PEAK, len(stap_slots), v.l, v.r)
                    stap_slots.append((mid, name))
                for c, src in enumerate(v if chans == 2 else [v] if chans == 1 else []):
                    plan.add(OP_TAP, len(tap_slots), src)
                    tap_slots.append((mid, name, c if chans == 2 else None))
        plan.n_taps, plan.n_stap = len(tap_slots), len(stap_slots)

        empty = torch.zeros(0, dtype=torch.float32, device=device)
        sf = torch.cat(sf_items) if sf_items else empty
        consts = torch.from_numpy(plan.const_row()).to(device)
        if kernels.is_batched(*pf_items):  # under vmap: one row of constants for all
            pf, consts = (torch.cat(pf_items) if pf_items else empty), (consts,)
        else:  # the parameter row: the param scalars, then the constants
            pf, consts = torch.cat(pf_items + [consts]), ()

        # ---- one launch per part -------------------------------------------
        part_taps: List[torch.Tensor] = []
        stap = ef = None
        for a, b in parts:
            taps_p, stap_p, ef = region_cuda.region_part_cuda(
                plan, [v[a:b] for v in operand_vals], pf, sf, b - a, *consts)
            part_taps.append(taps_p)
            stap = stap_p if stap is None else torch.maximum(stap, stap_p)
            sf = ef  # exits ARE the next part's state scalars (layout law)

        # ---- reassemble taps and state -------------------------------------
        shape = (block.n_ticks, cfg.samples_per_tick)
        taps_cat = torch.cat(part_taps, dim=1) if len(parts) > 1 else part_taps[0]
        mod_taps: Dict[Any, Dict[str, Any]] = {m: {} for m in region_order}
        for slot, (mid, name, chan) in enumerate(tap_slots):
            arr = taps_cat[slot].reshape(shape)
            if chan is None:
                mod_taps[mid][name] = arr
            else:
                mod_taps[mid].setdefault(name, [None, None])[chan] = arr
        for i, (mid, name) in enumerate(stap_slots):
            mod_taps[mid][name] = stap[i]

        for mid in region_order:
            k = _mid_key(mid)
            tp = {n: tuple(v) if isinstance(v, list) else v
                  for n, v in mod_taps[mid].items()}
            if specs[mid].tap_post is not None:
                tp = specs[mid].tap_post(tp)
            if tp:
                taps_all[k] = tp
            e0, en = exit_at[mid]
            new_state[k] = specs[mid].unpack(ef[e0:e0 + en], [], state[k])

        return new_state, taps_all

    return program
