"""One part of the whole-graph region program: the CUDA kernel's wrapper and
its plain twin, over one part and one plan, for one block or a batch.

``region_part_cuda`` replaces the TPU kernel built by
``mixlab_tpu/engine/pallas_graph.py:build_mega_program`` / ``_make_kernel``
(one ``pl.pallas_call`` per part of at most 192Ki samples).  It runs a
:class:`~mixlab_tpu_torch.dsp.base.RegionPlan` — the op list the region's
modules emitted — over one part of ``S`` samples:

    (plan, operands [S] each, pf, sf, S) -> (taps [n_taps, S], stap [n_stap],
                                             ef [n_ef])

``operands`` are the plan's first slots (f32, or i16 where an ``OP_I16``
reads them), ``pf`` the parameter row (param scalars, then the plan's
constants, unless ``consts`` holds those), ``sf`` the state row; ``ef`` comes
back laid out like ``sf`` (the layout law), so it is the next part's state
row.  The kernel is ``csrc/region.cu``: one cooperative launch per part that
walks the plan, each CTA over ``RUN`` contiguous chunks of 128 samples (a
longer run when the CTAs would not fit on the card at once,
``eq_cuda.scan_plan``), its EQ through the core the eq kernel uses
(``csrc/eq_scan.cuh``); see the source's header note for what bounds it.

``region_part_batched`` is the same part over B rows, what ``jax.vmap`` of
the TPU kernel computes for the fleet's sessions and the stems: each operand
``[B, S]`` (any row stride, unit sample stride) or ``[S]`` (one row every
instance shares, read with row stride 0, never expanded), ``pf`` ``[B, n_pf]``
or ``[n_pf]``, ``sf`` ``[B, n_ef]`` or ``[n_ef]``, the plan's constants one
row -> ``(taps [B, n_taps, S], stap [B, n_stap], ef [B, n_ef])``.  ONE launch
whatever B (``batch_plan``): the cooperative grid with ``gridDim.y = B`` where
B x its CTAs fit on the card, else a rows form (``csrc/rows.cuh``) in tiles
of ``128 * ROWS_RUN`` samples, whose operands each CTA stages in shared
memory while it runs the tile before: one CTA a row, or, where that leaves
most of the card idle (a few long rows), a decoupled look-back over as many
CTAs as the card holds, the rows' tiles taken by ticket and each EQ op's
carry passed on through a status array.  Under ``torch.func.vmap`` (the
batched program of ``engine.compiler.batched_program``) ``region_part_cuda``
becomes the custom op ``mixlab_tpu_torch::region_part``, whose batching rule
makes that one call.

``region_part_torch`` / ``region_part_torch_batched`` are the plain PyTorch
twins: the same plan, op by op, in the JAX emit's order and rounding, with
EqThree through ``eq_cuda.eq_cascade_torch_batched``; the single twin is the
batched one at B = 1.  The wrappers use them only for tensors on the CPU;
for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.dsp.base import (
    OP_AMP,
    OP_AMP_MOD,
    OP_EQ,
    OP_FILL,
    OP_I16,
    OP_MIX,
    OP_PEAK,
    OP_SYNC,
    OP_TAP,
    RegionPlan,
)
from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_torch_batched, scan_plan
from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

CHUNK = 128  # samples per chunk = threads per CTA of the kernel
# chunks a CTA owns (the EQ's run: samples a thread) while the CTAs fit on
# the card at once (the eq scan's sweep in PERF.md §6)
RUN = 4
# chunks one launch takes; the region program's parts stay below
MAX_CHUNKS = 4096
# the batched launch's forms (mixlab_region_part's `form`): the cooperative
# grid, and the rows forms (csrc/rows.cuh): one CTA a row, the look-back
FORM_GRID, FORM_ROWS, FORM_LOOKBACK = 0, 1, 2
# the dynamic shared memory the rows forms may ask for (a Hopper CTA may
# have 227 KB; csrc/region.cu kRowsShared)
ROWS_SHARED = 200 * 1024
# the rows forms' chunks a tile, halved while the tiles do not fit
# (8 beat 4 at 264-8,192 x 12,800: the rows sweep in PERF.md §6)
ROWS_RUN = 8
# a look-back tile's time against a tile of one CTA a row, at equal waves
# (1.55-1.61 at 1,024 x 12,800: the rows sweep in PERF.md §6)
LOOKBACK_COST = 1.6
RECORD_BYTES = 128  # a look-back status record of an EQ op (csrc/region.cu kRecord)
MAX_OPERANDS = 32   # the rows forms' i16 mask

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def region_part_torch_batched(plan: RegionPlan, operands: Sequence[torch.Tensor],
                              pf: torch.Tensor, sf: torch.Tensor, S: int,
                              consts: torch.Tensor, batch: int) -> Result:
    """Plain PyTorch run of ``plan`` over ``batch`` rows of one part of
    ``S`` samples (shapes as ``region_part_batched``'s)."""
    B, dev = batch, pf.device
    rows = lambda t, n: t.expand(B, n) if t.dim() == 1 else t
    prm = torch.cat([rows(pf, plan.n_pf), rows(consts.to(dev), consts.shape[-1])], dim=1)
    sfr = rows(sf, plan.n_ef)
    slots: List[Optional[torch.Tensor]] = (
        [v.expand(B, S) if v.dim() == 1 else v for v in operands]
        + [None] * (plan.n_slots - plan.n_operands))
    taps = torch.empty((B, plan.n_taps, S), dtype=torch.float32, device=dev)
    stap = torch.empty((B, plan.n_stap), dtype=torch.float32, device=dev)
    ef = torch.empty((B, plan.n_ef), dtype=torch.float32, device=dev)

    def col(i):  # parameter i of every row, [B, 1]
        return prm[:, i, None]

    for code, a in plan.ops():
        if code == OP_SYNC:
            continue
        if code == OP_FILL:
            slots[a[0]] = torch.zeros((B, S), dtype=torch.float32, device=dev) + col(a[1])
        elif code == OP_AMP:
            slots[a[0]] = slots[a[1]] * col(a[2])
        elif code == OP_AMP_MOD:
            md = col(a[4])
            scale = ((1.0 - md) + md * slots[a[2]]) * col(a[3])
            slots[a[0]] = slots[a[1]] * scale
        elif code == OP_MIX:
            n = a[1]
            # Python's sum, left to right from 0, as the JAX emit mixes
            slots[a[0]] = sum(col(a[2 + n + j]) * slots[a[2 + j]] for j in range(n))
        elif code == OP_I16:
            slots[a[0]] = slots[a[1]].to(torch.float32) * (1.0 / 32768.0)
        elif code == OP_TAP:
            taps[:, a[0]] = slots[a[1]]
        elif code == OP_PEAK:
            # amax lets a NaN through, as jnp.max does
            stap[:, a[0]] = torch.maximum(slots[a[1]].abs(), slots[a[2]].abs()).amax(dim=1)
        elif code == OP_EQ:
            dst, x, _, s0, g0, _, e0, sample_rate = a
            xs = slots[x]
            xd = torch.cat([sfr[:, s0 + 8:s0 + 11], xs], dim=1)[:, :S]  # eq_three.rs:71-79
            out, poles = eq_cascade_torch_batched(
                xs, xd, sfr[:, s0:s0 + 8].reshape(B, 4, 2), prm[:, g0:g0 + 3],
                _filter_coeff(FREQ_LO, sample_rate), _filter_coeff(FREQ_HI, sample_rate),
                VSA)
            ef[:, e0:e0 + 8] = poles.reshape(B, 8)
            ef[:, e0 + 8:e0 + 11] = xs[:, S - 3:]
            slots[dst] = out
        else:
            raise ValueError(f"region plan: unknown op code {code}")
    return taps, stap, ef


def _split(plan: RegionPlan, pf: torch.Tensor, consts):
    """``(param scalars, constants)``: ``consts`` where given, else the tail
    of ``pf`` (a single part's row)."""
    if consts is None:
        return pf[:plan.n_pf], pf[plan.n_pf:]
    return pf, consts


def region_part_torch(plan: RegionPlan, operands: Sequence[torch.Tensor],
                      pf: torch.Tensor, sf: torch.Tensor, S: int,
                      consts: Optional[torch.Tensor] = None) -> Result:
    """Plain PyTorch run of ``plan`` over one part of ``S`` samples: the
    batched twin at B = 1."""
    pf, consts = _split(plan, pf, consts)
    taps, stap, ef = region_part_torch_batched(plan, operands, pf, sf, S, consts, 1)
    return taps[0], stap[0], ef[0]


def operand_dtypes(plan: RegionPlan):
    """The dtype each operand slot must have: i16 where an ``OP_I16`` reads
    it, f32 everywhere else."""
    dtypes = [torch.float32] * plan.n_operands
    for code, a in plan.ops():
        if code == OP_I16 and a[1] < plan.n_operands:
            dtypes[a[1]] = torch.int16
    return dtypes


@functools.lru_cache(maxsize=None)
def resident_tiles(index: int) -> int:
    """CTAs of the region kernel's cooperative form that card ``index``
    holds at once."""
    return kernels.query("mixlab_region_resident_tiles", "region occupancy query", index)


class Shape(NamedTuple):
    """What sizes a plan's rows forms: operand and scratch slots, EQ ops."""
    n_operands: int
    n_scratch: int
    n_eq: int


def plan_shape(plan: RegionPlan) -> Shape:
    return Shape(plan.n_operands, plan.n_slots - plan.n_operands,
                 sum(code == OP_EQ for code, _ in plan.ops()))


def rows_shared_bytes(shape: Shape, run: int) -> int:
    """Dynamic shared memory of the rows forms (``csrc/region.cu``
    ``rows_floats``): two staged buffers of the operands' tiles, the scratch
    tiles, the EQ's staged tile, two carries of 12 floats an EQ op and an
    entry."""
    return 4 * ((2 * shape.n_operands + shape.n_scratch) * CHUNK * run
                + 2 * CHUNK * (run + 1) + (2 * shape.n_eq + 1) * 12)


def rows_run(shape: Shape, run: int = ROWS_RUN) -> int:
    """The rows forms' chunks a tile: ``run``, halved while the tiles do not
    fit ``ROWS_SHARED``.  Raises ``ValueError`` where even one chunk does not,
    or past ``MAX_OPERANDS``."""
    while run > 1 and rows_shared_bytes(shape, run) > ROWS_SHARED:
        run //= 2
    if rows_shared_bytes(shape, run) > ROWS_SHARED or shape.n_operands > MAX_OPERANDS:
        raise ValueError(f"region_part: {shape.n_operands} operands and {shape.n_scratch} "
                         "scratch slots do not fit a CTA's shared memory")
    return run


class BatchPlan(NamedTuple):
    """One batched launch: ``form`` (``FORM_*``), chunks a CTA's tile
    (``run``), tiles a row (``FORM_GRID``: a row's CTAs) and the launch's
    CTAs."""
    form: int
    run: int
    tiles: int
    ctas: int


def rows_plan(S: int, batch: int, shape: Shape, rows_resident: int,
              run: int = ROWS_RUN) -> BatchPlan:
    """The rows form for ``batch`` rows of one part of S samples on a card
    that holds ``rows_resident`` of its CTAs at once (of either form): the
    look-back over as many CTAs as it holds (at most one a tile) where its
    waves of tiles, each ``LOOKBACK_COST`` of a tile's time, end before one
    CTA a row's waves of rows do, else one CTA a row."""
    run = rows_run(shape, run)
    tiles = -(-(S // CHUNK) // run)
    if batch * tiles >= 2**31 or rows_resident < 1:
        raise ValueError(f"region_part: {batch} rows of {tiles} tiles are past the launch's "
                         "limits")
    waves = lambda n: -(-n // rows_resident)
    if LOOKBACK_COST * waves(batch * tiles) < waves(batch) * tiles:
        return BatchPlan(FORM_LOOKBACK, run, tiles, min(rows_resident, batch * tiles))
    return BatchPlan(FORM_ROWS, run, tiles, batch)


def batch_plan(S: int, batch: int, resident: int, shape: Shape,
               rows_resident: int) -> BatchPlan:
    """The launch for ``batch`` rows of one part of S samples: the
    cooperative grid of ``scan_plan`` (``tiles`` x ``batch`` CTAs of
    ``run`` chunks) where it fits the card (``resident`` of its CTAs at
    once), else ``rows_plan``."""
    try:
        run, tiles = scan_plan(S, resident, CHUNK, RUN, batch)
        return BatchPlan(FORM_GRID, run, tiles, tiles * batch)
    except ValueError:
        return rows_plan(S, batch, shape, rows_resident)


@functools.lru_cache(maxsize=None)
def rows_resident(index: int, shape: Shape) -> int:
    """CTAs of one CTA a row for plans of ``shape`` (at ``rows_run``) that
    card ``index`` holds at once (the look-back's are as many: the plan
    counts waves by it)."""
    return kernels.query("mixlab_region_rows_resident", "region rows occupancy query",
                         FORM_ROWS, rows_run(shape), *shape, index)


_SLOTS_KEPT = 16
_recent_slots: "collections.OrderedDict" = collections.OrderedDict()
_captured_slots: list = []


def _slot_table(table: tuple, dev: torch.device) -> torch.Tensor:
    """The launch's slot table on the card: uploaded from pinned memory (the
    upload does not wait for the work already queued), the last
    ``_SLOTS_KEPT`` kept by content.  While the stream is capturing a CUDA
    graph the table must be one of those (a graph's static tensors, called
    once before the capture, as a capture's warm-up does): a copy captured
    from a temporary pinned buffer would read freed memory at every
    replay."""
    key = (table, dev)
    if torch.cuda.is_current_stream_capturing():
        slots = _recent_slots.get(key)
        if slots is None:
            raise ValueError("region_part: a launch captured into a CUDA graph needs one call "
                             "with the same tensors before the capture")
        _captured_slots.append(slots)  # the graph may replay until the process ends
        return slots
    slots = torch.tensor(table, dtype=torch.int64).reshape(-1, 2).pin_memory().to(
        dev, non_blocking=True)
    _recent_slots[key] = slots
    _recent_slots.move_to_end(key)
    if len(_recent_slots) > _SLOTS_KEPT:
        _recent_slots.popitem(last=False)
    return slots


@functools.lru_cache(maxsize=64)
def _device_ops(words: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int32).to(device)


def _check_tensor(t, what, dtype, n, batch, index) -> int:
    """The row stride in bytes of ``t``: ``[batch, n]`` rows of unit element
    stride (any row stride), or ``[n]`` contiguous, one row every instance
    reads (row stride 0)."""
    if (isinstance(t, torch.Tensor) and t.is_cuda and t.get_device() == index
            and t.dtype == dtype and t.dim() in (1, 2) and t.shape[-1] == n
            and (t.dim() == 1 or t.shape[0] == batch) and (n <= 1 or t.stride(-1) == 1)):
        return t.stride(0) * t.element_size() if t.dim() == 2 else 0
    raise ValueError(
        f"region_part: {what}: expected a {dtype} tensor of shape ({n},) or ({batch}, {n}) "
        f"with unit element stride on {torch.device('cuda', index)}, got "
        f"{getattr(t, 'dtype', type(t))} {tuple(getattr(t, 'shape', ()))} on "
        f"{getattr(t, 'device', None)}")


def _launch(plan, operands, pf, sf, S, consts, batch, index, run=RUN, form=None) -> Result:
    """One launch over ``batch`` rows (shapes as ``region_part_batched``'s):
    ``batch_plan``'s form unless ``form`` forces one: ``FORM_GRID`` with at
    least ``run`` chunks a CTA, or a ``BatchPlan``."""
    if not (S > 0 and S % CHUNK == 0 and S // CHUNK <= MAX_CHUNKS):
        raise ValueError(f"region_part: S = {S} must be a positive multiple of {CHUNK} of at "
                         f"most {MAX_CHUNKS} chunks")
    if len(operands) != plan.n_operands:
        raise ValueError(f"region_part: {len(operands)} operands for a plan of "
                         f"{plan.n_operands}")
    dtypes = operand_dtypes(plan)
    strides = [_check_tensor(v, f"operand {i}", dt, S, batch, index)
               for i, (v, dt) in enumerate(zip(operands, dtypes))]
    pf_stride = _check_tensor(pf, "pf", torch.float32, plan.n_pf, batch, index)
    sf_stride = _check_tensor(sf, "sf", torch.float32, plan.n_ef, batch, index)
    if not (isinstance(consts, torch.Tensor) and consts.dim() == 1):
        raise ValueError("region_part: consts: the plan's constants are one 1-D row")
    _check_tensor(consts, "consts", torch.float32, plan.n_consts, batch, index)

    shape = plan_shape(plan)
    if form is None:
        bp = batch_plan(S, batch, resident_tiles(index), shape, rows_resident(index, shape))
    elif form == FORM_GRID:
        run, tiles = scan_plan(S, resident_tiles(index), CHUNK, run, batch)
        bp = BatchPlan(FORM_GRID, run, tiles, tiles * batch)
    else:
        bp = form
    dev = pf.device
    ops = _device_ops(tuple(plan.words), dev)
    table = [(v.data_ptr(), s) for v, s in zip(operands, strides)]
    if bp.form == FORM_GRID:
        scratch = torch.empty((batch, shape.n_scratch, S), dtype=torch.float32, device=dev)
        table += [(scratch[0, i].data_ptr(), 4 * shape.n_scratch * S)
                  for i in range(shape.n_scratch)]
    else:  # the scratch slots are tiles in shared memory
        table += [(0, 0)] * shape.n_scratch
    slots = _slot_table(tuple(table), dev)
    taps = torch.empty((batch, plan.n_taps, S), dtype=torch.float32, device=dev)
    stap = torch.empty((batch, plan.n_stap), dtype=torch.float32, device=dev)
    ef = torch.empty((batch, plan.n_ef), dtype=torch.float32, device=dev)
    i16 = sum(1 << i for i, dt in enumerate(dtypes) if dt == torch.int16)
    # only a look-back launch reads the status scratch, under its lock
    with kernels.status_lock if bp.form == FORM_LOOKBACK else contextlib.nullcontext():
        at = 0
        if bp.form == FORM_LOOKBACK:
            at = kernels.status_scratch(
                "region", index, 16 + 4 * -(-batch // 4) * 4
                + RECORD_BYTES * batch * bp.tiles * shape.n_eq).data_ptr()
        kernels.launch(
            "mixlab_region_part", "region kernel launch", index,
            ops.data_ptr(), ops.numel(), slots.data_ptr(), plan.n_operands, plan.n_slots,
            pf.data_ptr(), pf_stride // 4, plan.n_pf, consts.data_ptr(), sf.data_ptr(),
            sf_stride // 4, taps.data_ptr(), plan.n_taps, stap.data_ptr(), plan.n_stap,
            ef.data_ptr(), plan.n_ef, S, batch, bp.form, bp.run, bp.tiles, bp.ctas, shape.n_eq,
            i16, at,
        )
    region_part_cuda.launches += 1
    return taps, stap, ef


def region_part_cuda(plan: RegionPlan, operands: Sequence[torch.Tensor],
                     pf: torch.Tensor, sf: torch.Tensor, S: int,
                     consts: Optional[torch.Tensor] = None, run: int = RUN) -> Result:
    """One part of the region: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors.  ``consts``: the plan's constants (None: the tail
    of ``pf``); ``run``: chunks a CTA owns at the least.  Under
    ``torch.func.vmap`` it is the custom op ``mixlab_tpu_torch::region_part``,
    whose batching rule makes one ``region_part_batched`` call over the
    whole batch (the constants then one row every instance reads)."""
    if kernels.is_batched(pf, sf, *operands):
        pf, consts = _split(plan, pf, consts)
        return torch.ops.mixlab_tpu_torch.region_part(
            list(plan.words), plan.meta(), consts, list(operands), pf, sf, S)
    if pf.is_cpu:
        return region_part_torch(plan, operands, pf, sf, S, consts)
    index = kernels.cuda_index(pf, "region_part")
    if consts is not None:  # one row: the kernel reads the constants after the params
        pf = torch.cat([pf, consts])
    pf, consts = _split(plan, pf, None)
    taps, stap, ef = _launch(plan, operands, pf, sf, S, consts, 1, index, run, FORM_GRID)
    return taps[0], stap[0], ef[0]


region_part_cuda.launches = 0


def region_part_batched(plan: RegionPlan, operands: Sequence[torch.Tensor],
                        pf: torch.Tensor, sf: torch.Tensor, S: int, consts: torch.Tensor,
                        batch: int, run: int = RUN, form=None) -> Result:
    """One part of the region over ``batch`` rows, what ``jax.vmap`` of the
    TPU kernel computes: ONE kernel launch for CUDA tensors, whatever the
    batch (``batch_plan``, or the form ``form`` forces, with ``run``); the
    batched twin for CPU tensors."""
    if pf.is_cpu:
        return region_part_torch_batched(plan, operands, pf, sf, S, consts, batch)
    index = kernels.cuda_index(pf, "region_part")
    return _launch(plan, operands, pf, sf, S, consts, batch, index, run, form)


@torch.library.custom_op("mixlab_tpu_torch::region_part", mutates_args=())
def _region_part_op(words: List[int], meta: List[int], consts: torch.Tensor,
                    operands: List[torch.Tensor], pf: torch.Tensor, sf: torch.Tensor,
                    S: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    taps, stap, ef = region_part_cuda(RegionPlan.from_words(words, meta), operands, pf, sf, S,
                                      consts)
    return taps.clone(), stap.clone(), ef.clone()  # a custom op's outputs alias nothing


def _batch_first(t: torch.Tensor, dim) -> torch.Tensor:
    """A batched argument with its batch axis first and unit element
    stride; an unbatched one as it is (read with row stride 0)."""
    if dim is None:
        return t
    t = t.movedim(dim, 0)
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


@_region_part_op.register_vmap
def _region_part_vmap(info, in_dims, words, meta, consts, operands, pf, sf, S):
    if in_dims[2] is not None:
        raise ValueError("region_part: the plan's constants must be one row for every instance")
    out = region_part_batched(
        RegionPlan.from_words(words, meta),
        [_batch_first(v, d) for v, d in zip(operands, in_dims[3])],
        _batch_first(pf, in_dims[4]), _batch_first(sf, in_dims[5]), S, consts,
        info.batch_size)
    return out, (0, 0, 0)
