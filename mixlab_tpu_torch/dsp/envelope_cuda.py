"""ADSR envelope over a block: the CUDA kernel's wrapper and its plain twin.

``envelope_block_cuda`` replaces the TPU kernel
``mixlab_tpu/dsp/envelope_pallas.py:envelope_block_pallas`` (same contract:
``(x [S], state, params, ms_per_sample) -> (out [S], new_state)``).  The
kernel is ``csrc/envelope.cu``: one cooperative launch of G CTAs over the
card's SMs, each a tile of ``TILE`` = 512 consecutive samples (256 threads
of ``LANE`` = 2 samples) staged in shared memory; the lanes' symbolic
records compose by warp-shuffle scans within a tile, and each tile composes
the aggregates of the tiles before it after one grid-wide barrier.  It is
latency-bound (the launch, the barrier and two block scans); see the
source's header note.  ``tile_plan`` sizes the grid.

``envelope_block_batched`` runs B independent blocks ``[B, S]`` with state
and params ``[B]`` (what ``jax.vmap(envelope_block_pallas)`` computes) in ONE
launch (``batch_plan``): the cooperative grid with ``gridDim.y = B`` where it
fits the card, else a rows form (``csrc/rows.cuh``) in tiles of 4,096 or
8,192 samples (``rows_lane``), each CTA staging its next tile while it runs
this one: one CTA a block, or, where that leaves most of the card idle (a
few long blocks), a decoupled look-back over as many CTAs as the card holds,
the blocks' tiles taken by ticket.  Under ``torch.func.vmap``
``envelope_block_cuda`` is the custom op ``mixlab_tpu_torch::envelope_block``,
whose batching rule makes that call.  Its twin is
``envelope_block_torch_batched``; the single twin is it at B = 1.

``envelope_block_torch`` is the plain PyTorch twin: the flat formulation of
``mixlab_tpu/dsp/envelope.py`` (running maxima over edge positions and a
gather for the captured release amplitude).  The wrapper uses it only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

State (dict of 0-d tensors): ``mode_on`` bool, ``on_pos`` / ``off_pos``
int32 sample offsets relative to the block start (clamped at
``POS_FLOOR``), ``off_amp`` f32.  Params: ``attack_ms``, ``decay_ms``,
``sustain_amplitude``, ``release_ms`` f32 0-d tensors.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from mixlab_tpu_torch import kernels

POS_FLOOR = -(2**30)
_SENTINEL = -(2**31) + 1
# the kernel's tiles (csrc/envelope.cu): THREADS threads a CTA, LANE samples
# a thread while the tiles of a block fit on the card at once (else the
# shortest lane that fits, at most MAX_LANE), at most MAX_TILES tiles
THREADS = 256
LANE = 2
TILE = THREADS * LANE
MAX_LANE = 16
MAX_TILES = THREADS
# longest block one launch takes: 128 co-resident tiles (one CTA on each of
# 128 SMs; an H100 has 132) of the longest lane.  Longer blocks split into
# sequential launches carrying the state exactly (as envelope_pallas.py
# does).
MAX_KERNEL_S = 128 * THREADS * MAX_LANE
_PAIR_WORDS = 16  # one tile's aggregate record in the scratch (64 bytes)
# the batched launch's forms (mixlab_envelope_block's `form`): the
# cooperative grid, and the rows forms (csrc/rows.cuh): one CTA a block, the
# look-back
FORM_GRID, FORM_ROWS, FORM_LOOKBACK = 0, 1, 2
# the rows forms' lanes: tiles of 4,096 samples, or of 8,192 where a block's
# last tile wastes under a tenth of it (the rows sweep in PERF.md §6)
ROWS_LANES = (16, 32)
# a look-back tile's time against a tile of one CTA a block, at equal waves
# (1.25-1.27 at 1,024 and 8,192 x 12,000: the rows sweep in PERF.md §6)
LOOKBACK_COST = 1.25
STATUS_BYTES = 96  # a look-back status record (csrc/envelope.cu Status)
_PARAMS = ("attack_ms", "decay_ms", "sustain_amplitude", "release_ms")
_STATE = ("mode_on", "on_pos", "off_pos", "off_amp")
_STATE_DTYPES = (torch.bool, torch.int32, torch.int32, torch.float32)


def _amp_on(ms_since_on, params):
    """Amplitude in TriggerOn state (envelope.rs:37-51)."""
    attack = params["attack_ms"]
    decay = params["decay_ms"]
    sustain = params["sustain_amplitude"]
    attack_amp = ms_since_on / attack
    decay_amp = 1.0 - torch.clamp((ms_since_on - attack) / decay, 0.0, 1.0)
    sustain_amp = sustain + (1.0 - sustain) * decay_amp
    return torch.where(ms_since_on < attack, attack_amp, sustain_amp)


def _last_index(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the last True at or before each position, -1 if none."""
    return torch.cummax(torch.where(mask, idx, -1), dim=-1).values


def envelope_block_torch_batched(
    x: torch.Tensor, state: Dict[str, torch.Tensor], params, ms_per_sample: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch envelope over B independent blocks ``x`` [B, S], with
    each block's state and params [B] (the flat path of
    ``mixlab_tpu/dsp/envelope.py:107-165``, which ``jax.vmap`` runs once per
    block)."""
    B, S = x.shape
    idx = torch.arange(S, dtype=torch.int32, device=x.device)
    col = {k: v[:, None] for k, v in state.items()}
    prm = {k: params[k][:, None] for k in _PARAMS}
    u_set = x == 1.0
    u_rst = x == 0.0

    # mode: last gate event wins (set/reset flip-flop)
    last_ev = _last_index(u_set | u_rst, idx)
    mode_after = torch.where(
        last_ev >= 0, torch.gather(u_set, 1, last_ev.clamp(min=0).long()), col["mode_on"]
    )
    mode_before = torch.cat([col["mode_on"], mode_after[:, :-1]], dim=1)

    rising = u_set & ~mode_before
    falling = u_rst & mode_before

    on_scan = torch.cummax(torch.where(rising, idx, _SENTINEL), dim=-1).values
    on_pos = torch.maximum(on_scan, col["on_pos"])
    ms_on = (idx - on_pos).to(torch.float32) * ms_per_sample
    cand = _amp_on(ms_on, prm)

    # off_amplitude: the ON amplitude captured at the last falling edge
    last_off = _last_index(falling, idx)
    in_block_off = last_off >= 0
    off_pos = torch.where(in_block_off, last_off, col["off_pos"])
    off_amp = torch.where(
        in_block_off, torch.gather(cand, 1, last_off.clamp(min=0).long()), col["off_amp"]
    )

    ms_off = (idx - off_pos).to(torch.float32) * ms_per_sample
    release_amp = 1.0 - torch.clamp(ms_off / prm["release_ms"], 0.0, 1.0)
    out = torch.where(mode_after, cand, off_amp * release_amp)

    new_state = {
        "mode_on": mode_after[:, -1],
        "on_pos": torch.clamp(on_pos[:, -1] - S, min=POS_FLOOR),
        "off_pos": torch.clamp(off_pos[:, -1] - S, min=POS_FLOOR),
        "off_amp": off_amp[:, -1],
    }
    return out, new_state


def envelope_block_torch(
    x: torch.Tensor, state: Dict[str, torch.Tensor], params, ms_per_sample: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch envelope over one block ``x`` [S] with 0-d state and
    params: the batched twin at B = 1."""
    out, st = envelope_block_torch_batched(
        x[None], {k: v.reshape(1) for k, v in state.items()},
        {k: params[k].reshape(1) for k in _PARAMS}, ms_per_sample)
    return out[0], {k: v[0] for k, v in st.items()}


def _check_scalar(t, dtype, index, name):
    if not (isinstance(t, torch.Tensor) and t.dtype == dtype and t.is_cuda
            and t.get_device() == index and t.numel() == 1):
        raise ValueError(
            f"envelope {name}: expected a one-element {dtype} tensor on "
            f"{torch.device('cuda', index)}, got {getattr(t, 'dtype', type(t))} on "
            f"{getattr(t, 'device', None)}")


def tile_plan(S: int, resident: int, lane: int = LANE, batch: int = 1):
    """``(lane, tiles)`` for ``batch`` blocks of S samples in one cooperative
    grid of ``batch * tiles`` CTAs on a card that holds ``resident`` of the
    kernel's CTAs at once: ``lane`` samples a thread while the grid fits,
    else the shortest lane that fits.  Raises ``ValueError`` past
    ``MAX_LANE``."""
    cap = min(resident // batch, MAX_TILES)
    lane = max(lane, -(-S // (max(cap, 1) * THREADS)))
    if cap < 1 or lane > MAX_LANE:
        raise ValueError(f"envelope: {batch} x {S} samples do not fit {resident} tiles of at "
                         f"most {THREADS * MAX_LANE}")
    return lane, -(-S // (THREADS * lane))


class BatchPlan(NamedTuple):
    """One batched launch: ``form`` (``FORM_*``), samples a thread
    (``lane``), tiles a block (``FORM_GRID``: a block's CTAs) and the
    launch's CTAs."""
    form: int
    lane: int
    tiles: int
    ctas: int


def rows_lane(S: int) -> int:
    """The rows forms' lane for blocks of S samples: the longest of
    ``ROWS_LANES`` whose tiles pad a block by under a tenth."""
    fit = [lane for lane in ROWS_LANES
           if -(-S // (THREADS * lane)) * THREADS * lane * 10 < 11 * S]
    return max(fit, default=ROWS_LANES[0])


def rows_plan(S: int, batch: int, rows_resident: int, lane=None) -> BatchPlan:
    """The rows form for ``batch`` blocks of S samples on a card that holds
    ``rows_resident`` of its CTAs at once (of either form): the look-back
    over as many CTAs as it holds (at most one a tile) where its waves of
    tiles, each ``LOOKBACK_COST`` of a tile's time, end before one CTA a
    block's waves of blocks do, else one CTA a block.  ``lane``: samples a
    thread (``rows_lane`` by default).  Raises ``ValueError`` past the
    kernel's limits."""
    lane = rows_lane(S) if lane is None else lane
    tiles = -(-S // (THREADS * lane))
    if not (S >= 1 and batch >= 1 and lane in (1, 2, 4, 8, 16, 32)
            and batch * tiles < 2**31 and rows_resident >= 1):
        raise ValueError(f"envelope: no rows form for {batch} x {S} samples at lane {lane}")
    waves = lambda n: -(-n // rows_resident)
    if LOOKBACK_COST * waves(batch * tiles) < waves(batch) * tiles:
        return BatchPlan(FORM_LOOKBACK, lane, tiles, min(rows_resident, batch * tiles))
    return BatchPlan(FORM_ROWS, lane, tiles, batch)


def batch_plan(S: int, batch: int, resident: int, rows_resident: int) -> BatchPlan:
    """The launch for ``batch`` blocks of S samples: the cooperative grid of
    ``tile_plan`` where it fits the card (``resident`` of its CTAs at once),
    else ``rows_plan``."""
    try:
        lane, tiles = tile_plan(S, resident, LANE, batch)
        return BatchPlan(FORM_GRID, lane, tiles, tiles * batch)
    except ValueError:
        return rows_plan(S, batch, rows_resident)


@functools.lru_cache(maxsize=None)
def resident_tiles(index: int) -> int:
    """CTAs of the envelope kernel that card ``index`` holds at once."""
    return kernels.query("mixlab_envelope_resident_tiles", "envelope occupancy query", index)


@functools.lru_cache(maxsize=None)
def rows_resident(index: int, lane: int) -> int:
    """CTAs of one CTA a block at ``lane`` that card ``index`` holds at once
    (the look-back's are as many: the plan counts waves by it)."""
    return kernels.query("mixlab_envelope_rows_resident", "envelope rows occupancy query",
                         FORM_ROWS, lane.bit_length() - 1, index)


def _launch(x, index, state, params, ms_per_sample, lane=LANE, plan=None):
    """One launch over ``x`` [S] (0-d state and params) or ``x`` [B, S]
    (state and params [B]).  A batch takes ``batch_plan`` unless ``plan``
    (a ``BatchPlan``) forces the form."""
    dev = x.device
    B, S = (1, x.shape[0]) if x.dim() == 1 else x.shape
    if plan is None and B > 1:
        plan = batch_plan(S, B, resident_tiles(index), rows_resident(index, rows_lane(S)))
    elif plan is None:
        lane, tiles = tile_plan(S, resident_tiles(index), lane, B)
        plan = BatchPlan(FORM_GRID, lane, tiles, tiles)
    form, lane, tiles, ctas = plan
    # the output and, past it at a 16-byte boundary, the tiles' scratch of
    # the cooperative grid: one allocation
    n = B * S
    at = -(-n // 4) * 4
    buf = torch.empty(at + (B * tiles * _PAIR_WORDS if form == FORM_GRID else 0),
                      dtype=torch.float32, device=dev)
    out = buf[:n].view(x.shape)
    shape = x.shape[:-1]
    new_state = {
        "mode_on": torch.empty(shape, dtype=torch.bool, device=dev),
        "on_pos": torch.empty(shape, dtype=torch.int32, device=dev),
        "off_pos": torch.empty(shape, dtype=torch.int32, device=dev),
        "off_amp": torch.empty(shape, dtype=torch.float32, device=dev),
    }
    # only a look-back launch reads the status scratch, under its lock
    with kernels.status_lock if form == FORM_LOOKBACK else contextlib.nullcontext():
        scratch = buf.data_ptr() + 4 * at
        if form == FORM_LOOKBACK:
            scratch = kernels.status_scratch(
                "envelope", index, 16 + STATUS_BYTES * B * tiles).data_ptr()
        kernels.launch(
            "mixlab_envelope_block", "envelope kernel launch", index,
            x.data_ptr(), out.data_ptr(), S, B, form, lane, tiles, ctas, scratch,
            *(params[k].data_ptr() for k in _PARAMS), float(ms_per_sample),
            state["mode_on"].data_ptr(), state["on_pos"].data_ptr(),
            state["off_pos"].data_ptr(), state["off_amp"].data_ptr(),
            new_state["mode_on"].data_ptr(), new_state["on_pos"].data_ptr(),
            new_state["off_pos"].data_ptr(), new_state["off_amp"].data_ptr(),
        )
    envelope_block_cuda.launches += 1
    return out, new_state


def envelope_block_cuda(
    x: torch.Tensor, state: Dict[str, torch.Tensor], params, ms_per_sample: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Envelope over ``x`` [S]: the CUDA kernel for a CUDA tensor, the plain
    twin for a CPU tensor.  Blocks over ``MAX_KERNEL_S`` run as sequential
    launches with the state carried on the device.  Under
    ``torch.func.vmap`` it is the custom op ``mixlab_tpu_torch::envelope_block``,
    whose batching rule makes one ``envelope_block_batched`` call."""
    if kernels.is_batched(x, *state.values(), *params.values()):
        out, *st = torch.ops.mixlab_tpu_torch.envelope_block(
            x, *(state[k] for k in _STATE), *(params[k] for k in _PARAMS),
            float(ms_per_sample))
        return out, dict(zip(_STATE, st))
    if x.is_cpu:
        return envelope_block_torch(x, state, params, ms_per_sample)
    index = kernels.cuda_index(x, "envelope")
    if not (x.dim() == 1 and x.dtype is torch.float32 and x.is_contiguous()
            and 0 < x.shape[0] < 2**30):
        raise ValueError(
            "envelope: x must be a contiguous 1-D float32 tensor of 1..2**30 "
            f"samples, got {tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    _check_scalar(state["mode_on"], torch.bool, index, "mode_on")
    _check_scalar(state["on_pos"], torch.int32, index, "on_pos")
    _check_scalar(state["off_pos"], torch.int32, index, "off_pos")
    _check_scalar(state["off_amp"], torch.float32, index, "off_amp")
    for k in _PARAMS:
        _check_scalar(params[k], torch.float32, index, k)

    S = x.shape[0]
    if S <= MAX_KERNEL_S:
        return _launch(x, index, state, params, ms_per_sample)
    n_parts = -(-S // MAX_KERNEL_S)
    part = -(-S // n_parts)
    outs = []
    for i in range(n_parts):
        o, state = _launch(x[i * part : min((i + 1) * part, S)], index, state, params,
                           ms_per_sample)
        outs.append(o)
    return torch.cat(outs), state


envelope_block_cuda.launches = 0


def envelope_block_batched(
    x: torch.Tensor, state: Dict[str, torch.Tensor], params, ms_per_sample: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The envelope over B independent blocks ``x`` [B, S] with state and
    params [B], what ``jax.vmap(envelope_block_pallas)`` computes: ONE kernel
    launch for a CUDA tensor, whatever B and S (``batch_plan``); the batched
    twin for a CPU tensor."""
    if x.is_cpu:
        return envelope_block_torch_batched(x, state, params, ms_per_sample)
    index = kernels.cuda_index(x, "envelope")
    if not (x.dim() == 2 and x.dtype is torch.float32 and x.is_contiguous()
            and x.shape[0] > 0 and 0 < x.shape[1] < 2**30):
        raise ValueError(
            "envelope_block_batched: x must be a contiguous [B, S] float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    B = x.shape[0]
    for name, t, dtype in [*((k, state[k], d) for k, d in zip(_STATE, _STATE_DTYPES)),
                           *((k, params[k], torch.float32) for k in _PARAMS)]:
        if not (isinstance(t, torch.Tensor) and t.dtype == dtype and t.is_cuda
                and t.get_device() == index and t.shape == (B,) and t.is_contiguous()):
            raise ValueError(
                f"envelope_block_batched {name}: expected a contiguous {dtype} tensor of shape "
                f"({B},) on {torch.device('cuda', index)}, got {getattr(t, 'dtype', type(t))} "
                f"{tuple(getattr(t, 'shape', ()))} on {getattr(t, 'device', None)}")
    return _launch(x, index, state, params, ms_per_sample)


@torch.library.custom_op("mixlab_tpu_torch::envelope_block", mutates_args=())
def _envelope_op(x: torch.Tensor, mode_on: torch.Tensor, on_pos: torch.Tensor,
                 off_pos: torch.Tensor, off_amp: torch.Tensor, attack_ms: torch.Tensor,
                 decay_ms: torch.Tensor, sustain_amplitude: torch.Tensor,
                 release_ms: torch.Tensor, ms_per_sample: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    out, st = envelope_block_cuda(
        x, dict(zip(_STATE, (mode_on, on_pos, off_pos, off_amp))),
        dict(zip(_PARAMS, (attack_ms, decay_ms, sustain_amplitude, release_ms))),
        ms_per_sample)
    return out.clone(), *(st[k].clone() for k in _STATE)  # outputs alias nothing


@_envelope_op.register_vmap
def _envelope_vmap(info, in_dims, x, *rest):
    *tensors, ms_per_sample = rest
    x, *tensors = kernels.batch_first(info.batch_size, in_dims, x, *tensors)
    out, st = envelope_block_batched(x, dict(zip(_STATE, tensors[:4])),
                                     dict(zip(_PARAMS, tensors[4:])), ms_per_sample)
    return (out, *(st[k] for k in _STATE)), (0,) * 5
