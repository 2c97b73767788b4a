"""One part of the whole-graph region program: the CUDA kernel's wrapper and
its plain twin, both over one part and one plan.

``region_part_cuda`` replaces the TPU kernel built by
``mixlab_tpu/engine/pallas_graph.py:build_mega_program`` / ``_make_kernel``
(one ``pl.pallas_call`` per part of at most 192Ki samples).  It runs a
:class:`~mixlab_tpu_torch.dsp.base.RegionPlan` — the op list the region's
modules emitted — over one part of ``S`` samples:

    (plan, operands [S] each, pf, sf, S) -> (taps [n_taps, S], stap [n_stap],
                                             ef [n_ef])

``operands`` are the plan's first slots (f32, or i16 where an ``OP_I16``
reads them), ``pf`` the parameter row (param scalars, then the plan's
constants), ``sf`` the state row; ``ef`` comes back laid out like ``sf``
(the layout law), so it is the next part's state row.  The kernel is
``csrc/region.cu``: one cooperative launch per part that walks the plan,
each CTA over ``RUN`` contiguous chunks of 128 samples (a longer run when
the CTAs would not fit on the card at once, ``eq_cuda.scan_plan``), its EQ
through the core the eq kernel uses (``csrc/eq_scan.cuh``); see the
source's header note for what bounds it.

``region_part_torch`` is the plain PyTorch twin: the same plan, op by op,
in the JAX emit's order and rounding, with EqThree through
``eq_cuda.eq_cascade_torch``.  The wrapper uses it only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

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
from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_torch, scan_plan
from mixlab_tpu_torch.dsp.eq_three import FREQ_HI, FREQ_LO, VSA, _filter_coeff

CHUNK = 128  # samples per chunk = threads per CTA of the kernel
# chunks a CTA owns (the EQ's run: samples a thread) while the CTAs fit on
# the card at once (chip_smoke.py phase 7 sweeps it)
RUN = 4
# chunks one launch takes; the region program's parts stay below
MAX_CHUNKS = 4096

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def region_part_torch(plan: RegionPlan, operands: Sequence[torch.Tensor],
                      pf: torch.Tensor, sf: torch.Tensor, S: int) -> Result:
    """Plain PyTorch run of ``plan`` over one part of ``S`` samples."""
    dev = pf.device
    slots = list(operands) + [None] * (plan.n_slots - plan.n_operands)
    taps = torch.empty((plan.n_taps, S), dtype=torch.float32, device=dev)
    stap = torch.empty((plan.n_stap,), dtype=torch.float32, device=dev)
    ef = torch.empty((plan.n_ef,), dtype=torch.float32, device=dev)
    for code, a in plan.ops():
        if code == OP_SYNC:
            continue
        if code == OP_FILL:
            slots[a[0]] = torch.zeros(S, dtype=torch.float32, device=dev) + pf[a[1]]
        elif code == OP_AMP:
            slots[a[0]] = slots[a[1]] * pf[a[2]]
        elif code == OP_AMP_MOD:
            md = pf[a[4]]
            scale = ((1.0 - md) + md * slots[a[2]]) * pf[a[3]]
            slots[a[0]] = slots[a[1]] * scale
        elif code == OP_MIX:
            n = a[1]
            # Python's sum, left to right from 0, as the JAX emit mixes
            slots[a[0]] = sum(pf[a[2 + n + j]] * slots[a[2 + j]] for j in range(n))
        elif code == OP_I16:
            slots[a[0]] = slots[a[1]].to(torch.float32) * (1.0 / 32768.0)
        elif code == OP_TAP:
            taps[a[0]] = slots[a[1]]
        elif code == OP_PEAK:
            stap[a[0]] = torch.maximum(slots[a[1]].abs(), slots[a[2]].abs()).max()
        elif code == OP_EQ:
            dst, x, _, s0, g0, _, e0, sample_rate = a
            xs = slots[x]
            xd = torch.cat([sf[s0 + 8:s0 + 11], xs])[:S]  # eq_three.rs:71-79
            out, poles = eq_cascade_torch(
                xs, xd, sf[s0:s0 + 8].reshape(4, 2), pf[g0:g0 + 3],
                _filter_coeff(FREQ_LO, sample_rate), _filter_coeff(FREQ_HI, sample_rate),
                VSA)
            ef[e0:e0 + 8] = poles.reshape(-1)
            ef[e0 + 8:e0 + 11] = xs[S - 3:]
            slots[dst] = out
        else:
            raise ValueError(f"region plan: unknown op code {code}")
    return taps, stap, ef


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
    """CTAs of the region kernel that card ``index`` holds at once."""
    return kernels.query("mixlab_region_resident_tiles", "region occupancy query", index)


@functools.lru_cache(maxsize=64)
def _device_ops(words: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int32).to(device)


def _check_tensor(t, what, dtype, dtype_text, n, index) -> None:
    if not (isinstance(t, torch.Tensor) and t.is_cuda and t.get_device() == index
            and t.dtype == dtype and t.shape == (n,) and t.is_contiguous()):
        raise ValueError(
            f"region_part: {what}: expected a contiguous {dtype_text} tensor of shape ({n},) on "
            f"{torch.device('cuda', index)}, got {getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} on {getattr(t, 'device', None)}")


def region_part_cuda(plan: RegionPlan, operands: Sequence[torch.Tensor],
                     pf: torch.Tensor, sf: torch.Tensor, S: int, run: int = RUN) -> Result:
    """One part of the region: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors.  ``run``: chunks a CTA owns at the least."""
    if pf.is_cpu:
        return region_part_torch(plan, operands, pf, sf, S)
    index = kernels.cuda_index(pf, "region_part")
    if not (S > 0 and S % CHUNK == 0 and S // CHUNK <= MAX_CHUNKS):
        raise ValueError(f"region_part: S = {S} must be a positive multiple of {CHUNK} of at "
                         f"most {MAX_CHUNKS} chunks")
    if len(operands) != plan.n_operands:
        raise ValueError(f"region_part: {len(operands)} operands for a plan of "
                         f"{plan.n_operands}")
    for i, (v, dt) in enumerate(zip(operands, operand_dtypes(plan))):
        _check_tensor(v, f"operand {i}", dt, dt, S, index)
    _check_tensor(pf, "pf", torch.float32, "float32", plan.n_pf + plan.n_consts, index)
    _check_tensor(sf, "sf", torch.float32, "float32", plan.n_ef, index)

    dev = pf.device
    run, tiles = scan_plan(S, resident_tiles(index), CHUNK, run)
    ops = _device_ops(tuple(plan.words), dev)
    scratch = torch.empty((plan.n_slots - plan.n_operands, S), dtype=torch.float32,
                          device=dev)
    # pinned, so the upload does not wait for the work already queued
    ptrs = torch.tensor([v.data_ptr() for v in operands]
                        + [scratch[i].data_ptr() for i in range(scratch.shape[0])],
                        dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    taps = torch.empty((plan.n_taps, S), dtype=torch.float32, device=dev)
    stap = torch.empty((plan.n_stap,), dtype=torch.float32, device=dev)
    ef = torch.empty((plan.n_ef,), dtype=torch.float32, device=dev)
    kernels.launch(
        "mixlab_region_part", "region kernel launch", index,
        ops.data_ptr(), ops.numel(), ptrs.data_ptr(), pf.data_ptr(),
        sf.data_ptr(), taps.data_ptr(), stap.data_ptr(), plan.n_stap,
        ef.data_ptr(), S, run, tiles,
    )
    region_part_cuda.launches += 1
    return taps, stap, ef


region_part_cuda.launches = 0
