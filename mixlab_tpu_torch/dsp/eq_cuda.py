"""EqThree's 4-pole cascades and band mix: the CUDA kernel's wrapper and its
plain twin.

``eq_cascade_cuda`` replaces the TPU kernel
``mixlab_tpu/dsp/eq_pallas.py:eq_cascade_pallas`` (same contract:
``(x [S], xd [S], poles0 [4, 2], gains [3], f_lo, f_hi, vsa) ->
(out [S], poles [4, 2])``).  The kernel is ``csrc/eq_cascade.cu`` over the
core ``csrc/eq_scan.cuh``: one cooperative launch of ``tiles`` CTAs of
``THREADS`` threads, each thread a run of ``RUN`` consecutive samples.  A
thread runs both 4-stage cascades over its run from zero state, the runs'
affine maps compose by a scan (within the CTA, then across the CTAs after one
grid barrier), and each thread reruns its samples from its true entry state.
``scan_plan`` sizes the grid; see the source's header note for what bounds
it.

``eq_cascade_batched`` is the same block over B independent sequences
(``[B, S]``, each with its own poles and gains), what
``jax.vmap(eq_cascade_pallas)`` computes for the fleet's sessions and the
stems: ONE launch whatever B (``batch_plan``), the cooperative grid with
``gridDim.y = B`` where B x CTAs fit on the card, else one CTA a sequence
(``csrc/rows.cuh``) in tiles of ``ROWS_THREADS * ROWS_RUN`` samples, each
CTA staging its next tile while it runs this one.  Under ``torch.func.vmap``
``eq_cascade_cuda`` becomes the custom op ``mixlab_tpu_torch::eq_cascade``,
whose batching rule makes that one call.  Its twin is
``eq_cascade_torch_batched``; the single twin is it at B = 1.

``eq_cascade_torch`` is the plain PyTorch twin, the same math as
``_eq_body`` (``eq_pallas.py:80-137``): Toeplitz products as matrix
products and a Hillis-Steele scan of the chunk-end states.  The wrapper
uses it only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.  ``EqThreeDef`` also runs it directly, on either device, for
blocks below the kernel's gate (where the JAX package runs its plain path);
it raises while the process asks for TF32 (card) or bf16 (CPU) products
(``precision.py``).

The twin's tables are computed in float64 and stored as float32 exactly as
the JAX package builds them (``eq_three._toeplitz_tables``,
``eq_pallas._lane_tables``); the kernel's (``kernel_tables``) likewise in
float64, stored as float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.precision import require_ieee_f32

# blocks at least this long take the kernel (the JAX package's gate)
PALLAS_THRESHOLD = 8192
_CHUNK = 128  # the twin's chunk length (eq_pallas's C)
# the kernel's scan (csrc/eq_scan.cuh): THREADS threads a CTA, RUN samples a
# thread while the CTAs of a block fit on the card at once, else the shortest
# power-of-two run that fits, at most MAX_RUN
THREADS = 128
RUN = 4
MAX_RUN = 32
# the batched launch's forms (mixlab_eq_cascade's `form`): the cooperative
# grid, and one CTA a block (csrc/rows.cuh)
FORM_GRID, FORM_ROWS = 0, 1
# one CTA a block's tile, fixed in the kernel (eq_cascade.cu kRowsThreads,
# kRowsLg; the eq's rows sweeps in PERF.md §6): ROWS_THREADS threads of
# ROWS_RUN samples
ROWS_THREADS = 128
ROWS_RUN = 16
# longest block one launch takes; longer blocks split into sequential
# launches carrying the poles exactly
MAX_KERNEL_S = 384 * 1024
# the kernel's table (floats): a_b = 1 - f_b for the two bands, two pads,
# then for k < TABLE_POWERS and each band the first column of A_b^(2^k),
# the 4x4 lower-triangular Toeplitz map of one band's four stage states over
# 2^k samples without input (eq_scan.cuh kA, kPow, kPowers, kTable)
TABLE_A = 0
TABLE_POW = 4
TABLE_POWERS = 32
TABLE_LEN = TABLE_POW + TABLE_POWERS * 2 * 4
_AGG_WORDS = 8  # one CTA's aggregate state in the scratch (32 bytes)


def _plan(S: int):
    C = _CHUNK
    K = -(-S // C)
    return C, K, K * C - S


@functools.lru_cache(maxsize=8)
def _toeplitz_tables(a_tuple, C):
    """Per-lane lower-triangular Toeplitz T[l,i,j] = a_l^(i-j) (i>=j) and
    powers P[l,i] = a_l^(i+1), computed in f64 and stored f32 exactly as
    ``mixlab_tpu.dsp.eq_three._toeplitz_tables`` does."""
    a = np.asarray(a_tuple, dtype=np.float64)
    i = np.arange(C)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a[:, None, None] ** np.maximum(expo, 0)[None], 0.0)
    P = a[:, None] ** (i + 1)[None]
    return (
        T.astype(np.float32),
        P.astype(np.float32),
        (a**C).astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _lane_tables(a_lo: float, a_hi: float, C: int, K: int):
    """Per-band lane-axis constants (f64-computed, f32-stored):
    powk[b, k] = aC_b^(k+1), row[b, i] = a_b^(i+1) and the Hillis-Steele
    round factors aC_b^(2^r) (``eq_pallas._lane_tables``)."""
    out_pow = np.zeros((2, K), np.float64)
    row_pow = np.zeros((2, C), np.float64)
    factors = []
    for b, a in enumerate((a_lo, a_hi)):
        aC = float(a) ** C
        out_pow[b] = aC ** (np.arange(K) + 1)
        row_pow[b] = float(a) ** (np.arange(C) + 1)
        f, rounds = aC, []
        s = 1
        while s < K:
            rounds.append(f)
            f = f * f
            s *= 2
        factors.append(tuple(rounds))
    return out_pow.astype(np.float32), row_pow.astype(np.float32), tuple(factors)


@functools.lru_cache(maxsize=8)
def kernel_tables(f_lo: float, f_hi: float) -> np.ndarray:
    """The kernel's f32 table (``TABLE_*`` layout): a per band, then the
    transitions A_b^(2^k) by repeated squaring in float64.  A_b[i][j] =
    a*f^(i-j) for j <= i (stage i's state after a sample without input);
    the product of two lower-triangular Toeplitz matrices is one, with
    first column C @ d for first columns c, d."""
    t = np.zeros(TABLE_LEN, np.float64)
    for b, f in enumerate((float(f_lo), float(f_hi))):
        a = 1.0 - f
        t[TABLE_A + b] = a
        col = a * f ** np.arange(4.0)
        for k in range(TABLE_POWERS):
            at = TABLE_POW + (2 * k + b) * 4
            t[at:at + 4] = col
            col = np.array([sum(col[i - j] * col[j] for j in range(i + 1)) for i in range(4)])
    return t.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_tables(f_lo: float, f_hi: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_tables(f_lo, f_hi)).to(device)


def scan_plan(S: int, resident: int, threads: int = THREADS, run: int = RUN, batch: int = 1):
    """``(run, tiles)`` for ``batch`` blocks of S samples in one cooperative
    grid of ``batch * tiles`` CTAs on a card that holds ``resident`` of the
    kernel's CTAs at once: ``run`` samples a thread while the grid fits,
    else the shortest power of two that fits.  Raises ``ValueError`` past
    ``MAX_RUN``."""
    while batch * -(-S // (threads * run)) > max(resident, 1) and run <= MAX_RUN:
        run *= 2
    if run > MAX_RUN:
        raise ValueError(f"eq scan: {batch} x {S} samples do not fit {resident} CTAs of "
                         f"{threads} x {MAX_RUN} samples")
    return run, -(-S // (threads * run))


class BatchPlan(NamedTuple):
    """One batched launch: ``form`` (``FORM_*``), samples a thread (``run``),
    tiles a block (``FORM_GRID``: a block's CTAs), the launch's CTAs and
    threads a CTA."""
    form: int
    run: int
    tiles: int
    ctas: int
    threads: int


def rows_plan(S: int, batch: int, rows_resident: int) -> BatchPlan:
    """One CTA a block for ``batch`` blocks of S samples on a card that holds
    ``rows_resident`` of its CTAs at once: as many CTAs as the card holds, at
    most one a block, each walking its blocks in turn in tiles of
    ``ROWS_THREADS`` x ``ROWS_RUN``.  Raises ``ValueError`` past the
    kernel's limits."""
    if not (S >= 1 and batch >= 1 and rows_resident >= 1):
        raise ValueError(f"eq_cascade: no rows form for {batch} x {S} samples")
    tiles = -(-S // (ROWS_THREADS * ROWS_RUN))
    if batch * tiles >= 2**31:
        raise ValueError(f"eq_cascade: {batch} blocks of {tiles} tiles are past the launch's "
                         "limits")
    return BatchPlan(FORM_ROWS, ROWS_RUN, tiles, min(batch, rows_resident), ROWS_THREADS)


def batch_plan(S: int, batch: int, resident: int, rows_resident: int) -> BatchPlan:
    """The launch for ``batch`` blocks of S samples: the cooperative grid of
    ``scan_plan`` where it fits the card (``resident`` of its CTAs at once),
    else ``rows_plan``."""
    try:
        run, tiles = scan_plan(S, resident, THREADS, RUN, batch)
        return BatchPlan(FORM_GRID, run, tiles, tiles * batch, THREADS)
    except ValueError:
        return rows_plan(S, batch, rows_resident)


@functools.lru_cache(maxsize=None)
def resident_tiles(index: int, threads: int = THREADS) -> int:
    """CTAs of the eq kernel of ``threads`` threads that card ``index`` holds
    at once at the longest run."""
    return kernels.query("mixlab_eq_resident_tiles", "eq occupancy query", threads, index)


@functools.lru_cache(maxsize=None)
def rows_resident(index: int) -> int:
    """CTAs of one CTA a block that card ``index`` holds at once."""
    return kernels.query("mixlab_eq_rows_resident", "eq rows occupancy query", index)


def eq_cascade_torch_batched(x, xd, poles0, gains, f_lo: float, f_hi: float, vsa: float):
    """Plain PyTorch EqThree block over B independent sequences (the math of
    ``eq_pallas._eq_body``, which ``jax.vmap`` runs once per sequence):
    ``x``, ``xd`` [B, S], ``poles0`` [B, 4, 2], ``gains`` [B, 3] ->
    ``(out [B, S], poles [B, 4, 2])``.  Each stage's Toeplitz products are
    one matrix product over all B sequences' chunks, so a sequence's result
    does not depend on B.  Its products refuse to run in less than IEEE f32
    (``precision.py``)."""
    require_ieee_f32(x, "EqThree")
    B, S = x.shape
    C, K, pad = _plan(S)
    a_lo, a_hi = 1.0 - f_lo, 1.0 - f_hi
    dev = x.device

    def chunks(v):  # [B, S] -> [C, B, K]: chunk k of sequence b in column (b, k)
        return torch.nn.functional.pad(v, (0, pad)).reshape(B, K, C).permute(2, 0, 1)

    x2, xd2 = chunks(x), chunks(xd)
    Ts = [torch.from_numpy(_toeplitz_tables((a, a), C)[0][0]).to(dev)
          for a in (a_lo, a_hi)]
    pow_np, row_np, factors = _lane_tables(a_lo, a_hi, C, K)
    pow_v = torch.from_numpy(pow_np).to(dev)
    row_v = torch.from_numpy(row_np).to(dev)
    fs = (f_lo, f_hi)
    r0, k0 = (S - 1) % C, (S - 1) // C  # position of sample S-1

    Bs = [x2 * f_lo + vsa, x2 * f_hi + vsa]
    Y = [None, None]
    poles = [[None, None] for _ in range(4)]
    for s in range(4):
        for b in range(2):
            pole0 = poles0[:, s, b, None]  # [B, 1]
            # [C, B, K] zero-state chunk responses
            Z = (Ts[b] @ Bs[b].reshape(C, B * K)).reshape(C, B, K)
            carry = Z[C - 1]  # [B, K]
            step = 1
            for fct in factors[b]:
                shifted = torch.cat([carry.new_zeros(B, step), carry[:, :-step]], dim=1)
                carry = carry + float(np.float32(fct)) * shifted
                step *= 2
            y_end = carry + pow_v[b] * pole0
            y_prev = torch.cat([pole0, y_end[:, :-1]], dim=1)
            Yb = Z + row_v[b][:, None, None] * y_prev[None]
            poles[s][b] = Yb[r0, :, k0]
            Y[b] = Yb
            if s < 3:
                Bs[b] = Yb * fs[b]
    lo, hi_lp = Y
    g = gains.T[:, None, :, None]  # [3, 1, B, 1]
    out_ck = lo * g[0] + (hi_lp - lo) * g[1] + (xd2 - hi_lp) * g[2]
    out = out_ck.permute(1, 2, 0).reshape(B, K * C)[:, :S]
    return out, torch.stack([torch.stack(p, dim=1) for p in poles], dim=1)


def eq_cascade_torch(x, xd, poles0, gains, f_lo: float, f_hi: float, vsa: float):
    """Plain PyTorch EqThree block over one sequence ``x`` [S]: the batched
    twin at B = 1."""
    out, poles = eq_cascade_torch_batched(x[None], xd[None], poles0[None], gains[None],
                                          f_lo, f_hi, vsa)
    return out[0], poles[0]


def _check(t, shape, name, index):
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
            and t.shape == shape and t.is_contiguous() and t.is_cuda
            and t.get_device() == index):
        raise ValueError(
            f"eq_cascade {name}: expected a contiguous float32 tensor of shape "
            f"{shape} on {torch.device('cuda', index)}, got {getattr(t, 'dtype', type(t))} "
            f"{tuple(getattr(t, 'shape', ()))} on {getattr(t, 'device', None)}")


def _launch(x, xd, poles0, gains, f_lo, f_hi, vsa, index, threads=THREADS, run=RUN,
            plan=None):
    """One launch over ``x`` [S] (``poles0`` [4, 2], ``gains`` [3]) or over
    ``x`` [B, S] (``poles0`` [B, 4, 2], ``gains`` [B, 3]).  A batch takes
    ``batch_plan`` unless ``plan`` (a ``BatchPlan``) forces the form; one
    block takes the grid of ``scan_plan`` at ``threads`` x at least ``run``."""
    dev = x.device
    B, S = (1, x.shape[0]) if x.dim() == 1 else x.shape
    if plan is None and B > 1:
        plan = batch_plan(S, B, resident_tiles(index), rows_resident(index))
    elif plan is None:
        run, tiles = scan_plan(S, resident_tiles(index, threads), threads, run, B)
        plan = BatchPlan(FORM_GRID, run, tiles, tiles * B, threads)
    form, run, tiles, ctas, threads = plan
    tables = _device_tables(f_lo, f_hi, dev)
    # the output, the poles and (the grid) the CTAs' aggregates in one
    # allocation, the poles and the aggregates at 16-byte boundaries
    n = B * S
    at = -(-n // 4) * 4
    scratch = B * tiles * _AGG_WORDS if form == FORM_GRID else 0
    buf = torch.empty(at + 8 * B + scratch, dtype=torch.float32, device=dev)
    out = buf[:n].view(x.shape)
    poles_out = buf[at:at + 8 * B].view(poles0.shape)
    kernels.launch(
        "mixlab_eq_cascade", "eq_cascade kernel launch", index,
        x.data_ptr(), xd.data_ptr(), S, B, form, poles0.data_ptr(), gains.data_ptr(),
        tables.data_ptr(), float(f_lo), float(f_hi), float(vsa), run, threads, tiles, ctas,
        buf.data_ptr() + 4 * (at + 8 * B), out.data_ptr(), poles_out.data_ptr(),
    )
    eq_cascade_cuda.launches += 1
    return out, poles_out


def eq_cascade_cuda(
    x, xd, poles0, gains, f_lo: float, f_hi: float, vsa: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full EqThree block: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors.  Blocks over ``MAX_KERNEL_S`` run as sequential
    launches with the poles carried on the device.  Under ``torch.func.vmap``
    (the fleet's batched program) it is the custom op
    ``mixlab_tpu_torch::eq_cascade``, whose batching rule makes one
    ``eq_cascade_batched`` call over the whole batch."""
    if kernels.is_batched(x, xd, poles0, gains):
        return torch.ops.mixlab_tpu_torch.eq_cascade(x, xd, poles0, gains, f_lo, f_hi, vsa)
    if x.is_cpu:
        return eq_cascade_torch(x, xd, poles0, gains, f_lo, f_hi, vsa)
    index = kernels.cuda_index(x, "eq_cascade")
    S = x.shape[0] if x.dim() == 1 else -1
    if S <= 0:
        raise ValueError(f"eq_cascade: x must be a non-empty 1-D tensor, got {tuple(x.shape)}")
    _check(x, (S,), "x", index)
    _check(xd, (S,), "xd", index)
    _check(poles0, (4, 2), "poles0", index)
    _check(gains, (3,), "gains", index)
    if S <= MAX_KERNEL_S:
        return _launch(x, xd, poles0, gains, f_lo, f_hi, vsa, index)
    n_parts = -(-S // MAX_KERNEL_S)
    part = -(-S // n_parts)
    outs = []
    for i in range(n_parts):
        sl = slice(i * part, min((i + 1) * part, S))
        o, poles0 = _launch(x[sl], xd[sl], poles0, gains, f_lo, f_hi, vsa, index)
        outs.append(o)
    return torch.cat(outs), poles0


eq_cascade_cuda.launches = 0


def eq_cascade_batched(
    x, xd, poles0, gains, f_lo: float, f_hi: float, vsa: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EqThree over B independent blocks, what ``jax.vmap(eq_cascade_pallas)``
    computes: ``x``, ``xd`` [B, S], ``poles0`` [B, 4, 2], ``gains`` [B, 3] ->
    ``(out [B, S], poles [B, 4, 2])``.  ONE kernel launch for a CUDA tensor,
    whatever B and S (``batch_plan``); the batched twin for a CPU tensor."""
    if x.is_cpu:
        return eq_cascade_torch_batched(x, xd, poles0, gains, f_lo, f_hi, vsa)
    index = kernels.cuda_index(x, "eq_cascade")
    if not (x.dim() == 2 and x.shape[0] > 0 and 0 < x.shape[1] < 2**31):
        raise ValueError(f"eq_cascade_batched: x must be [B, S], got {tuple(x.shape)}")
    B, S = x.shape
    _check(x, (B, S), "x", index)
    _check(xd, (B, S), "xd", index)
    _check(poles0, (B, 4, 2), "poles0", index)
    _check(gains, (B, 3), "gains", index)
    return _launch(x, xd, poles0, gains, f_lo, f_hi, vsa, index)


@torch.library.custom_op("mixlab_tpu_torch::eq_cascade", mutates_args=())
def _eq_cascade_op(x: torch.Tensor, xd: torch.Tensor, poles0: torch.Tensor,
                   gains: torch.Tensor, f_lo: float, f_hi: float,
                   vsa: float) -> Tuple[torch.Tensor, torch.Tensor]:
    out, poles = eq_cascade_cuda(x, xd, poles0, gains, f_lo, f_hi, vsa)
    return out.clone(), poles.clone()  # a custom op's outputs alias nothing


@_eq_cascade_op.register_vmap
def _eq_cascade_vmap(info, in_dims, x, xd, poles0, gains, f_lo, f_hi, vsa):
    x, xd, poles0, gains = kernels.batch_first(info.batch_size, in_dims[:4], x, xd, poles0,
                                               gains)
    return eq_cascade_batched(x, xd, poles0, gains, f_lo, f_hi, vsa), (0, 0)
