"""Polyphase bicubic resize through a hand-written kernel
(port of ``mixlab_tpu/video/resize_pallas.py``).

The dense resize (``video/scale.py``) multiplies by a [n_out, n_in] matrix
that is ~99% zeros: bicubic reads 4-9 inputs per output.  For a rational
ratio n_out/n_in = L/M the nonzero taps repeat every L outputs, so output
``o = q·L + p`` is

    sum over taps j (ascending, zero weights skipped) of
        w[p, j] · x[clamp(q·M + base[p] + j, 0, n_in - 1)]

with one [L, J] weight table and L bases per axis (``_phase_plan``, the same
Mitchell weights, antialias support and edge clamping as
``scale.resize_matrix``, so the result matches the dense resize within
1 LSB).  Ratios with L > ``MAX_PHASES`` phases or more than ``MAX_TAPS``
taps have no plan (``can_resize_polyphase``).

  * ``resize_axis_cuda`` — one axis of a plane: the kernel
    (``csrc/resize.cu``) for CUDA tensors, which replaces the TPU kernel
    ``_axis0_kernel`` / ``_resize_axis0``
    (``mixlab_tpu/video/resize_pallas.py:143``); the plain twin for CPU
    tensors; any other device raises.
  * ``resize_axis_torch`` — its plain twin.
  * ``resize_plane_polyphase`` — a [H, W] u8 plane, rows then columns, as
    ``resize_plane_pallas``: u8 → bf16 → u8, two launches when both axes
    change.

Rounding, as the JAX package's kernel computes on the CPU (interpret mode):
sums in f32 in tap order, the first term a plain product and each later one
``acc + w·x`` with ONE rounding (XLA's CPU backend contracts it into a fused
multiply-add); the pass's result rounded to bf16; the last pass then rounds
half to even and clips to u8.  The twin forms each fused step as an exact
float64 sum rounded to odd and then to f32, which is the fused step's single
rounding (the float64 product of an f32 weight and a u8 or bf16 input is
exact), so it equals the JAX package's interpret-mode result and the
kernel's ``fmaf`` bit for bit.  A twin with a separate multiply and add
differs by up to 2 LSB: the bf16 step is 1.0 from 128 up.

The ratios need not come from this module's callers: the letterbox
(``scale.scale_picture``) keeps the dense products, as the JAX package does.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.video.scale import _mitchell

MAX_PHASES = 16  # csrc/resize.cu kMaxPhases
MAX_TAPS = 12    # csrc/resize.cu kMaxTaps
_OUT_TYPES = (torch.bfloat16, torch.uint8)


@functools.lru_cache(maxsize=256)
def _phase_plan(n_in: int, n_out: int):
    """Polyphase decomposition of the dense resize matrix.

    Returns (L, M, J, bases[L] (python ints), weights [L, J] f32,
    pad_lo, pad_hi, Q) or None when the ratio is unsuitable."""
    if n_in == n_out:
        return None
    fr = Fraction(n_out, n_in)
    L, M = fr.numerator, fr.denominator
    if L > MAX_PHASES:
        return None
    if n_out % L:
        return None
    scale = n_in / n_out
    support = 2.0 * max(scale, 1.0)
    kscale = 1.0 / scale if scale > 1.0 else 1.0
    if 2 * support + 1 > MAX_TAPS:
        return None
    Q = n_out // L
    # output o = q*L + p samples input at pos = (o+0.5)*M/L - 0.5
    #          = q*M + ((p+0.5)*M/L - 0.5)
    bases = []
    weights = []
    J = 0
    per_phase = []
    for p in range(L):
        frac = (p + 0.5) * M / L - 0.5
        lo = int(math.floor(frac - support)) + 1
        hi = int(math.ceil(frac + support))
        idx = np.arange(lo, hi + 1)
        w = _mitchell((idx - frac) * (min(1.0, kscale) if scale > 1.0 else 1.0))
        w = w / w.sum()
        per_phase.append((lo, w))
        J = max(J, len(w))
    for lo, w in per_phase:
        bases.append(lo)
        weights.append(np.pad(w, (0, J - len(w))))
    W = np.asarray(weights, dtype=np.float32)
    # padding so every (q*M + bases[p] + j) lands in [0, Hp)
    pad_lo = max(0, -min(bases))
    max_idx = (Q - 1) * M + max(b for b in bases) + J - 1
    pad_hi = max(0, max_idx - (n_in - 1))
    return L, M, J, tuple(int(b) for b in bases), W, pad_lo, pad_hi, Q


def can_resize_polyphase(in_h: int, in_w: int, out_h: int, out_w: int) -> bool:
    ok_h = in_h == out_h or _phase_plan(in_h, out_h) is not None
    ok_w = in_w == out_w or _phase_plan(in_w, out_w) is not None
    return ok_h and ok_w


def _plan(n_in: int, n_out: int):
    plan = _phase_plan(n_in, n_out)
    kernels.require(plan is not None,
                    f"resize: no polyphase plan for {n_in} -> {n_out} "
                    f"(at most {MAX_PHASES} phases and {MAX_TAPS} taps)")
    return plan


@functools.lru_cache(maxsize=256)
def _row_taps(n_in: int, n_out: int):
    """Per output row, the plan's taps as (idx [n_out, J] int64, w [n_out,
    J] f32): row o = q*L + p reads x[idx[o, j]] with weight w[o, j]."""
    L, M, J, bases, W, _, _, Q = _plan(n_in, n_out)
    o = np.arange(n_out)
    q, p = o // L, o % L
    idx = q[:, None] * M + np.asarray(bases)[p][:, None] + np.arange(J)[None, :]
    return np.clip(idx, 0, n_in - 1).astype(np.int64), W[p]


def _fma_f32(acc: torch.Tensor, prod: torch.Tensor) -> torch.Tensor:
    """f32 ``acc + prod`` with one rounding, for an exact float64 ``prod``:
    the float64 sum with its exact error (TwoSum), rounded to odd (an
    inexact sum with an even last bit moves one ulp toward the exact value),
    then to f32 — correct, since float64 carries more than 24 + 2 bits."""
    a = acc.to(torch.float64)
    s = a + prod
    bb = s - a
    err = (a - (s - bb)) + (prod - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _epilogue(acc: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """An f32 pass result -> bf16, or -> bf16 -> round half to even -> clip
    -> u8 for the last pass."""
    y = acc.to(torch.bfloat16)
    if out_dtype == torch.bfloat16:
        return y
    return torch.clamp(torch.round(y.to(torch.float32)), 0, 255).to(torch.uint8)


def resize_axis_torch(x: torch.Tensor, n_out: int, axis: int,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain twin of the kernel: resize ``axis`` of a [A, B] u8 or bf16
    tensor to ``n_out`` in the kernel's (and the JAX package's) rounding, on
    ``x``'s device; ``out_dtype`` bf16, or u8 for the last pass."""
    kernels.require(out_dtype in _OUT_TYPES, f"resize: out_dtype {out_dtype}")
    n_in = x.shape[axis]
    idx, w = _row_taps(n_in, n_out)
    rows = x if axis == 0 else x.t()
    idx_t = torch.from_numpy(idx).to(x.device)
    w_t = torch.from_numpy(w).to(x.device)
    acc = torch.zeros((n_out, rows.shape[1]), dtype=torch.float32, device=x.device)
    started = torch.zeros((n_out, 1), dtype=torch.bool, device=x.device)
    for j in range(idx.shape[1]):
        wj = w_t[:, j:j + 1]
        prod = wj.to(torch.float64) * rows[idx_t[:, j]].to(torch.float64)  # exact
        step = torch.where(started, _fma_f32(acc, prod), prod.to(torch.float32))
        acc = torch.where(wj != 0, step, acc)  # zero weights are skipped
        started = started | (wj != 0)
    out = _epilogue(acc, out_dtype)
    return out if axis == 0 else out.t().contiguous()


@functools.lru_cache(maxsize=64)
def _device_plan(n_in: int, n_out: int, device: torch.device):
    """The plan's weights [L, J] f32 and bases [L] int32 on ``device``,
    uploaded once (the kernel stages them into shared memory)."""
    _, _, _, bases, W, _, _, _ = _plan(n_in, n_out)
    return (torch.from_numpy(np.ascontiguousarray(W)).to(device),
            torch.tensor(bases, dtype=torch.int32, device=device))


def resize_axis_cuda(x: torch.Tensor, n_out: int, axis: int,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Resize ``axis`` (0: rows, 1: columns) of a contiguous [A, B] u8 or
    bf16 tensor to ``n_out``: ONE launch of the CUDA kernel on the current
    stream for a CUDA tensor, the plain twin for a CPU tensor."""
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return resize_axis_torch(x, n_out, axis, out_dtype)
    kernels.require(isinstance(x, torch.Tensor) and x.device.type == "cuda",
                    f"resize: unsupported device {getattr(x, 'device', type(x))}")
    kernels.require(x.dim() == 2 and axis in (0, 1),
                    f"resize: want a 2-D tensor and axis 0 or 1, got {tuple(x.shape)}, {axis}")
    kernels.require(x.dtype in (torch.uint8, torch.bfloat16),
                    f"resize: dtype {x.dtype}, want uint8 or bfloat16")
    kernels.require(out_dtype in _OUT_TYPES, f"resize: out_dtype {out_dtype}")
    kernels.require(x.is_contiguous(), "resize: input not contiguous")
    n_in = x.shape[axis]
    L, M, J, _, _, _, _, _ = _plan(n_in, n_out)
    shape = (n_out, x.shape[1]) if axis == 0 else (x.shape[0], n_out)
    kernels.require(0 < shape[0] * shape[1] < 2 ** 31 and x.numel() < 2 ** 31,
                    f"resize: {tuple(x.shape)} -> {shape} is empty or too large")
    w, bases = _device_plan(n_in, n_out, x.device)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    lib = kernels.load()
    with torch.cuda.device(x.device):
        rc = lib.mixlab_resize_axis(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], n_out, axis,
            int(x.dtype == torch.uint8), int(out_dtype == torch.uint8),
            L, M, J, w.data_ptr(), bases.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, rc, "resize kernel launch")
    resize_axis_cuda.launches += 1
    return out


resize_axis_cuda.launches = 0


def resize_plane_polyphase(plane: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W] u8 -> [out_h, out_w] u8, Mitchell bicubic, polyphase: the row
    pass (u8 -> bf16) then the column pass (bf16 -> u8), on the plane's
    device; one pass when only one axis changes."""
    in_h, in_w = plane.shape
    x = plane.contiguous()
    if (in_h, in_w) == (out_h, out_w):
        return x.clone()
    if in_h != out_h:
        x = resize_axis_cuda(x, out_h, 0, torch.uint8 if in_w == out_w else torch.bfloat16)
    if in_w != out_w:
        x = resize_axis_cuda(x, out_w, 1, torch.uint8)
    return x
