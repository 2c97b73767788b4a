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

  * ``resize_picture_polyphase`` — up to three [H, W] u8 planes of one
    picture, each to its own size: ONE launch of the kernel
    (``csrc/resize.cu``) for CUDA planes, which replaces the TPU kernel
    ``_axis0_kernel`` / ``_resize_axis0``
    (``mixlab_tpu/video/resize_pallas.py:143``) and runs both passes of
    every plane; the plain twin for CPU planes; any other device raises.
  * ``resize_picture_torch`` — its plain twin: per plane the row pass
    (u8 → bf16) then the column pass (bf16 → u8), as ``resize_plane_pallas``.
  * ``resize_axis_torch`` — one pass of the twin.
  * ``resize_plane_polyphase`` — one plane, a one-plane picture.

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
from typing import List, Sequence, Tuple

import numpy as np
import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.video.scale import _mitchell

MAX_PHASES = 16  # csrc/resize.cu kMaxPhases
MAX_TAPS = 12    # csrc/resize.cu kMaxTaps
MAX_PLANES = 3   # planes per launch, csrc/resize.cu kMaxPlanes
TILE_ROWS, TILE_COLS = 32, 128  # output tile of one CTA, csrc/resize.cu
# a plane's table in int32 words: a header, then per axis the bases, the
# nonzero-tap counts, the tap offsets and the weights of every phase
# (csrc/resize.cu PlaneTable)
_HEADER = 16
_AXIS_WORDS = 2 * MAX_PHASES + 2 * MAX_PHASES * MAX_TAPS
PLANE_WORDS = _HEADER + 2 * _AXIS_WORDS
_RESIZE_ROWS, _RESIZE_COLS = 1, 2
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
    if plan is None:
        raise ValueError(f"resize: no polyphase plan for {n_in} -> {n_out} (at most "
                         f"{MAX_PHASES} phases and {MAX_TAPS} taps)")
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
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"resize: out_dtype {out_dtype}")
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


def _resize_plane_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    in_h, in_w = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x.clone()
    if in_h != out_h:
        x = resize_axis_torch(x, out_h, 0, torch.uint8 if in_w == out_w else torch.bfloat16)
    if in_w != out_w:
        x = resize_axis_torch(x, out_w, 1, torch.uint8)
    return x


def resize_picture_torch(planes: Sequence[torch.Tensor],
                         sizes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Plain twin of one picture's launch, on the planes' device: each
    [H, W] u8 plane to its (out_h, out_w) by the row pass (u8 -> bf16, or
    -> u8 when the columns keep their size) then the column pass
    (-> u8); a plane that keeps its size is cloned."""
    return [_resize_plane_torch(x, int(h), int(w)) for x, (h, w) in zip(planes, sizes)]


def _axis_words(n_in: int, n_out: int):
    """One axis of a plane's table: (L, M, J, words [_AXIS_WORDS] int32):
    the bases, the nonzero-tap counts, then per phase the offsets j of its
    nonzero taps and their f32 weights (as int32 bits), ascending."""
    L, M, J, bases, W, _, _, _ = _plan(n_in, n_out)
    count = np.zeros(MAX_PHASES, np.int32)
    offset = np.zeros((MAX_PHASES, MAX_TAPS), np.int32)
    weight = np.zeros((MAX_PHASES, MAX_TAPS), np.float32)
    for p in range(L):
        nz = np.flatnonzero(W[p])
        count[p] = len(nz)
        offset[p, :len(nz)] = nz
        weight[p, :len(nz)] = W[p, nz]
    base = np.zeros(MAX_PHASES, np.int32)
    base[:L] = bases
    return L, M, J, np.concatenate([base, count, offset.ravel(), weight.ravel().view(np.int32)])


def _window(n_in: int, n_out: int, tile: int, align: int) -> int:
    """The most input indices a tile of ``tile`` outputs reads along a
    resized axis, its start aligned down to ``align`` and its length up to
    it (as the kernel sizes each tile's window)."""
    L, M, J, bases = _plan(n_in, n_out)[:4]
    base = np.asarray(bases)
    o0 = np.arange(0, n_out, tile)
    o1 = np.minimum(o0 + tile, n_out) - 1
    lo = (o0 // L) * M + base[o0 % L]
    lo = lo - lo % align  # floor, also below 0
    span = (o1 // L) * M + base[o1 % L] + J - lo
    return int((-(-span // align) * align).max())


@functools.lru_cache(maxsize=64)
def _picture_table(geometry: tuple):
    """The launch's plan for ``geometry`` (one (H, W, out_h, out_w) per
    resized plane): (table [planes, PLANE_WORDS] int32 in host memory, which
    the kernel's launch reads its headers from, first tile of each plane and
    the total, the most shared memory a tile's window and intermediate take,
    in bytes)."""
    table = np.zeros((len(geometry), PLANE_WORDS), np.int32)
    firsts, window_bytes = [0], 0
    for row, (H, W, OH, OW) in zip(table, geometry):
        tiles_x = -(-OW // TILE_COLS)
        mode, nr, nc = 0, TILE_ROWS, TILE_COLS
        head = [H, W, OH, OW, 0, tiles_x]
        for axis, (n_in, n_out, flag) in enumerate(((H, OH, _RESIZE_ROWS),
                                                     (W, OW, _RESIZE_COLS))):
            if n_in == n_out:
                head += [0, 0, 0]
                continue
            L, M, J, words = _axis_words(n_in, n_out)
            head += [L, M, J]
            mode |= flag
            at = _HEADER + axis * _AXIS_WORDS
            row[at:at + _AXIS_WORDS] = words
            if axis == 0:
                nr = _window(n_in, n_out, TILE_ROWS, 1)
            else:
                nc = _window(n_in, n_out, TILE_COLS, 16)
        head[4] = mode
        row[:len(head)] = head
        # the u8 window, its bf16 copy for a row pass, the f32 rows a
        # column pass reads (csrc/resize.cu resize_tile)
        window_bytes = max(window_bytes, nr * nc * (3 if mode & _RESIZE_ROWS else 1)
                           + (4 * TILE_ROWS * nc if mode & _RESIZE_COLS else 0))
        firsts.append(firsts[-1] + tiles_x * -(-OH // TILE_ROWS))
    return table, tuple(firsts), window_bytes


@functools.lru_cache(maxsize=64)
def _device_table(geometry: tuple, device: torch.device) -> torch.Tensor:
    """``_picture_table``'s table on ``device``, uploaded once."""
    return torch.from_numpy(_picture_table(geometry)[0]).to(device)


def resize_picture_polyphase(planes: Sequence[torch.Tensor],
                             sizes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Resize 1-3 [H, W] u8 planes of one picture, plane i to ``sizes[i]``
    = (out_h, out_w), Mitchell bicubic, polyphase: ONE launch of the CUDA
    kernel on the current stream for CUDA planes (a plane that keeps its
    size is cloned and takes no part; no launch when none changes), the
    plain twin for CPU planes."""
    if not 0 < len(planes) == len(sizes) <= MAX_PLANES:
        raise ValueError(f"resize: 1 to {MAX_PLANES} planes with one size each, got "
                         f"{len(planes)} and {len(sizes)}")
    xs = []
    for i, (x, (out_h, out_w)) in enumerate(zip(planes, sizes)):
        if not (isinstance(x, torch.Tensor) and x.dim() == 2):
            raise ValueError(f"resize plane {i}: want a 2-D tensor, got "
                             f"{tuple(getattr(x, 'shape', ())) or type(x)}")
        in_h, in_w = x.shape
        if in_h != out_h:
            _plan(in_h, out_h)
        if in_w != out_w:
            _plan(in_w, out_w)
        xs.append(x.contiguous())
    if xs[0].is_cpu:
        for i, x in enumerate(xs):
            if not x.is_cpu:
                raise ValueError(f"resize plane {i}: on {x.device}, the others on cpu")
        return resize_picture_torch(xs, sizes)
    index = kernels.cuda_index(xs[0], "resize")
    outs, args, geometry = [], [], []
    for i, (x, (out_h, out_w)) in enumerate(zip(xs, sizes)):
        if not (x.is_cuda and x.get_device() == index):
            raise ValueError(f"resize plane {i}: on {x.device}, the others on {xs[0].device}")
        if x.dtype is not torch.uint8:
            raise ValueError(f"resize plane {i}: dtype {x.dtype}, want uint8")
        if not (0 < out_h * out_w < 2 ** 31 and 0 < x.numel() < 2 ** 31):
            raise ValueError(f"resize plane {i}: {tuple(x.shape)} -> {(out_h, out_w)} is empty "
                             "or too large")
        if x.shape == (out_h, out_w):
            outs.append(x.clone())
            continue
        out = torch.empty((out_h, out_w), dtype=torch.uint8, device=x.device)
        outs.append(out)
        args += [x.data_ptr(), out.data_ptr()]
        geometry.append((x.shape[0], x.shape[1], int(out_h), int(out_w)))
    if not geometry:
        return outs
    geometry = tuple(geometry)
    host_table, firsts, window_bytes = _picture_table(geometry)
    table = _device_table(geometry, xs[0].device)
    args += [None] * (2 * MAX_PLANES - len(args))
    tile_1 = firsts[1]
    tile_2 = firsts[2] if len(geometry) > 2 else firsts[-1]
    kernels.launch("mixlab_resize_picture", "resize kernel launch", index,
                   *args, len(geometry), host_table.ctypes.data, table.data_ptr(), firsts[-1],
                   tile_1, tile_2, window_bytes)
    resize_picture_polyphase.launches += 1
    return outs


resize_picture_polyphase.launches = 0


def resize_plane_polyphase(plane: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W] u8 -> [out_h, out_w] u8, Mitchell bicubic, polyphase, on the
    plane's device: a one-plane ``resize_picture_polyphase``."""
    return resize_picture_polyphase([plane], [(out_h, out_w)])[0]
