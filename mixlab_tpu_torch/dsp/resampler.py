"""Polyphase rational resampler (port of ``mixlab_tpu/dsp/resampler.py``).

Classic polyphase L/M resampling with a Kaiser-windowed sinc prototype,
written as a dense group weight matrix ``W2 [L, W]`` (W = M + J - 1): output
group ``q`` (L samples) reads the input window ``x[qM - (J-1) .. qM + M - 1]``,
so a block resamples as one strided convolution of the input with the L rows
of ``W2``.  The JAX package runs it as an XLA conv at
``Precision.HIGHEST`` (no Pallas kernel); the port runs
``torch.nn.functional.conv1d`` with stride M, which must be IEEE f32: it
raises while cuDNN (card) or oneDNN (CPU) would run it in TF32 or bf16
(``precision.require_ieee_f32(..., conv=True)``).

The JAX layout stays at the boundary: ``x`` is [S_in, C] or [S_in], the
carried context ``ctx`` [J-1, C] (or [J-1]).  ``design`` computes the
filter in float64 exactly as the JAX package does and stores it float32.
``resample_block_np`` is the numpy twin for host ingest threads.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mixlab_tpu_torch.precision import require_ieee_f32


@functools.lru_cache(maxsize=32)
def design(src_rate: int, dst_rate: int, taps_per_phase: int = 32):
    """``(L, M, W2)`` for a src->dst polyphase resampler; W2 is the float32
    [L, M+J-1] group weight matrix (numpy)."""
    g = math.gcd(src_rate, dst_rate)
    L = dst_rate // g
    M = src_rate // g
    J = taps_per_phase
    N = L * J

    # windowed-sinc prototype, cutoff at min(src, dst)/2, gain L in passband
    fc = min(src_rate, dst_rate) / (src_rate * L)
    m = np.arange(N, dtype=np.float64)
    c = (N - 1) / 2.0
    h = L * fc * np.sinc(fc * (m - c)) * np.kaiser(N, beta=9.0)

    W = M + J - 1
    W2 = np.zeros((L, W), dtype=np.float64)
    for r in range(L):
        p = (r * M) % L
        k_off = (r * M) // L
        for j in range(J):
            W2[r, (J - 1) + k_off - j] = h[p + L * j]
    # unit DC gain per polyphase branch
    W2 /= W2.sum(axis=1, keepdims=True)
    return L, M, W2.astype(np.float32)


def context_len(src_rate: int, dst_rate: int, taps_per_phase: int = 32) -> int:
    return taps_per_phase - 1


@functools.lru_cache(maxsize=8)
def _weights(src_rate: int, dst_rate: int, taps_per_phase: int, device: torch.device):
    L, M, W2 = design(src_rate, dst_rate, taps_per_phase)
    return torch.from_numpy(W2).to(device)[:, None, :]  # [L, 1, W]


def resample_block(x: torch.Tensor, ctx: torch.Tensor, src_rate: int, dst_rate: int,
                   taps_per_phase: int = 32):
    """Resample one block on ``x``'s device.

    ``x``: [S_in, C] or [S_in] float32 at ``src_rate``, S_in a multiple of M;
    ``ctx``: [J-1, C] (or [J-1]) carried input history, zeros at first.
    Returns ``(y [S_in*L/M, C], new_ctx)``."""
    L, M, _ = design(src_rate, dst_rate, taps_per_phase)
    J = taps_per_phase
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
        ctx = ctx[:, None]
    S_in, C = x.shape
    if S_in % M:
        raise ValueError(f"resample_block: {S_in} input samples are not a multiple of {M}")
    require_ieee_f32(x, "resample_block", conv=True)
    G = S_in // M
    xp = torch.cat([ctx, x], dim=0)  # [(J-1)+S_in, C]
    y = torch.nn.functional.conv1d(
        xp.T[:, None, :], _weights(src_rate, dst_rate, taps_per_phase, x.device),
        stride=M)  # [C, L, G]
    y = y.permute(2, 1, 0).reshape(G * L, C)
    new_ctx = xp[-(J - 1):]
    if squeeze:
        return y[:, 0], new_ctx[:, 0]
    return y, new_ctx


def resample_block_np(x, ctx, src_rate: int, dst_rate: int, taps_per_phase: int = 32):
    """Numpy twin of :func:`resample_block` (an explicit window gather and
    einsum, as ``mixlab_tpu/dsp/resampler.py:resample_block_np``)."""
    L, M, W2 = design(src_rate, dst_rate, taps_per_phase)
    J = taps_per_phase
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        ctx = ctx[:, None]
    S_in, C = x.shape
    if S_in % M:
        raise ValueError(f"resample_block_np: {S_in} input samples are not a multiple of {M}")
    G = S_in // M
    W = M + J - 1
    xp = np.concatenate([ctx, x], axis=0)
    idx = np.arange(G)[:, None] * M + np.arange(W)[None, :]
    y = np.einsum("gwc,lw->glc", xp[idx], W2).reshape(G * L, C).astype(np.float32)
    new_ctx = xp[-(J - 1):]
    if squeeze:
        return y[:, 0], new_ctx[:, 0]
    return y, new_ctx
