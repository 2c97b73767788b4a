"""The video mixer's crossfade (port of ``mixlab_tpu/video/blend.py``).

Reference inner loop: ``src/module/video_mixer.rs:210-235`` — per plane,
``out = (a*fade + b*(255-fade)) / 255`` in u8-load / u16-math / truncating
integer division.  The exact ÷255 is the multiply-shift identity
``x // 255 == (x * 32897) >> 23`` for 0 <= x <= 65535.

  * ``crossfade_cuda`` — the hand-written kernel (``csrc/crossfade.cu``):
    one launch blends up to three planes; replaces the TPU kernel
    ``crossfade_pallas`` (``mixlab_tpu/video/blend.py:86``).
  * ``crossfade_torch`` — its plain twin, int32 elementwise in the same
    formula.
  * ``crossfade_picture`` — all planes of a picture: the twin for CPU
    tensors, the kernel for CUDA tensors, nothing else (no fallback).

No single PyTorch call computes this integer blend, so the chip timing has
no library yardstick for it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from mixlab_tpu_torch import kernels

MAX_PLANES = 3  # planes per launch (csrc/crossfade.cu kMaxPlanes)


def crossfade_torch(a: torch.Tensor, b: torch.Tensor, fade: int) -> torch.Tensor:
    """out = (a*fade + b*(255-fade)) // 255 for u8 planes, as int32
    elementwise ops on the planes' device."""
    fade = int(fade)
    acc = a.to(torch.int32) * fade + b.to(torch.int32) * (255 - fade)
    return ((acc * 32897) >> 23).to(torch.uint8)


def _check_planes(a_planes, b_planes, fade) -> int:
    """The planes' card index; raises ``ValueError`` on anything the kernel
    does not take."""
    if not 0 < len(a_planes) == len(b_planes) <= MAX_PLANES:
        raise ValueError(f"crossfade: 1 to {MAX_PLANES} plane pairs, got {len(a_planes)} and "
                         f"{len(b_planes)}")
    if not (isinstance(fade, int) and 0 <= fade <= 255):
        raise ValueError(f"crossfade: fade must be an int in 0..255, got {fade!r}")
    index = kernels.cuda_index(a_planes[0], "crossfade")
    for i, (a, b) in enumerate(zip(a_planes, b_planes)):
        for name, t in (("a", a), ("b", b)):
            if not (isinstance(t, torch.Tensor) and t.is_cuda and t.get_device() == index):
                raise ValueError(f"crossfade plane {i} {name}: on "
                                 f"{getattr(t, 'device', type(t))}, the others on "
                                 f"{a_planes[0].device}")
            if t.dtype is not torch.uint8:
                raise ValueError(f"crossfade plane {i} {name}: dtype {t.dtype}, want uint8")
            if not t.is_contiguous():
                raise ValueError(f"crossfade plane {i} {name}: not contiguous")
        if a.shape != b.shape:
            raise ValueError(f"crossfade plane {i}: shapes {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel() >= 2 ** 31:
            raise ValueError(f"crossfade plane {i}: too large")
    return index


def crossfade_cuda(a_planes: Sequence[torch.Tensor], b_planes: Sequence[torch.Tensor],
                   fade: int) -> List[torch.Tensor]:
    """Blend plane pairs ``(a_planes[i], b_planes[i])`` in ONE launch of the
    CUDA kernel on the current stream; returns the new planes."""
    index = _check_planes(a_planes, b_planes, fade)
    outs = [torch.empty_like(a) for a in a_planes]
    args = []
    for q in range(MAX_PLANES):
        if q < len(outs):
            args += [a_planes[q].data_ptr(), b_planes[q].data_ptr(), outs[q].data_ptr(),
                     outs[q].numel()]
        else:
            args += [None, None, None, 0]
    kernels.launch("mixlab_crossfade", "crossfade kernel launch", index,
                   *args, len(outs), fade)
    crossfade_cuda.launches += 1
    return outs


crossfade_cuda.launches = 0


def crossfade_picture(a_planes: Dict[str, torch.Tensor], b_planes: Dict[str, torch.Tensor],
                      fade: int) -> Dict[str, torch.Tensor]:
    """Blend all planes of two same-format pictures (one kernel launch on
    the card; the plain twin for CPU tensors)."""
    keys = tuple(sorted(a_planes))
    if tuple(sorted(b_planes)) != keys:
        raise ValueError(f"crossfade: planes {keys} vs {tuple(sorted(b_planes))}")
    a_list = [a_planes[k] for k in keys]
    b_list = [b_planes[k] for k in keys]
    if all(t.is_cpu for t in a_list + b_list):
        return {k: crossfade_torch(a, b, fade) for k, a, b in zip(keys, a_list, b_list)}
    return dict(zip(keys, crossfade_cuda(a_list, b_list, fade)))
