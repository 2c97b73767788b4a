"""The table of peaks and the least time a piece of work can take on one
NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the card's full
700 W; the run prints the card's name, and PERF.md its power limit)."""

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_s(nbytes: float, flops: float = 0.0) -> float:
    """The larger of bytes over the memory rate and float32 operations over
    the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def share_pct(nbytes: float, seconds: float, flops: float = 0.0):
    """The share of the roofline that ``seconds`` of device time reached,
    in percent; None where nothing ran (never 0)."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_s(nbytes, flops) / seconds


def launch_share(rec, family: str, kernels) -> Optional[float]:
    """A kernel's share of its roofline: the bytes counted at its launch
    wrapper (``<family>.bytes``) over the device time of the trace's
    kernels named in ``kernels``; None where the wrapper launched nothing.
    Launches counted with no such kernel in the trace (a kernel renamed)
    fail the run rather than drop the metric."""
    n = rec.facts.get(f"{family}.launches")
    if not n:
        return None
    seconds = rec.kernel_s(kernels)
    if seconds <= 0:
        raise RuntimeError(f"{n} {family} launches counted at the wrapper, but the trace holds "
                           f"no kernel whose name holds one of {kernels}")
    return share_pct(rec.facts[f"{family}.bytes"], seconds)
