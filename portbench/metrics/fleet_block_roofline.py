"""The whole fleet block's share of its roofline: the least time for the
block's unavoidable bytes (every state leaf read and written once, the
params read once, the stereo i16 taps written once, from the window's
shapes) over the kernels' device time a block.  It reads the same work
whatever implements it."""

from portbench.roofline import share_pct

LAYER, UNIT, BETTER, SOURCE, MOVES = "kernels", "%", "higher", "device_trace", "fleet_x_realtime"


def read(rec):
    f = rec.facts
    if not rec.units or "state_bytes" not in f:
        return None
    taps = f["sessions"] * f["samples_per_block"] * 2 * 2
    return share_pct((2 * f["state_bytes"] + f["param_bytes"] + taps) * rec.units, rec.kernel_s())
