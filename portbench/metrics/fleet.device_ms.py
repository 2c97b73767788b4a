"""The fleet step's device time a block: every kernel's time in the traced
window over the blocks it delivered (copies are counted by
``device_idle_pct``), ms a block."""

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet step", "ms/block", "lower", "device_trace", "fleet_x_realtime"


def read(rec):
    s = rec.kernel_s()
    return None if not s or not rec.units else 1e3 * s / rec.units
