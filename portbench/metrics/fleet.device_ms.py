"""The fleet step's device time a block, per card: every kernel's time in
the traced window over the cell's cards (``Records.cards``; a card that
recorded nothing counts as 0 s, as in ``busy_s``) and over the blocks it
delivered (copies are counted by ``device_idle_pct``), ms a block."""

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet step", "ms/block", "lower", "device_trace", "fleet_x_realtime"


def read(rec):
    s = rec.kernel_s()
    return None if not s or not rec.units else 1e3 * s / rec.cards / rec.units
