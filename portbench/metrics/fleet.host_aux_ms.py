"""The fleet's host arrays a block: the benchmark's span around each call of
``Fleet.host_aux`` (``parallel/fleet.py``), ms a block."""

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet host", "ms/block", "lower", "host_clock", "fleet_x_realtime"


def read(rec):
    s = rec.span_s("fleet.host_aux")
    return None if s is None or not rec.units else 1e3 * s / rec.units
