"""The fleet's host arrays a block, measured inside the program: every
``fleet.host.<Kind>`` span of ``Fleet.host_aux`` (``parallel/fleet.py``; a
module's vectorized pass, broadcast or loop and its feed zeros), summed, ms a
block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet host", "ms/block", "lower", "program_span", "fleet_x_realtime"


def read(rec):
    return ms_per_unit(rec, "fleet.host.")
