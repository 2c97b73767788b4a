"""The fleet step's upload a block: the program's ``fleet.upload`` span
(``Fleet.step``: a shard's aux after an edit and the block's host arrays to
its device), ms a block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet step", "ms/block", "lower", "program_span", "fleet_x_realtime"


def read(rec):
    return ms_per_unit(rec, "fleet.upload")
