"""The fleet server's wait for a block's taps: the program's
``fleet.fetch_wait`` span (``server/fleet_serve.py`` ``_finish_fetch``: the
wait on the event behind the pinned copy alone), ms a block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet step", "ms/block", "lower", "program_span", "fleet_x_realtime"


def read(rec):
    return ms_per_unit(rec, "fleet.fetch_wait")
