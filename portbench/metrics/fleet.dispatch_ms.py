"""The fleet step's dispatch a block: the program's ``fleet.dispatch`` span
(``Fleet.step``: the shard's batched program under ``torch.func.vmap``, every
launch enqueued), ms a block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = "fleet step", "ms/block", "lower", "program_span", "fleet_x_realtime"


def read(rec):
    return ms_per_unit(rec, "fleet.dispatch")
