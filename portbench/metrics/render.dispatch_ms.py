"""The offline block program's dispatch a block: the program's
``patch.dispatch`` span (``engine/compiler.py`` ``CompiledPatch.run``: the
block program called, every launch enqueued), ms a block."""

from portbench.program_spans import ms_per_unit

LAYER, UNIT, BETTER, SOURCE, MOVES = ("offline block loop", "ms/block", "lower", "program_span",
                                      "render_x_realtime")


def read(rec):
    return ms_per_unit(rec, "patch.dispatch")
