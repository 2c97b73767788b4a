"""Device kernel launches a block of the offline render (``engine/render.py``,
``engine/compiler.py``): the kernels the traced window recorded over the
blocks it rendered."""

LAYER, UNIT, BETTER, SOURCE, MOVES = ("offline block loop", "launches/block", "lower",
                                      "device_trace", "render_x_realtime")


def read(rec):
    blocks = rec.facts.get("blocks")
    n = rec.kernel_count()
    return None if not blocks or not n else n / blocks
