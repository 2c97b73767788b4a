"""The program's own spans (``mixlab_tpu_torch/spans.py``), turned on when
this module is imported, each named ``pb:mx.<name>`` so that ``Records``
keeps it beside the benchmark's spans (``pb:<name>``) without a clash.

Each reader of a program span imports this module, and the harness loads
the readers only in a run with ``--trace 1``: every untraced window runs
with the program's spans off.
"""

from portbench.trace import SPAN_PREFIX

PREFIX = "mx."

try:
    from mixlab_tpu_torch import spans
except ImportError:  # a program without spans of its own: the readers find none
    spans = None
else:
    spans.enable(prefix=SPAN_PREFIX + PREFIX)


def ms_per_unit(rec, *names):
    """Milliseconds a unit of work (``rec.units``: a block) in the program's
    spans ``names``, summed; a name that ends in ``.`` takes every span whose
    name begins with it.  None where the window recorded none of them."""
    want = [PREFIX + n for n in names]
    got = [d for name, v in rec.spans.items()
           if any(name == w or (w.endswith(".") and name.startswith(w)) for w in want)
           for _, d in v]
    return None if not got or not rec.units else 1e3 * sum(got) / 1e9 / rec.units
