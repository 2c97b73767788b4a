"""The device's idle share of the traced window, in percent: the mean of
the cell's cards' idle shares, each 1 - (the union of that card's kernel and
copy intervals) / the window; a card that recorded nothing is idle all of
it.  One reader for each cell kind's ``device_idle_pct.<kind>``, which moves
that kind's end-to-end metric (BENCHMARK.json names it)."""

LAYER, UNIT, BETTER, SOURCE = "device", "%", "lower", "device_trace"


def read(rec):
    if rec.window_s <= 0 or not (rec.kernels or rec.copies):
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)
