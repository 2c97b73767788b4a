"""The device's idle share of the traced window: 1 - (the union of kernel
and copy intervals) / the window, in percent.  One reader for each cell
kind's ``device_idle_pct.<kind>``, which moves that kind's end-to-end
metric (BENCHMARK.json names it)."""

LAYER, UNIT, BETTER, SOURCE = "device", "%", "lower", "device_trace"


def read(rec):
    if rec.window_s <= 0 or not (rec.kernels or rec.copies):
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)
