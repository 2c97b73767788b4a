"""The region kernel's share of its roofline (``csrc/region.cu`` via
``engine/region_cuda.py``): the bytes its launches read and wrote, counted
at the launch wrapper (each distinct operand, the params, the taps, scalar
taps and exits once: ``region_work``'s count), over the region kernels'
device time."""

from portbench.roofline import launch_share

LAYER, UNIT, BETTER, SOURCE, MOVES = "kernels", "%", "higher", "device_trace", "fleet_x_realtime"
LAUNCHES = {"region": ("mixlab_tpu_torch.engine.region_cuda", "_launch")}
KERNELS = ("region_kernel", "region_rows_kernel", "region_lookback_kernel")


def read(rec):
    return launch_share(rec, "region", KERNELS)
