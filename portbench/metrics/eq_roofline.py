"""The eq kernel's share of its roofline (``csrc/eq_cascade.cu`` via
``dsp/eq_cuda.py``): the bytes its launches read and wrote, counted at the
launch wrapper (the input and its delayed copy read and the output written,
12 B a sample, and the poles and gains), over the eq kernels' device time."""

from portbench.roofline import launch_share

LAYER, UNIT, BETTER, SOURCE, MOVES = "kernels", "%", "higher", "device_trace", "fleet_x_realtime"
LAUNCHES = {"eq": ("mixlab_tpu_torch.dsp.eq_cuda", "_launch")}
KERNELS = ("eq_cascade_kernel", "eq_rows_kernel")


def read(rec):
    return launch_share(rec, "eq", KERNELS)
