"""The benchmark of ``mixlab_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  It never imports JAX or the JAX package."""
