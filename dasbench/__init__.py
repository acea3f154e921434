"""The benchmark of the PyTorch and CUDA port (das_tpu_torch) on the
H100: ``python3 -m dasbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``."""
