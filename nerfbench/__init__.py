"""The benchmark of ``nerficg_torch``, the PyTorch and CUDA port: one cell
once per run, ``python3 -m nerfbench.run --workload NAME --seed N
--seconds S --trace 0|1``."""
