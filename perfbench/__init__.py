"""The benchmark of the PyTorch and CUDA port (``lqer_tpu_torch``): one
command runs one cell of ``BENCHMARK.json`` once (``python3 -m
perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``).
Nothing here imports JAX or the JAX package."""
