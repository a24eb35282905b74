"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``):
DiLoCo training cells on one NVIDIA H100, driven by ``BENCHMARK.json``.
``python3 bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell."""
