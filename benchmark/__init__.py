"""The training benchmark of the PyTorch/CUDA port (`python3
benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1`).
BENCHMARK.json at the repository's root names its cells and metrics."""
