"""The plain reference of the benchmark's correctness check: plain
PyTorch and numpy, importing nothing of the program under test."""
