"""The benchmark's harness: cells and their files, set-up, the measured
window, the trace, the correctness check and the result line."""
