#!/usr/bin/env python3
"""Train-step throughput of the PyTorch/CUDA port on one NVIDIA GPU:

    python3 bench_torch.py

Prints one JSON line with bench.py's keys (tpugs_torch/bench.py says what
it measures and how). TPUGS_TRAIN_CARRY=1 and TPUGS_BENCH_SKIP_GARDEN=1
work as in bench.py. Without CUDA it exits nonzero and prints nothing.
"""
import sys

from tpugs_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
