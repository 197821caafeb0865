"""tpugs_torch — the PyTorch/CUDA port of tpugs for one NVIDIA H100.

Plain PyTorch for what the JAX package leaves to XLA (projection, SH,
sorts, autograd, the loss, Adam), and hand-written CUDA kernels (`csrc/`, built by `cuda_lib`) for
what it wrote in Pallas. Every kernel wrapper runs its kernel on a CUDA
tensor and its plain PyTorch version on a CPU tensor. Entry points run on
the card unless the caller asks for the CPU.
"""
