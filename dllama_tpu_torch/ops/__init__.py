"""Tensor ops: Q40 linear (kernels K1/K2), attention (kernel K3), norms,
sampling. Every kernel wrapper runs its plain PyTorch version on a CPU
tensor and launches its CUDA kernel (or raises) on a CUDA tensor."""
