"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A kernel's wrapper launches it for CUDA tensors and takes the plain
version only for tensors on the CPU.
"""
