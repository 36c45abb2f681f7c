"""Threshold-join kernels: CUDA sources, their builder and wrappers, the plain PyTorch versions, and the device router."""
