"""Hand-written kernels (threshold joins, flash attention): CUDA sources, their builder and wrappers, the plain PyTorch versions, and the device router."""
