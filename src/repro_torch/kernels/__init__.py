"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
wrappers, plain PyTorch versions (``ref``) and the tuning cells."""
