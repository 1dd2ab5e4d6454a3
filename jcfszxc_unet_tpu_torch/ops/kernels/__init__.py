"""Hand-written Hopper kernels (CUDA C++ in ../../csrc), their plain
PyTorch versions and the nvcc/ctypes build."""
