"""Hand-written Hopper kernels (CUDA C++ in ../../csrc), their plain
PyTorch versions, the nvcc/ctypes build, and the operators that the
wrappers call (``library.py``, registered on import)."""

from jcfszxc_unet_tpu_torch.ops.kernels import library  # noqa: F401
