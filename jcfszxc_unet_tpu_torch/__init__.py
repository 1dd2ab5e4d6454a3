"""PyTorch/CUDA port of jcfszxc_unet_tpu for NVIDIA Hopper (H100).

The JAX package ``jcfszxc_unet_tpu`` stays the reference; this package
mirrors its layout and names.  Ported so far: UNet tiled evaluation end to
end (``cli/evaluate.py``, ``eval/``), with hand-written CUDA kernels for
the fused 3x3 conv + affine + ReLU and the Dice reduction
(``ops/kernels/``, sources in ``csrc/``).
"""
