"""R2 Attention U-Net (reference UNetFamily/R2AttentionUNet.py:15-91),
counterpart of ``jcfszxc_unet_tpu/models/R2AttentionUNet.py``: R2U-Net
with attention-gated skips.  Defined beside R2UNet in ``models/R2UNet.py``,
which it extends; this module keeps the JAX package's module name."""

from jcfszxc_unet_tpu_torch.models.R2UNet import R2AttentionUNet

__all__ = ["R2AttentionUNet"]
