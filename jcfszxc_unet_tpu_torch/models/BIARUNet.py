"""BIARUNet (reference UNetFamily/BIARUNet.py:15-90), counterpart of
``jcfszxc_unet_tpu/models/BIARUNet.py``: BARUNet with an ``SEBlock`` on
each decoder upsample (``SE1`` .. ``SE4``), and the same softmax output
over one channel (BIARUNet.py:89) and ``logit_head``.  The SE blocks are
stock ops; the 22 fused conv sites are BARUNet's.
"""

from __future__ import annotations

from jcfszxc_unet_tpu_torch.models.BARUNet import BARUNet


class BIARUNet(BARUNet):
    se_blocks = True
