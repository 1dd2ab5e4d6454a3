"""JAX variables -> the port's ``state_dict``.

Turns a Flax variables tree of the JAX package (``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays) into a state dict
with the reference's torch key names, which the port's modules load with
``strict=True``.  The port keeps its own copy of the mapping rules for
all 16 models of the zoo, independent of the JAX package; the leaf
transforms are those of the reference interchange:

  * Conv2d:          flax kernel (kh, kw, I, O) -> torch (O, I, kh, kw)
  * ConvTranspose2d: flax kernel (kh, kw, I, O), spatially flipped ->
                     torch (I, O, kh, kw)
  * Linear:          flax kernel (I, O) -> torch (O, I)
  * BatchNorm1d/2d:  scale/bias + batch_stats mean/var -> weight/bias +
                     running_mean/running_var, num_batches_tracked = 0
  * the self-attention: in_proj and out_proj kernels transposed into
                     ``mha.in_proj_weight`` and ``mha.out_proj.weight``,
                     their biases as they are
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

LEAF_CLASSES = {"Conv2d", "ConvTranspose2d", "BatchNorm2d", "BatchNorm1d",
                "Linear", "MultiHeadSelfAttention"}

# Conv -> BN -> ReLU -> Conv -> BN -> ReLU under one Sequential named
# ``seq`` (reference DoubleConv, conv_block, UNetPP's private DoubleConv).
def _double(seq):
    return {"Conv2d_0": (f"{seq}.0", "Conv2d"),
            "BatchNorm2d_0": (f"{seq}.1", "BatchNorm2d"),
            "Conv2d_1": (f"{seq}.3", "Conv2d"),
            "BatchNorm2d_1": (f"{seq}.4", "BatchNorm2d")}


# A callable child rule takes (segment, the segment's siblings).


def _respath(seg, siblings):
    # children named shortcut_i, conv_i, bn_i -> ModuleLists
    kind, i = seg.rsplit("_", 1)
    return {"shortcut": (f"shortcuts.{i}", "Conv2dBatchnorm"),
            "conv": (f"convs.{i}", "Conv2dBatchnorm"),
            "bn": (f"bns.{i}", "BatchNorm2d")}[kind]


def _single_level_densenet(seg, siblings):
    # children Conv2d_i, BatchNorm2d_i -> ModuleLists
    kind, i = seg.rsplit("_", 1)
    return {"Conv2d": (f"conv_list.{i}", "Conv2d"),
            "BatchNorm2d": (f"bn_list.{i}", "BatchNorm2d")}[kind]


def _ba_module(seg, siblings):
    # Linear_0 + BatchNorm1d_0 -> cur_fusion, Linear_i + BatchNorm1d_i ->
    # pre_fusions.{i-1}, and the last Linear -> generation.1 (after the
    # generation's ReLU)
    kind, i = seg.rsplit("_", 1)
    i = int(i)
    n_linear = sum(s.startswith("Linear_") for s in siblings)
    if kind == "Linear" and i == n_linear - 1:
        return "generation.1", "Linear"
    at = "cur_fusion" if i == 0 else f"pre_fusions.{i - 1}"
    return {"Linear": (f"{at}.0", "Linear"),
            "BatchNorm1d": (f"{at}.1", "BatchNorm1d")}[kind]


# Flax child segment -> (torch relative path, class), per block class
# (reference unet_parts.py and UNetPP.py:15-28); a callable maps the
# segment for blocks with numbered children.
CHILD_RULES: Dict[str, Dict[str, tuple]] = {
    "DoubleConv": _double("double_conv"),                     # :17-34
    "Down": {"DoubleConv_0": ("maxpool_conv.1", "DoubleConv")},
    "Up": {"ConvTranspose2d_0": ("up", "ConvTranspose2d"),
           "DoubleConv_0": ("conv", "DoubleConv")},
    "OutConv": {"Conv2d_0": ("conv", "Conv2d")},
    "ConvBlockBN": _double("conv"),                           # :82-96
    "DoubleConvBias": _double("conv"),
    "UpConvBlock": {"Conv2d_0": ("up.1", "Conv2d"),           # :99-111
                    "BatchNorm2d_0": ("up.2", "BatchNorm2d")},
    "RecurrentBlock": {"Conv2d_0": ("conv.0", "Conv2d"),      # :114-132
                       "BatchNorm2d_0": ("conv.1", "BatchNorm2d")},
    "RRCNNBlock": {"Conv2d_0": ("Conv_1x1", "Conv2d"),        # :135-146
                   "RecurrentBlock_0": ("RCNN.0", "RecurrentBlock"),
                   "RecurrentBlock_1": ("RCNN.1", "RecurrentBlock")},
    "AttentionBlock": {"Conv2d_0": ("W_g.0", "Conv2d"),       # :149-176
                       "BatchNorm2d_0": ("W_g.1", "BatchNorm2d"),
                       "Conv2d_1": ("W_x.0", "Conv2d"),
                       "BatchNorm2d_1": ("W_x.1", "BatchNorm2d"),
                       "Conv2d_2": ("psi.0", "Conv2d"),
                       "BatchNorm2d_2": ("psi.1", "BatchNorm2d")},
    "ResidualConv": {"BatchNorm2d_0": ("conv_block.0", "BatchNorm2d"),
                     "Conv2d_0": ("conv_block.2", "Conv2d"),  # :454-475
                     "BatchNorm2d_1": ("conv_block.3", "BatchNorm2d"),
                     "Conv2d_1": ("conv_block.5", "Conv2d"),
                     "Conv2d_2": ("conv_skip.0", "Conv2d"),
                     "BatchNorm2d_2": ("conv_skip.1", "BatchNorm2d")},
    "UpsampleT": {"ConvTranspose2d_0": ("upsample",           # :478-487
                                        "ConvTranspose2d")},
    "SingleLevelDensenet": _single_level_densenet,            # :346-367
    "UpsampleNConcat": {"ConvTranspose2d_0": ("upsample_layer",  # :380-393
                                              "ConvTranspose2d"),
                        "Conv2d_0": ("conv", "Conv2d"),
                        "BatchNorm2d_0": ("bn", "BatchNorm2d")},
    "FRConv": {"Conv2d_0": ("conv.0", "Conv2d"),              # :490-507
               "BatchNorm2d_0": ("conv.1", "BatchNorm2d"),
               "Conv2d_1": ("conv.4", "Conv2d"),
               "BatchNorm2d_1": ("conv.5", "BatchNorm2d")},
    "FeatureFuse": {"Conv2d_0": ("conv11", "Conv2d"),         # :510-525
                    "Conv2d_1": ("conv33", "Conv2d"),
                    "Conv2d_2": ("conv33_di", "Conv2d"),
                    "BatchNorm2d_0": ("norm", "BatchNorm2d")},
    "FRUp": {"ConvTranspose2d_0": ("up.0", "ConvTranspose2d"),  # :528-541
             "BatchNorm2d_0": ("up.1", "BatchNorm2d")},
    "FRDown": {"Conv2d_0": ("down.0", "Conv2d"),              # :544-555
               "BatchNorm2d_0": ("down.1", "BatchNorm2d")},
    "FRBlock": {"FeatureFuse_0": ("fuse", "FeatureFuse"),     # :558-591
                "FRConv_0": ("conv", "FRConv"),
                "FRUp_0": ("up", "FRUp"),
                "FRDown_0": ("down", "FRDown")},
    "Conv2dBatchnorm": {"Conv2d_0": ("conv1", "Conv2d"),      # :617-656
                        "BatchNorm2d_0": ("batchnorm", "BatchNorm2d")},
    # :659-715, in the JAX order: shortcut, 3x3, 5x5, 7x7, bn1, bn2
    "Multiresblock": {"Conv2dBatchnorm_0": ("shortcut", "Conv2dBatchnorm"),
                      "Conv2dBatchnorm_1": ("conv_3x3", "Conv2dBatchnorm"),
                      "Conv2dBatchnorm_2": ("conv_5x5", "Conv2dBatchnorm"),
                      "Conv2dBatchnorm_3": ("conv_7x7", "Conv2dBatchnorm"),
                      "BatchNorm2d_0": ("batch_norm1", "BatchNorm2d"),
                      "BatchNorm2d_1": ("batch_norm2", "BatchNorm2d")},
    "Respath": _respath,                                      # :718-791
    "ConvBlockPlain": {"Conv2d_0": ("conv.0", "Conv2d"),      # :794-806
                       "Conv2d_1": ("conv.2", "Conv2d")},
    "ConvLSTM2D": {"Conv2d_0": ("cell.conv", "Conv2d")},      # :809-869
    "UpConvT": {"ConvTranspose2d_0": ("up.0",                 # :872-885
                                      "ConvTranspose2d"),
                "BatchNorm2d_0": ("up.1", "BatchNorm2d")},
    "BAModule": _ba_module,                                   # :188-224
    "BABasicBlock": {"Conv2d_0": ("conv1", "Conv2d"),         # :227-275
                     "BatchNorm2d_0": ("bn1", "BatchNorm2d"),
                     "Conv2d_1": ("conv2", "Conv2d"),
                     "BatchNorm2d_1": ("bn2", "BatchNorm2d"),
                     "BAModule_0": ("ba", "BAModule"),
                     "Conv2d_2": ("conv3", "Conv2d")},
    "CBAM": {"ChannelAttentionModule_0": ("channel_attention",  # :278-322
                                          "ChannelAttentionModule"),
             "SpatialAttentionModule_0": ("spatial_attention",
                                          "SpatialAttentionModule")},
    "ChannelAttentionModule": {"Conv2d_0": ("shared_MLP.0", "Conv2d"),
                               "Conv2d_1": ("shared_MLP.2", "Conv2d")},
    "SpatialAttentionModule": {"Conv2d_0": ("conv2d", "Conv2d")},
    # RetinaLiteNet's private copies (RetinaLiteNet.py:16-68)
    "PrivateCBAM": {"channel_att": ("channel_att", "PrivateChannelAtt"),
                    "spatial_att": ("spatial_att", "PrivateSpatialAtt")},
    "PrivateChannelAtt": {"Conv2d_0": ("shared_mlp.0", "Conv2d"),
                          "Conv2d_1": ("shared_mlp.2", "Conv2d")},
    "PrivateSpatialAtt": {"Conv2d_0": ("conv", "Conv2d")},
    "SEBlock": {"Linear_0": ("fc.0", "Linear"),               # :325-343
                "Linear_1": ("fc.2", "Linear")},
    "BasicConv2d": {"Conv2d_0": ("conv", "Conv2d"),           # :396-422
                    "BatchNorm2d_0": ("bn", "BatchNorm2d")},
    # InceptionA's children in the JAX order of its four branches
    "InceptionA": {"BasicConv2d_0": ("b1_2", "BasicConv2d"),
                   "BasicConv2d_1": ("b2", "BasicConv2d"),
                   "BasicConv2d_2": ("b3_1", "BasicConv2d"),
                   "BasicConv2d_3": ("b3_2", "BasicConv2d"),
                   "BasicConv2d_4": ("b4_1", "BasicConv2d"),
                   "BasicConv2d_5": ("b4_2", "BasicConv2d"),
                   "BasicConv2d_6": ("b4_3", "BasicConv2d")},
    "UpV1": {"ConvTranspose2d_0": ("up", "ConvTranspose2d"),  # :425-451
             "DoubleConv_0": ("conv", "DoubleConv")},
}


def _root_unet(seg):
    if seg == "inc":
        return seg, "DoubleConv"
    if seg.startswith("down"):
        return seg, "Down"
    if seg.startswith("up"):
        return seg, "Up"
    if seg == "outc":
        return seg, "OutConv"
    raise KeyError(seg)


def _root_attention_unet(seg):
    if seg.startswith("Up_conv"):
        return seg, "ConvBlockBN"
    if seg.startswith("Att"):
        return seg, "AttentionBlock"
    if seg == "Conv_1x1":
        return seg, "Conv2d"
    if seg.startswith("Conv"):
        return seg, "ConvBlockBN"
    if seg.startswith("Up"):
        return seg, "UpConvBlock"
    raise KeyError(seg)


def _root_r2(seg):
    if seg.startswith("RRCNN") or seg.startswith("Up_RRCNN"):
        return seg, "RRCNNBlock"
    if seg.startswith("Att"):
        return seg, "AttentionBlock"
    if seg == "Conv_1x1":
        return seg, "Conv2d"
    if seg.startswith("Up"):
        return seg, "UpConvBlock"
    raise KeyError(seg)


_RESUNET_LEAVES = {"input_conv1": ("input_layer.0", "Conv2d"),
                   "input_bn": ("input_layer.1", "BatchNorm2d"),
                   "input_conv2": ("input_layer.3", "Conv2d"),
                   "input_skip": ("input_skip.0", "Conv2d"),
                   "output_layer": ("output_layer.0", "Conv2d")}


def _root_resunet(seg):
    if seg in _RESUNET_LEAVES:
        return _RESUNET_LEAVES[seg]
    if seg.startswith("upsample_"):
        return seg, "UpsampleT"
    if (seg.startswith("residual_conv") or seg == "bridge"
            or seg.startswith("up_residual_conv")):
        return seg, "ResidualConv"
    raise KeyError(seg)


def _root_segnet(seg):
    if seg.startswith("conv"):
        return seg, "Conv2d"
    if seg.startswith("bn"):
        return seg, "BatchNorm2d"
    raise KeyError(seg)


def _root_nested(seg):
    if seg.startswith("conv"):
        return seg, "DoubleConvBias"
    if seg.startswith("final"):
        return seg, "Conv2d"
    raise KeyError(seg)


def _root_bcdu(seg):
    if seg in ("encoder", "decoder"):
        return "", None  # transparent: its children sit at the root
    if seg.startswith("conv_lstm"):
        return seg, "ConvLSTM2D"
    if seg in ("conv1", "conv2", "conv3", "conv6", "conv7"):
        return seg, "ConvBlockPlain"
    if seg in ("up6", "up7", "up8"):
        return seg, "UpConvT"
    if seg.startswith("conv8_"):  # the reference's conv8 Sequential
        return f"conv8.{2 * (int(seg[-1]) - 1)}", "Conv2d"
    if seg.startswith("conv"):  # conv4, conv4_1, ..., conv9
        return seg, "Conv2d"
    raise KeyError(seg)


def _root_multires(seg):
    if seg.startswith("multiresblock"):
        return seg, "Multiresblock"
    if seg.startswith("respath"):
        return seg, "Respath"
    if seg.startswith("upsample"):
        return seg, "ConvTranspose2d"
    if seg == "conv_final":
        return seg, "Conv2dBatchnorm"
    raise KeyError(seg)


def _root_denseunet(seg):
    if seg in ("conv1", "outconv"):
        return seg, "Conv2d"
    if seg.startswith("up"):
        return seg, "UpsampleNConcat"
    if seg == "bottom" or seg[0] in "du":
        return seg, "SingleLevelDensenet"
    raise KeyError(seg)


def _root_frunet(seg):
    if seg.startswith("block"):
        return seg, "FRBlock"
    if seg.startswith("final"):
        return seg, "Conv2d"
    raise KeyError(seg)


def _root_barunet(seg):  # BARUNet and BIARUNet
    if seg == "Conv1" or seg.startswith("Up_conv"):
        return seg, "ConvBlockBN"
    if seg == "Conv_1x1":
        return seg, "Conv2d"
    if seg.startswith("Conv"):
        return seg, "BABasicBlock"
    if seg.startswith("cbam"):
        return seg, "CBAM"
    if seg.startswith("SE"):
        return seg, "SEBlock"
    if seg.startswith("Up"):
        return seg, "UpConvBlock"
    raise KeyError(seg)


def _root_mcunet(seg):
    if seg == "in_conv":
        return seg, "DoubleConv"
    if seg == "down4":
        return seg, "InceptionA"
    if seg.startswith("down"):
        return seg, "Down"
    if seg.startswith("cbam"):
        return seg, "CBAM"
    if seg.startswith("up"):
        return seg, "UpV1"
    if seg == "out_conv":
        return seg, "OutConv"
    raise KeyError(seg)


def _root_transfuse(seg):
    # conv_blockK = Sequential(conv, ReLU, max-pool, BN); decoder_blockK =
    # Sequential(convT, ReLU[, conv, ReLU]); decoder_convK = (conv, ReLU)
    block, _, part = seg.rpartition("_")
    if block.startswith("conv_block"):
        return {"conv": (f"{block}.0", "Conv2d"),
                "bn": (f"{block}.3", "BatchNorm2d")}[part]
    if seg == "decoder_block3_conv":
        return "decoder_block3.2", "Conv2d"
    if seg.startswith("decoder_block"):
        return f"{seg}.0", "ConvTranspose2d"
    if seg.startswith("decoder_conv"):
        return f"{seg}.0", "Conv2d"
    if seg == "multihead_attention":
        return seg, "MultiHeadSelfAttention"
    if seg.startswith("cbam"):
        return seg, "PrivateCBAM"
    if seg in ("output_BV", "output_OD"):
        return seg, "Conv2d"
    raise KeyError(seg)


ROOT_RULES = {
    "UNet.UNet": _root_unet,
    "AttentionUNet.AttentionUNet": _root_attention_unet,
    "R2UNet.R2UNet": _root_r2,
    "R2AttentionUNet.R2AttentionUNet": _root_r2,
    "ResUNet.ResUNet": _root_resunet,
    "SegNet.SegNet": _root_segnet,
    "UNetPP.NestedUNet": _root_nested,
    "BCDUNet.BCDU_net_D3": _root_bcdu,
    "BCDUNet.BCDU_net_D1": _root_bcdu,
    "MultiResUNet.MultiResUNet": _root_multires,
    "DenseUNet.DenseUNet": _root_denseunet,
    "FRUNet.FRUNet": _root_frunet,
    "BARUNet.BARUNet": _root_barunet,
    "BIARUNet.BIARUNet": _root_barunet,
    "MCUNet.MCUNet": _root_mcunet,
    "RetinaLiteNet.TransFuseNet": _root_transfuse,
}
_ALIASES = {name.split(".")[-1]: name for name in ROOT_RULES}


class MappingError(RuntimeError):
    pass


def state_dict_from_jax(model_name: str, variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """Map JAX ``variables`` of ``model_name`` to the port's state dict
    (float32 tensors; ``num_batches_tracked`` int64 zeros)."""
    model_name = _ALIASES.get(model_name, model_name)
    if model_name not in ROOT_RULES:
        raise MappingError(
            f"no mapping rules for model {model_name!r}; known: "
            f"{sorted(ROOT_RULES)}")
    return _convert(variables, None, ROOT_RULES[model_name], model_name)


def block_state_dict_from_jax(block_class: str, variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The same for one block of the JAX package (``block_class``: its
    class name in ``ops/blocks.py``, e.g. ``"ResidualConv"``, or a leaf
    class such as ``"MultiHeadSelfAttention"``), keyed as the port's block
    of that name."""
    if block_class not in CHILD_RULES and block_class not in LEAF_CLASSES:
        raise MappingError(f"no mapping rules for block {block_class!r}")
    return _convert(variables, block_class, None, block_class)


def _convert(variables, cls, root, what) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def emit(key, arr):
        if key in out:
            raise MappingError(f"duplicate torch key {key!r}")
        a = np.asarray(arr)
        if a.dtype != np.int64:
            a = a.astype(np.float32)
        # (ascontiguousarray alone makes a 0-d array 1-d)
        out[key] = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))

    def leaf(cls, prefix, params, stats):
        def put(name, arr):
            emit(f"{prefix}.{name}" if prefix else name, arr)

        if cls == "Conv2d":
            put("weight", np.transpose(params["conv"]["kernel"], (3, 2, 0, 1)))
            if "bias" in params["conv"]:
                put("bias", params["conv"]["bias"])
        elif cls == "ConvTranspose2d":
            k = np.asarray(params["conv"]["kernel"])[::-1, ::-1]
            put("weight", np.transpose(k, (2, 3, 0, 1)))
            if "bias" in params["conv"]:
                put("bias", params["conv"]["bias"])
        elif cls == "Linear":
            put("weight", np.transpose(params["linear"]["kernel"]))
            if "bias" in params["linear"]:
                put("bias", params["linear"]["bias"])
        elif cls == "MultiHeadSelfAttention":
            for proj, key in (("in_proj", "in_proj_"),
                              ("out_proj", "out_proj.")):
                put(f"mha.{key}weight", np.transpose(params[proj]["kernel"]))
                put(f"mha.{key}bias", params[proj]["bias"])
        else:  # BatchNorm1d, BatchNorm2d
            put("weight", params["bn"]["scale"])
            put("bias", params["bn"]["bias"])
            put("running_mean", stats["bn"]["mean"])
            put("running_var", stats["bn"]["var"])
            put("num_batches_tracked", np.array(0, np.int64))

    def walk(params, stats, cls, prefix):
        """cls None: the model's root rules (the root itself, or a
        transparent wrapper such as BCDU-Net's encoder and decoder)."""
        if cls in LEAF_CLASSES:
            leaf(cls, prefix, params, stats)
            return
        for seg, sub in params.items():
            rules = root if cls is None else CHILD_RULES[cls]
            try:
                if cls is None:
                    rel, sub_cls = rules(seg)
                elif callable(rules):
                    rel, sub_cls = rules(seg, list(params))
                else:
                    rel, sub_cls = rules[seg]
            except KeyError:
                raise MappingError(
                    f"no root rule for {seg!r} in {what}" if cls is None else
                    f"no rule for child {seg!r} of {cls!r} at {prefix!r}"
                ) from None
            sub_prefix = ".".join(p for p in (prefix, rel) if p)
            walk(sub, (stats or {}).get(seg, {}), sub_cls, sub_prefix)

    walk(variables.get("params", {}), variables.get("batch_stats", {}),
         cls, "")
    return out
