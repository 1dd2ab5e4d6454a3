"""The port's UNet against the JAX UNet on the same weights (CPU, f32):
the weight bridge, the eval-mode DoubleConv with its BatchNorm folded into
the fused conv, the whole forward, the registry and the checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.compat.torch_mapping import variables_to_state_dict
from jcfszxc_unet_tpu.ops.blocks import DoubleConv as JaxDoubleConv
from jcfszxc_unet_tpu.ops.layers import pad_or_crop_to as jax_pad_or_crop_to
from jcfszxc_unet_tpu.train import checkpoint as jax_ckpt
from jcfszxc_unet_tpu_torch.compat.from_jax import (
    MappingError,
    state_dict_from_jax,
)
from jcfszxc_unet_tpu_torch.models import create_model, resolve_model
from jcfszxc_unet_tpu_torch.ops.blocks import DoubleConv
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
from jcfszxc_unet_tpu_torch.ops.layers import pad_or_crop_to
from jcfszxc_unet_tpu_torch.train.checkpoint import load_model, save_model

from .torch_port_common import jax_unet, port_unet, randomize_bn


@pytest.fixture(scope="module")
def unet():
    model, variables = jax_unet(seed=0)
    return model, variables, port_unet(variables)


def test_state_dict_from_jax_equals_torch_mapping(unet):
    _, variables, port = unet
    got = state_dict_from_jax("UNet.UNet", variables)
    want = variables_to_state_dict("UNet.UNet", variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert sorted(port.state_dict()) == sorted(want)  # loaded strict=True


def test_state_dict_from_jax_refuses_unported_models_and_stray_keys(unet):
    # every model of the zoo has rules (tests/test_torch_port_zoo_*.py);
    # an unknown name, or a tree with a child no rule knows, is refused
    _, variables, _ = unet
    with pytest.raises(MappingError, match="no mapping rules"):
        state_dict_from_jax("NoSuchNet.NoSuchNet", variables)
    bad = {"params": {**variables["params"], "extra": {}},
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(MappingError, match="extra"):
        state_dict_from_jax("UNet", bad)


def test_double_conv_eval_matches_jax():
    jmod = JaxDoubleConv(3, 8)
    rng = np.random.RandomState(5)
    x = rng.rand(2, 9, 7, 3).astype(np.float32)
    variables = randomize_bn(
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False), 6)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))

    port = DoubleConv(3, 8).eval()
    sd = {}
    for tk, (conv, bn) in (("0", ("Conv2d_0", "BatchNorm2d_0")),
                           ("3", ("Conv2d_1", "BatchNorm2d_1"))):
        sd[f"double_conv.{tk}.weight"] = torch.from_numpy(np.transpose(
            variables["params"][conv]["conv"]["kernel"], (3, 2, 0, 1)).copy())
        i = str(int(tk) + 1)
        p, s = variables["params"][bn]["bn"], variables["batch_stats"][bn]["bn"]
        sd[f"double_conv.{i}.weight"] = torch.from_numpy(p["scale"])
        sd[f"double_conv.{i}.bias"] = torch.from_numpy(p["bias"])
        sd[f"double_conv.{i}.running_mean"] = torch.from_numpy(s["mean"])
        sd[f"double_conv.{i}.running_var"] = torch.from_numpy(s["var"])
        sd[f"double_conv.{i}.num_batches_tracked"] = torch.tensor(0)
    port.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last NCHW view
    with torch.no_grad():
        got = port(xt)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,w", [(32, 32), (36, 28)])  # 36x28: Up pads
def test_unet_eval_forward_matches_jax(unet, h, w):
    jmodel, variables, port = unet
    x = np.random.RandomState(7).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    before = conv_fused.counter.launches
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert conv_fused.counter.launches == before  # plain version on the CPU
    assert got.shape == (2, 1, h, w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_pad_or_crop_to_matches_jax():
    x = np.random.RandomState(8).rand(1, 5, 7, 2).astype(np.float32)
    for th, tw in ((3, 9), (8, 4), (5, 7)):
        want = np.asarray(jax_pad_or_crop_to(jnp.asarray(x), th, tw))
        got = pad_or_crop_to(torch.from_numpy(x).permute(0, 3, 1, 2), th, tw)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_registry_names():
    from jcfszxc_unet_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from jcfszxc_unet_tpu_torch.models import MODEL_REGISTRY

    assert resolve_model("UNet.UNet") is resolve_model("UNet")
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    for name in JAX_REGISTRY:
        assert resolve_model(name) is resolve_model(name.split(".")[-1])
    with pytest.raises(KeyError, match="unknown model 'NoSuchNet'"):
        create_model("NoSuchNet")


def test_checkpoint_roundtrip_and_refusal(unet, tmp_path):
    jmodel, variables, port = unet
    path = str(tmp_path / "unet.pt")
    save_model(path, "UNet.UNet", {}, port)
    model, cfg = load_model(path, device="cpu")
    assert cfg == {"model_name": "UNet.UNet", "model_kwargs": {}}
    assert not model.training
    for k, v in port.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    # a JAX msgpack checkpoint is refused with a clear message
    jpath = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_model(jpath, "UNet.UNet", {}, variables["params"],
                        variables["batch_stats"])
    with pytest.raises(ValueError, match="not ported yet"):
        load_model(jpath, device="cpu")


def test_load_model_defaults_to_the_card(unet, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    path = str(tmp_path / "unet.pt")
    save_model(path, "UNet.UNet", {}, unet[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(path)
