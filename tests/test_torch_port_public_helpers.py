"""Three small public functions of the JAX package that the port holds
too, against their JAX counterparts: ``utils/vis.vis_numpy_img``,
``models/RetinaLiteNet.create_transfuse_net`` and
``eval/metrics.confusion_counts`` (which ``classification_metrics`` now
calls)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jcfszxc_unet_tpu.eval import metrics as jax_metrics
from jcfszxc_unet_tpu.models.RetinaLiteNet import (
    create_transfuse_net as jax_create_transfuse_net,
)
from jcfszxc_unet_tpu.utils.vis import vis_numpy_img as jax_vis_numpy_img
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.eval import metrics
from jcfszxc_unet_tpu_torch.models.RetinaLiteNet import create_transfuse_net
from jcfszxc_unet_tpu_torch.utils.vis import vis_numpy_img

from .torch_port_common import (
    EVAL_TOL,
    assert_close_to,
    jax_apply,
    to_nhwc,
    to_port,
)


@pytest.mark.parametrize("kind", ["rgb", "gray", "one_channel", "mixed"])
def test_vis_numpy_img_writes_jax_png(tmp_path, kind):
    rng = np.random.RandomState(0)
    shapes = {"rgb": [(12, 9, 3)] * 3, "gray": [(12, 9)] * 2,
              "one_channel": [(12, 9, 1)], "mixed": [(12, 9, 3), (12, 9),
                                                     (12, 7, 1)]}[kind]
    imgs = [rng.rand(*s).astype(np.float32) for s in shapes]
    got, want = tmp_path / "port.png", tmp_path / "jax.png"
    vis_numpy_img(imgs, str(got))
    jax_vis_numpy_img(imgs, str(want))
    a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
    assert a.shape == b.shape == (12, sum(s[1] for s in shapes) + 8 * len(
        shapes), 3)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("input_shape,channels", [((1, 32, 32), 1),
                                                  ((3, 32, 32), 3),
                                                  ([1, 32, 32], 3)])
def test_create_transfuse_net_matches_jax(input_shape, channels):
    """A (C, H, W) tuple gives C input channels, anything else 3; the JAX
    model's weights load strict and the eval forwards agree."""
    port = create_transfuse_net(input_shape)
    jmodel = jax_create_transfuse_net(input_shape)
    assert port.n_channels == channels
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, channels)))
    port.load_state_dict(state_dict_from_jax("RetinaLiteNet.TransFuseNet",
                                             variables), strict=True)
    port = port.to(memory_format=torch.channels_last).eval()
    x = np.random.RandomState(1).rand(2, 32, 32, channels).astype(np.float32)
    want = np.asarray(jax_apply(jmodel, variables, x, train=False))
    with torch.no_grad():
        got = to_nhwc(port(to_port(x)))
    assert_close_to(got, want, EVAL_TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_confusion_counts_match_jax(with_mask):
    rng = np.random.RandomState(2)
    pred = (rng.rand(2, 9, 7) > 0.5).astype(np.float32)
    target = rng.rand(2, 9, 7).astype(np.float32)
    mask = (rng.rand(2, 9, 7) > 0.3).astype(np.float32) if with_mask else None
    got = metrics.confusion_counts(
        torch.from_numpy(pred), torch.from_numpy(target),
        None if mask is None else torch.from_numpy(mask))
    want = jax_metrics.confusion_counts(
        jnp.asarray(pred), jnp.asarray(target),
        None if mask is None else jnp.asarray(mask))
    assert [float(g) for g in got] == [float(w) for w in want]
    total = float(mask.sum()) if with_mask else pred.size
    assert sum(float(g) for g in got) == total
    acc, se, sp = metrics.classification_metrics(
        torch.from_numpy(pred), torch.from_numpy(target),
        None if mask is None else torch.from_numpy(mask))
    tp, fp, fn, tn = (float(g) for g in got)
    assert float(acc) == pytest.approx((tp + tn) / total, rel=1e-6)
    assert float(se) == pytest.approx(tp / (tp + fn), rel=1e-6)
    assert float(sp) == pytest.approx(tn / (tn + fp), rel=1e-6)
