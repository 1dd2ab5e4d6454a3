"""The fractal trainer's building blocks in the port against the JAX
package: the align-corners resizes (also against scipy's zoom), the
box-counting dimension, FractalLoss, the Sobel and self-supervised losses,
the multi-scale sample maps and batch, and the feature extractor with
weights carried across by the port's bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu.train import fractal as jfr
from jcfszxc_unet_tpu_torch.compat.from_jax import block_state_dict_from_jax
from jcfszxc_unet_tpu_torch.data.sampler import sample_centers
from jcfszxc_unet_tpu_torch.ops import layers
from jcfszxc_unet_tpu_torch.train import fractal as pfr

from .torch_port_common import to_nhwc, to_port

# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------

RESIZES = [((84, 84), 128), ((56, 56), 128), ((85, 85), 128),
           ((85, 56), 128)]


def _zoom(x, out, order):
    """scipy.ndimage.zoom of each (H, W) plane of NHWC ``x`` to out^2."""
    n, h, w, c = x.shape
    return np.stack([np.stack([
        zoom(x[i, :, :, k], (out / h, out / w), order=order)
        for k in range(c)], -1) for i in range(n)])


@pytest.mark.parametrize("in_hw,out", RESIZES,
                         ids=[f"{h}x{w}-{o}" for (h, w), o in RESIZES])
def test_resize_linear_against_jax_and_scipy(in_hw, out):
    x = np.random.RandomState(sum(in_hw)).rand(2, *in_hw, 3).astype(
        np.float32)
    got = layers.resize_linear_align_corners(torch.from_numpy(x), out,
                                             out).numpy()
    want = np.asarray(jax_layers.resize_linear_align_corners(
        jnp.asarray(x), out, out))
    assert got.shape == (2, out, out, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Both packages compute the source grid k * (in - 1) / (out - 1) and
    # its fractions in f32, scipy in f64: over these cases the outputs
    # differ by up to 6.4e-6 (the JAX package's own scipy check takes
    # 1e-5; ``python -m tests.test_torch_port_fractal_ops`` prints each).
    np.testing.assert_allclose(got, _zoom(x, out, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("in_hw,out", RESIZES,
                         ids=[f"{h}x{w}-{o}" for (h, w), o in RESIZES])
def test_resize_nearest_against_jax_and_scipy(in_hw, out):
    x = (np.random.RandomState(sum(in_hw) + 1).rand(2, *in_hw, 1)
         > 0.5).astype(np.float32)
    got = layers.resize_nearest_align_corners(torch.from_numpy(x), out,
                                              out).numpy()
    want = np.asarray(jax_layers.resize_nearest_align_corners(
        jnp.asarray(x), out, out))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _zoom(x, out, 0))
    # F.interpolate's nearest grid, floor(k * in / out), is another one
    other = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(out, out),
        mode="nearest").permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(other, want)


# ---------------------------------------------------------------------------
# box dimension, losses
# ---------------------------------------------------------------------------

def _maps():
    rng = np.random.RandomState(5)
    line = np.zeros((64, 64), np.float32)
    line[32, :] = 1.0
    return {"empty": np.zeros((32, 32), np.float32),
            "full": np.ones((64, 64), np.float32),
            "line": line,
            "non_square": (rng.rand(48, 56) > 0.7).astype(np.float32),
            "non_pow2": (rng.rand(37, 29) > 0.6).astype(np.float32),
            "soft": rng.rand(33, 45).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_maps()))
def test_box_dimension(name):
    m = _maps()[name]
    got = float(pfr.box_dimension(torch.from_numpy(m)))
    want = float(jfr.box_dimension(jnp.asarray(m)))
    assert abs(got - want) <= 1e-5, (got, want)
    if name == "empty":
        assert got == 0.0


def test_box_dimension_batched_equals_per_map():
    rng = np.random.RandomState(6)
    maps = (rng.rand(5, 40, 36) > 0.5).astype(np.float32)
    maps[2] = 0.0
    got = pfr.box_dimension(torch.from_numpy(maps)).numpy()
    want = np.asarray(jax.vmap(jfr.box_dimension)(jnp.asarray(maps)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[2] == 0.0


@pytest.mark.parametrize("batch", [6, 3])
def test_fractal_loss_on_jax_permutation(batch):
    rng = np.random.RandomState(batch)
    logits = (2 * rng.randn(batch, 32, 32, 1)).astype(np.float32)
    target = (rng.rand(batch, 32, 32, 1) > 0.5).astype(np.float32)
    target[0] = 0.0  # an empty target map among the samples
    key = jax.random.PRNGKey(batch)
    want = float(jax.jit(jfr.fractal_loss)(jnp.asarray(logits),
                                           jnp.asarray(target), key))
    idx = np.asarray(jax.random.permutation(key, batch))[:min(4, batch)]
    got = float(pfr.fractal_loss(torch.from_numpy(logits),
                                 torch.from_numpy(target),
                                 torch.from_numpy(idx.astype(np.int64))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fractal_sample_indices():
    g = torch.Generator().manual_seed(0)
    idx = pfr.fractal_sample_indices(g, 6)
    assert idx.shape == (4,) and len(set(idx.tolist())) == 4
    assert pfr.fractal_sample_indices(g, 3).shape == (3,)


def test_sobel_and_self_supervised_losses():
    rng = np.random.RandomState(7)
    a = rng.rand(2, 16, 20, 2).astype(np.float32)
    b = rng.rand(2, 16, 20, 2).astype(np.float32)
    for got, want in zip(pfr._sobel_gradients(torch.from_numpy(a)),
                         jfr._sobel_gradients(jnp.asarray(a))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    got = float(pfr.fractal_self_supervised_loss(torch.from_numpy(a),
                                                 torch.from_numpy(b)))
    want = float(jfr.fractal_self_supervised_loss(jnp.asarray(a),
                                                  jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    same = pfr.fractal_self_supervised_loss(torch.from_numpy(a),
                                            torch.from_numpy(a))
    assert float(same) < 1e-10


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_level_counts_and_windows_at_the_defaults():
    # batch 32: [32, 16, 8] over-allocates and the negative remainder comes
    # off level 0; patch 128 gives levels of 128, 85 and 56, cut as even
    # windows of 128, 84 and 56
    assert pfr.level_sample_counts(32) == jfr.level_sample_counts(32) == [
        8, 16, 8]
    for b in (7, 8, 12, 33):
        assert pfr.level_sample_counts(b) == jfr.level_sample_counts(b)
        assert sum(pfr.level_sample_counts(b)) == b
    sizes, _ = pfr.build_fractal_sample_maps(
        np.ones((1, 200, 200), np.float32), 128)
    assert sizes == [128, 85, 56]
    assert [2 * (s // 2) for s in sizes] == [128, 84, 56]


@pytest.mark.parametrize("kind", ["fov", "sparse", "degenerate"])
def test_sample_maps_equal_jax(kind):
    rng = np.random.RandomState(8)
    if kind == "fov":
        yy, xx = np.mgrid[:60, :52]
        masks = np.repeat(((yy - 30) ** 2 + (xx - 26) ** 2 <= 22 ** 2)
                          [None].astype(np.float32), 2, axis=0)
    elif kind == "sparse":
        masks = (rng.rand(3, 60, 52) > 0.97).astype(np.float32) * 0.5
    else:
        masks = np.zeros((2, 60, 52), np.float32)
    got_sizes, got = pfr.build_fractal_sample_maps(masks, 32)
    want_sizes, want = jfr.build_fractal_sample_maps(masks, 32)
    assert got_sizes == want_sizes
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _jax_centers(key, level_maps, counts):
    """The centers JAX's fractal_sample_batch draws from ``key``."""
    keys = jax.random.split(key, len(level_maps))
    out = []
    for lk, lmap, cnt in zip(keys, level_maps, counts):
        idx = np.asarray(jax.random.randint(lk, (max(cnt, 0),), 0,
                                            lmap.shape[0]))
        out.append(lmap[idx])
    return out


def test_fractal_sample_batch_on_jax_centers():
    rng = np.random.RandomState(9)
    masks = (rng.rand(2, 96, 90) > 0.4).astype(np.float32)
    images = rng.rand(2, 96, 90, 3).astype(np.float32)
    sizes, maps = jfr.build_fractal_sample_maps(masks, 32)
    counts = jfr.level_sample_counts(8)
    key = jax.random.PRNGKey(3)
    want_i, want_t = jfr.fractal_sample_batch(
        key, jnp.asarray(images), jnp.asarray(masks[..., None]),
        [jnp.asarray(m) for m in maps], sizes, counts, 32)
    centers = [torch.from_numpy(c).long()
               for c in _jax_centers(key, maps, counts)]
    got_i, got_t = pfr.fractal_sample_batch(
        torch.from_numpy(images), torch.from_numpy(masks[..., None]),
        centers, sizes, 32)
    assert got_i.shape == (8, 32, 32, 3) and got_t.shape == (8, 32, 32, 1)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_sample_fractal_centers_rows_of_each_map():
    maps = [torch.arange(30).view(10, 3), torch.arange(6).view(2, 3),
            torch.arange(9).view(3, 3)]
    g = torch.Generator().manual_seed(1)
    # the trainer's per-level draw: one sample_centers call per level
    centers = [sample_centers(g, m, cnt) for m, cnt in zip(maps, [2, 5, 0])]
    assert [c.shape[0] for c in centers] == [2, 5, 0]
    for c, m in zip(centers, maps):
        rows = {tuple(r) for r in m.tolist()}
        assert all(tuple(r) in rows for r in c.tolist())


# ---------------------------------------------------------------------------
# the feature extractor
# ---------------------------------------------------------------------------

def _extractor_pair(seed=0, hw=24):
    jext = jfr.FractalFeatureExtractor(3)
    variables = jax.jit(jext.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, hw, hw, 3), jnp.float32))
    variables = jax.tree.map(np.asarray, variables)
    port = pfr.FractalFeatureExtractor(3)
    port.load_state_dict(block_state_dict_from_jax(
        "FractalFeatureExtractor", variables), strict=True)
    return jext, variables, port.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_extractor_against_jax(mode, monkeypatch):
    jext, variables, port = _extractor_pair()
    x = np.random.RandomState(10).rand(2, 24, 20, 3).astype(np.float32)
    want = np.asarray(jax.jit(jext.apply)(variables, jnp.asarray(x)))
    calls = []
    real = pfr.conv3x3_folded

    def counting(xc, w_km, scale, shift, relu):
        calls.append(tuple(w_km.shape))
        return real(xc, w_km, scale, shift, relu)

    monkeypatch.setattr(pfr, "conv3x3_folded", counting)
    port.train(mode == "train")
    with torch.no_grad():
        got = to_nhwc(port(to_port(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # eval: the two undilated convs in one call of the kernel's entry
    assert calls == ([] if mode == "train" else [(32, 3, 3, 3)])


def test_extractor_state_dict_names():
    _, variables, port = _extractor_pair()
    assert sorted(port.state_dict()) == sorted(
        f"{name}.{leaf}" for name in (
            "fractal_conv1", "fractal_conv2", "ms_conv_d1", "ms_conv_d2",
            "ms_conv_d4", "ms_conv_d8", "fusion_conv")
        for leaf in ("weight", "bias"))
    assert tuple(port.ms_conv_d8.weight.shape) == (16, 3, 3, 3)
    assert port.ms_conv_d8.dilation == (8, 8)
    assert tuple(port.fusion_conv.weight.shape) == (3, 65, 1, 1)


# ---------------------------------------------------------------------------
# The differences against the JAX package and scipy that ROADMAP.md's
# Queue 3 quotes:  JAX_PLATFORMS=cpu python -m tests.test_torch_port_fractal_ops
# ---------------------------------------------------------------------------

def _report_differences():
    from jcfszxc_unet_tpu.train.optim import make_optimizer as jax_optimizer

    from .torch_port_common import jax_model

    for (h, w), out in RESIZES:
        x = np.random.RandomState(h + w).rand(2, h, w, 3).astype(np.float32)
        got = layers.resize_linear_align_corners(torch.from_numpy(x), out,
                                                 out).numpy()
        print(f"linear resize {h}x{w} -> {out}: max |port - scipy zoom| "
              f"{np.abs(got - _zoom(x, out, 1)).max():.3e}")

    rng = np.random.RandomState(0)
    worst = 0.0
    for _ in range(200):
        h, w = rng.randint(20, 300, 2)
        m = (rng.rand(h, w) > rng.rand()).astype(np.float32)
        worst = max(worst, abs(float(pfr.box_dimension(torch.from_numpy(m)))
                               - float(jfr.box_dimension(jnp.asarray(m)))))
    print(f"box_dimension over 200 random maps of 20-300 pixels a side: "
          f"max |port - JAX| {worst:.3e}")

    # One optax step on zero gradients (lr 1e-3): the decay that moves
    # TransFuseNet's unused output_OD head in the JAX package.
    import optax

    _, variables = jax_model("RetinaLiteNet.TransFuseNet", seed=0, hw=32)
    params = variables["params"]
    tx = jax_optimizer(1e-3)
    zeros = jax.tree.map(jnp.zeros_like, params)
    updates, _ = tx.update(zeros, tx.init(params), params)
    moved = optax.apply_updates(params, updates)
    for leaf in ("kernel", "bias"):
        before = np.asarray(params["output_OD"]["conv"][leaf])
        after = np.asarray(moved["output_OD"]["conv"][leaf])
        print(f"output_OD {leaf} after one optax step on zero gradients: "
              f"max change {np.abs(after - before).max():.3e} of max |value| "
              f"{np.abs(before).max():.3e}")


if __name__ == "__main__":
    _report_differences()
