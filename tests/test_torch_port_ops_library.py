"""The port's three kernels as PyTorch operators
(``jcfszxc_unet_tpu_torch/ops/kernels/library.py``): ``opcheck`` of each
on CPU tensors (schema, fake implementation, autograd registration, AOT
dispatch), each CPU implementation equal to its plain version, a backward
through each raising, the wrappers reaching the operators, and the
kernel-1 operator nodes of the exported forward of each of the zoo's 16
models (the three s2d modes are in ``tests/test_torch_port_export.py``,
so that ``--dist loadfile`` spreads the traces).  The ``cuda`` tests hold each operator's CUDA
implementation against its plain version on the card and skip
elsewhere."""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from jcfszxc_unet_tpu_torch.ops import layers
from jcfszxc_unet_tpu_torch.ops.kernels import (
    conv_fused,
    conv_imcol,
    dice_fused,
    library,
)

# The card's image has no flax, so this file imports nothing of the JAX
# package at module level: its cuda tests run there (the graph checks
# import tests/torch_port_common.py, which builds JAX models, when they
# run).
OPS = library.ops
EXPORT_KERNEL_NODES = {
    "UNet.UNet": 18, "ResUNet.ResUNet": 15, "SegNet.SegNet": 26,
    "UNetPP.NestedUNet": 30, "AttentionUNet.AttentionUNet": 22,
    "R2UNet.R2UNet": 58, "R2AttentionUNet.R2AttentionUNet": 58,
    "BCDUNet.BCDU_net_D3": 25, "BCDUNet.BCDU_net_D1": 21,
    "MultiResUNet.MultiResUNet": 37, "DenseUNet.DenseUNet": 40,
    "FRUNet.FRUNet": 44, "BARUNet.BARUNet": 22, "BIARUNet.BIARUNet": 22,
    "MCUNet.MCUNet": 19, "RetinaLiteNet.TransFuseNet": 6,
}


def _conv_args(dtype=torch.float32, b=2, h=7, w=10, cin=16, cout=24,
               relu=True, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    w_km = torch.from_numpy((rng.randn(cout, 3, 3, cin)
                             / math.sqrt(9 * cin)).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(cout)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.randn(cout)).astype(np.float32))
    return x.to(dtype), w_km.to(dtype), scale, shift, relu


def _dice_args(seed=1, b=3, h=13, w=11):
    rng = np.random.RandomState(seed)
    p = torch.from_numpy((rng.rand(b, h, w) * 1.4 - 0.2).astype(np.float32))
    t = torch.from_numpy((rng.rand(b, h, w) > 0.6).astype(np.float32))
    return p, t


def _imcol_args(dtype=torch.float32, seed=2, b=2, h=9, w=7, cin=5, cout=12):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    wt = torch.from_numpy((rng.randn(3, 3, cin, cout)
                           / math.sqrt(9 * cin)).astype(np.float32))
    return conv_imcol.pad_inputs(x.to(dtype), wt.to(dtype))


# (operator, its arguments, its plain version on them, its launch counter)
CASES = {
    "conv_f32": (OPS.conv3x3_affine_relu.default, _conv_args,
                 lambda x, w_km, s, t, r: conv_fused.conv3x3_affine_relu_torch(
                     x, w_km.permute(1, 2, 3, 0), s, t, r),
                 conv_fused.counter),
    "conv_bf16_no_relu": (
        OPS.conv3x3_affine_relu.default,
        lambda: _conv_args(torch.bfloat16, cin=3, cout=64, relu=False),
        lambda x, w_km, s, t, r: conv_fused.conv3x3_affine_relu_torch(
            x, w_km.permute(1, 2, 3, 0), s, t, r),
        conv_fused.counter),
    "dice": (OPS.dice_sums.default, _dice_args, dice_fused.dice_sums_torch,
             dice_fused.counter),
    "imcol": (OPS.conv3x3_relu_imcol.default, _imcol_args,
              lambda xp, wt: conv_imcol.conv3x3_relu_imcol_torch(
                  xp[:, 1:-1, 1:-1], wt.t().reshape(
                      3, 3, xp.shape[3], wt.shape[0]).contiguous()),
              conv_imcol.counter),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    """Schema, fake implementation (shape, dtype, strides against the CPU
    implementation), autograd registration and AOT dispatch."""
    op, args, _, _ = CASES[case]
    torch.library.opcheck(op, args())


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_implementation_is_the_plain_version_and_counts_nothing(case):
    op, args, plain, counter = CASES[case]
    a = args()
    before = counter.launches
    got = op(*a)
    want = plain(*a)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)
    assert counter.launches == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_through_an_operator_raises(case):
    """Eval-mode kernels: a gradient never silently flows through (or
    around) one."""
    op, args, _, _ = CASES[case]
    a = list(args())
    a[0] = a[0].float().requires_grad_() if a[0].dtype == torch.float32 \
        else a[0].requires_grad_()
    out = op(*a)
    out = out[0] if isinstance(out, tuple) else out
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="eval-mode kernels"):
        out.float().sum().backward()


def test_the_wrappers_call_the_operators():
    """Under a FakeTensorMode (what torch.export traces with) each public
    wrapper runs its checks and returns the operator's output layout."""
    x, w_km, scale, shift, _ = _conv_args()
    p, t = _dice_args()
    xi = torch.rand(2, 9, 7, 5)
    wi = torch.rand(3, 3, 5, 12)
    with FakeTensorMode() as mode:
        fx, fw, fs, fh, fp, ft, fxi, fwi = map(mode.from_tensor, (
            x, w_km, scale, shift, p, t, xi, wi))
        y = conv_fused.conv3x3_affine_relu_kmajor(fx, fw, fs, fh)
        y2 = conv_fused.conv3x3_affine_relu(
            fx, fw.permute(1, 2, 3, 0).contiguous(), fs, fh)
        sums = dice_fused.dice_sums(fp, ft)
        yi = conv_imcol.conv3x3_relu_imcol(fxi, fwi)
        with pytest.raises(ValueError, match="channels"):
            conv_fused.conv3x3_affine_relu_kmajor(fx[..., :8].contiguous(),
                                                  fw, fs, fh)
    for out, shape in ((y, (2, 7, 10, 24)), (y2, (2, 7, 10, 24)),
                       (yi, (2, 9, 7, 12))):
        assert tuple(out.shape) == shape and out.is_contiguous()
    assert [tuple(s.shape) for s in sums] == [(3,)] * 3

    class Wrappers(torch.nn.Module):
        def forward(self, x, w_km, scale, shift, p, t, xi, wi):
            return (conv_fused.conv3x3_affine_relu_kmajor(x, w_km, scale,
                                                          shift),
                    *dice_fused.dice_sums(p, t),
                    conv_imcol.conv3x3_relu_imcol(xi, wi))

    program = torch.export.export(Wrappers(), (x, w_km, scale, shift, p, t,
                                               xi, wi))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    for op in (OPS.conv3x3_affine_relu.default, OPS.dice_sums.default,
               OPS.conv3x3_relu_imcol.default):
        assert targets.count(op) == 1


def test_a_trace_does_not_enter_the_resize_caches():
    """A tensor built while ``torch.export`` traces (a fake one) never
    enters the resizes' caches (``layers.trace_safe_cache``): an eager call
    after an export returns real tensors, equal to those of a fresh
    cache, and the program holds the matrices as constants."""

    class Resize(torch.nn.Module):
        def forward(self, x):
            return (layers.resize_linear_align_corners(x, 13, 9),
                    layers.resize_nearest_align_corners(x, 13, 9))

    caches = (layers._linear_resize_tensor, layers._nearest_index_tensor)
    x = torch.rand(2, 5, 7, 3)
    for cache in caches:
        cache.cache_clear()
    program = torch.export.export(Resize(), (x,))
    after = Resize()(x)
    for cache in caches:
        cache.cache_clear()
    fresh = Resize()(x)
    traced = program.module()(x)
    for a, f, t in zip(after, fresh, traced):
        assert torch.equal(a, f) and torch.equal(t, f)


def test_resize_caches_made_in_inference_mode_serve_training():
    """The resizes' matrices may first be cached by a validation under
    ``torch.inference_mode``; a train step after it must still be able to
    save them for the backward."""
    for cache in (layers._linear_resize_tensor, layers._nearest_index_tensor):
        cache.cache_clear()
    x = torch.rand(2, 5, 7, 3)
    with torch.inference_mode():
        layers.resize_linear_align_corners(x, 13, 9)
        layers.resize_nearest_align_corners(x, 13, 9)
    xg = x.clone().requires_grad_(True)
    (layers.resize_linear_align_corners(xg, 13, 9).sum()
     + layers.resize_nearest_align_corners(xg, 13, 9).sum()).backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


# The s2d modes are in tests/test_torch_port_export.py.
@pytest.mark.parametrize("name", sorted(EXPORT_KERNEL_NODES))
def test_exported_graph_holds_one_operator_node_per_kernel_call(
        name, monkeypatch):
    from .torch_port_common import check_export_graph

    program = check_export_graph(name, monkeypatch)
    assert len([n for n in program.graph.nodes if n.target
                is OPS.conv3x3_affine_relu.default]) == (
        EXPORT_KERNEL_NODES[name])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_implementation_matches_plain_on_gpu(cuda_device, case,
                                                 monkeypatch):
    """One launch per call, counted; within the kernels' stated tolerances
    of the plain version (f32 accumulation in both, TF32 off for the plain
    version's cuDNN conv; bf16 one rounding)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    op, args, plain, counter = CASES[case]
    a = [t.to(cuda_device) if isinstance(t, torch.Tensor) else t
         for t in args()]
    before = counter.launches
    got = op(*a)
    want = plain(*a)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    tol = 1e-2 if a[0].dtype == torch.bfloat16 else 1e-4
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.shape == w.shape and g.is_contiguous()
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())


@pytest.mark.cuda
def test_exported_unet_launches_the_kernel_on_the_card(cuda_device):
    """On the card: 18 kernel-1 launches per call of the loaded program
    (17 ``wgmma`` + 1 ``mma_sync``), and the eager Predictor's
    probabilities (same kernels, same plans)."""
    from jcfszxc_unet_tpu_torch.eval.export import (
        export_forward,
        load_exported,
    )
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
    from jcfszxc_unet_tpu_torch.models import create_model

    model = create_model("UNet.UNet")
    layers.reset_parameters(model, torch.Generator().manual_seed(5))
    fn = load_exported(export_forward(model, 2, 64, device=cuda_device))
    x = torch.rand(2, 64, 64, 3, device=cuda_device).to(torch.bfloat16)
    want = Predictor(model, device=cuda_device).predict_patches(x)
    before = dict(conv_fused.counter.bodies)
    got = fn(x)
    torch.cuda.synchronize()
    added = {k: v - before.get(k, 0)
             for k, v in conv_fused.counter.bodies.items()
             if v != before.get(k, 0)}
    assert added == {"wgmma": 17, "mma_sync": 1}
    assert float((got - want).abs().max()) <= 1e-3
