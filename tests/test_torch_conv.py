"""The fused conv's slice of the port (B7) against the JAX package:
`conv2d_fused_plain` against the Pallas kernel `conv2d_fused_pallas` in
interpret mode for every flag set the ResNet trunk uses and for stride 1
and 2 with 3x3 and 1x1 windows; `FusedConv`'s gradients against
`reference_conv`'s and the JAX `custom_vjp`'s; the tiny ResNet with
`conv_kernel=True` against the JAX ResNet whose `fused_conv` is routed
through the same Pallas kernel (tests/torch_parity.py::jax_conv_kernel).

x is f32 on both sides, so both outputs are f32 computed from operands
rounded to bf16 with f32 accumulators; they differ only in summation
order, held at the tower tolerance atol 2e-4 / rtol 1e-3
(tests/test_audio_tower.py:82).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu.ops.conv_block import _FUSED, conv2d_fused_pallas
from omni_avsr_tpu_torch.ops.conv_block import (
    FusedConv,
    conv2d_fused,
    conv2d_fused_plain,
    fused_conv,
    reference_conv,
)

TOWER_TOL = dict(atol=2e-4, rtol=1e-3)


def _case(F, H, Cin, Cout, k, stride, pad, affine, act, residual, seed=0):
    rng = np.random.RandomState(seed)
    Ho = (H + 2 * pad - k) // stride + 1
    x = (rng.randn(F, H, H, Cin) * 0.5).astype(np.float32)
    w = (rng.randn(k, k, Cin, Cout) * 0.1).astype(np.float32)
    scale = (rng.randn(Cout) * 0.3 + 1.0).astype(np.float32) if affine else None
    bias = (rng.randn(Cout) * 0.3).astype(np.float32) if affine else None
    a = np.abs(rng.randn(Cout) * 0.25).astype(np.float32) if act else None
    res = (rng.randn(F, Ho, Ho, Cout) * 0.5).astype(np.float32) if residual else None
    return x, w, scale, bias, a, res


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [
    # F, H, Cin, Cout, k, stride, pad, affine, act, residual
    (4, 8, 16, 16, 3, 1, 1, True, True, True),      # conv2 of a block: affine, act, residual
    (4, 9, 16, 32, 3, 2, 1, True, True, False),     # conv1 of a downsampling block
    (4, 9, 16, 32, 1, 2, 0, True, False, False),    # the downsample: 1x1 stride 2, pad 0
    (4, 8, 32, 16, 3, 1, 1, False, False, False),   # the raw conv of train mode
    (3, 11, 16, 32, 3, 2, 1, True, True, False),    # odd F and H
    (2, 6, 32, 32, 1, 1, 0, True, False, True),     # 1x1 stride 1 with a residual
    (4, 3, 16, 16, 3, 1, 1, True, True, True),      # layer4's 3x3 maps
]


@pytest.mark.parametrize("case", CASES)
def test_conv2d_fused_plain_matches_jax_kernel(case):
    F, H, Cin, Cout, k, stride, pad = case[:7]
    x, w, scale, bias, a, res = _case(*case)
    ref = conv2d_fused_pallas(*map(_j, (x, w)), stride, pad, *map(_j, (scale, bias, a, res)),
                              interpret=True)
    ours = conv2d_fused(*map(_t, (x, w)), stride, pad, *map(_t, (scale, bias, a, res)))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOWER_TOL)
    np.testing.assert_array_equal(
        ours.numpy(), conv2d_fused_plain(*map(_t, (x, w)), stride, pad,
                                         *map(_t, (scale, bias, a, res))).numpy())


def test_conv2d_fused_bf16_input_stores_bf16():
    """A bf16 x gives a bf16 result on both sides, one rounding apart."""
    x, w, scale, bias, a, res = _case(*CASES[0])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    rb = jnp.asarray(res).astype(jnp.bfloat16)
    ref = conv2d_fused_pallas(xb, jnp.asarray(w), 1, 1, *map(_j, (scale, bias, a)), rb,
                              interpret=True)
    ours = conv2d_fused(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                        _t(w), 1, 1, *map(_t, (scale, bias, a)),
                        torch.from_numpy(np.asarray(rb.astype(jnp.float32))).bfloat16())
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)  # one bf16 rounding of values up to ~4


def test_fused_conv_off_is_the_reference_route():
    x, w, scale, bias, a, res = map(_t, _case(*CASES[0]))
    np.testing.assert_array_equal(fused_conv(x, w, 1, 1, scale, bias, a, res).numpy(),
                                  reference_conv(x, w, 1, 1, scale, bias, a, res).numpy())


def test_fused_conv_grads_match_reference_and_jax():
    """The backward recomputes through `reference_conv`: with a fixed
    cotangent its grads equal the reference's, and the JAX custom_vjp's
    (tests/test_conv_block.py:53-81)."""
    x, w, scale, bias, a, res = _case(4, 8, 8, 8, 3, 1, 1, True, True, True, seed=3)
    ct = np.random.RandomState(6).randn(4, 8, 8, 8).astype(np.float32)

    def grads(fn):
        xt, wt, st, bt, at, rt = (torch.from_numpy(v).requires_grad_(True)
                                  for v in (x, w, scale, bias, a, res))
        y = fn(xt, wt, st, bt, at, rt)
        return torch.autograd.grad((y.float() * torch.from_numpy(ct)).sum(),
                                   (xt, wt, st, bt, at, rt))

    fused = grads(lambda *t: FusedConv.apply(*t, 1, 1))
    ref = grads(lambda xt, wt, *rest: reference_conv(xt, wt, 1, 1, *rest))
    for g_f, g_r in zip(fused, ref):
        np.testing.assert_allclose(g_f.numpy(), g_r.numpy(), atol=1e-6, rtol=1e-6)

    def jax_loss(*args):
        y = _FUSED[(True, True, True)](1, 1, *args)
        return jnp.sum(y.astype(jnp.float32) * ct)

    jg = jax.grad(jax_loss, argnums=tuple(range(6)))(*map(jnp.asarray, (x, w, scale, bias, a, res)))
    for g_f, g_j in zip(fused, jg):
        np.testing.assert_allclose(g_f.numpy(), np.asarray(g_j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("train_mode", [False, True])
def test_resnet3d_conv_kernel_matches_jax(monkeypatch, train_mode):
    """The tiny flagship's ResNet (the trunk is full width at every size)
    on 2 x 4 frames: eval mode with the folded BN, the residual and PReLU
    in B7's epilogue, train mode with B7's raw convs.

    Tolerance: relative L2 1e-2 over the whole output, not the elementwise
    tower tolerance. Each conv holds that tolerance on its own (above); but
    B7 rounds every conv's input to bf16, and an input that the two sides
    computed one f32 ulp apart (summation order) rounds to neighbouring
    bf16 values when it lies at a rounding boundary. Over 19 convs of a
    randomly initialised trunk these steps grow: perturbing the port's own
    input by 1e-7 relative moves its trunk output by 2e-3 relative L2, and
    the JAX route differs from the port's by 2e-3 (eval) and 5e-3 (train).
    The tokens of a whole served batch through this route are held
    identical to the JAX package's in tests/test_torch_kernel_routes.py."""
    from omni_avsr_tpu.models.resnet3d import resnet3d_forward as jax_resnet
    from omni_avsr_tpu_torch.bridge import init_params, params_from_numpy
    from omni_avsr_tpu_torch.models.omni import flagship
    from omni_avsr_tpu_torch.models.resnet3d import resnet3d_forward
    from tests.torch_parity import jax_conv_kernel

    jax_conv_kernel(monkeypatch)
    model = flagship(tiny=True, dtype=torch.float32)
    tree = init_params(model.cfg, torch.Generator().manual_seed(0), "cpu",
                       frozen_dtype=torch.float32)["avhubert"]["video_frontend"]

    def to_numpy(node):
        return {k: (to_numpy(v) if isinstance(v, dict) else v.numpy()) for k, v in node.items()}

    jp = to_numpy(tree)
    rng = np.random.RandomState(2)
    for block in ("b0", "b1"):  # non-trivial BN statistics, so the folds are exercised
        for node in (jp["layer2"][block]["bn1"], jp["layer3"][block]["bn2"]):
            c = node["scale"].shape[0]
            node["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
            node["var"] = (rng.rand(c) + 0.5).astype(np.float32)
    video = rng.randn(2, 4, 88, 88, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jax_resnet(p, v, train_mode))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(video)))
    ours = resnet3d_forward(params_from_numpy(jp, "cpu"), torch.from_numpy(video), train_mode,
                            conv_kernel=True).numpy()
    assert ours.shape == ref.shape == (2, 4, 512)
    assert np.isfinite(ours).all()
    assert np.linalg.norm(ours - ref) <= 1e-2 * np.linalg.norm(ref)


# B7's plan: which kernel of csrc/conv_block.cu, and which tile, each shape
# takes (132 SMs). The trunk's 13 geometries at 480 frames (22x22x64 after
# the stem): every one on the wgmma kernel, on tiles of whole output rows
# (layer1: 8 of its 22 rows, 176 of 192 tile rows) or whole frames (layer2:
# one 11x11 frame in 128 rows; layer3: five 6x6 frames in 192; layer4: 21
# 3x3 frames in 192), 64 columns at Cout 64.
TRUNK_PLANS = [
    # label, H, Cin, Cout, k, stride, pad, (kernel, bm, bn, tf, th)
    ("layer1 conv1/conv2", 22, 64, 64, 3, 1, 1, ("wgmma", 192, 64, 1, 8)),
    ("layer2 b0 conv1 s2", 22, 64, 128, 3, 2, 1, ("wgmma", 128, 128, 1, 11)),
    ("layer2 downsample", 22, 64, 128, 1, 2, 0, ("wgmma", 128, 128, 1, 11)),
    ("layer2 conv2/b1 conv1", 11, 128, 128, 3, 1, 1, ("wgmma", 128, 128, 1, 11)),
    ("layer3 b0 conv1 s2", 11, 128, 256, 3, 2, 1, ("wgmma", 192, 128, 5, 6)),
    ("layer3 downsample", 11, 128, 256, 1, 2, 0, ("wgmma", 192, 128, 5, 6)),
    ("layer3 conv2/b1 conv1", 6, 256, 256, 3, 1, 1, ("wgmma", 192, 128, 5, 6)),
    ("layer4 b0 conv1 s2", 6, 256, 512, 3, 2, 1, ("wgmma", 192, 128, 21, 3)),
    ("layer4 downsample", 6, 256, 512, 1, 2, 0, ("wgmma", 192, 128, 21, 3)),
    ("layer4 conv2/b1 conv1", 3, 512, 512, 3, 1, 1, ("wgmma", 192, 128, 21, 3)),
]


def _takes(plan, F, Ho, Wo, Cin, Cout, stride):
    """What the C launcher accepts for the plan (conv_block_launch)."""
    if plan.kernel == "mma":
        return Cin % 8 == 0 and Cout % 8 == 0
    return (Cin % 64 == 0 and Cout % plan.bn == 0 and plan.bm in (128, 192)
            and plan.bn in (64, 128) and plan.tf >= 1 and plan.th >= 1
            and plan.tf * plan.th * Wo <= plan.bm and (plan.tf == 1 or plan.th == Ho)
            and stride * Wo <= 256 and stride * plan.th <= 256 and plan.tf <= min(F, 256))


@pytest.mark.parametrize("case", TRUNK_PLANS, ids=[c[0] for c in TRUNK_PLANS])
def test_conv_plan_trunk(case):
    from omni_avsr_tpu_torch.ops.conv_block import conv_plan

    _, H, Cin, Cout, k, stride, pad, want = case
    Ho = (H + 2 * pad - k) // stride + 1
    plan = conv_plan(480, Ho, Ho, Cin, Cout, stride, sms=132)
    assert tuple(plan) == want
    assert _takes(plan, 480, Ho, Ho, Cin, Cout, stride)


# The card tests' shapes (tests/test_torch_cuda.py): Cin 16 / 24 or Cout 40
# take the mma.sync kernel; a ragged M (37 frames) and the f32-x cases with
# Cin 64 the wgmma kernel (x is rounded to bf16 before either kernel); an
# output row wider than 192 pixels the mma.sync kernel.
@pytest.mark.parametrize("F,H,W,Cin,Cout,k,stride,pad,kernel", [
    (5, 7, 7, 24, 40, 3, 2, 1, "mma"),        # f32 x, Cin 24, Cout 40
    (3, 6, 6, 16, 32, 1, 1, 0, "mma"),        # f32 x and residual, Cin 16
    (37, 11, 11, 128, 128, 3, 1, 1, "wgmma"),  # raw train conv, ragged M
    (7, 5, 5, 64, 128, 3, 1, 1, "wgmma"),     # f32 x and residual, Cin 64
    (2, 5, 5, 64, 40, 3, 1, 1, "mma"),        # Cout not a multiple of 64
    (2, 4, 200, 64, 64, 3, 1, 1, "mma"),      # Wo 200 > 192
])
def test_conv_plan_card_shapes(F, H, W, Cin, Cout, k, stride, pad, kernel):
    from omni_avsr_tpu_torch.ops.conv_block import conv_plan

    Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    plan = conv_plan(F, Ho, Wo, Cin, Cout, stride, sms=132)
    assert plan.kernel == kernel
    assert _takes(plan, F, Ho, Wo, Cin, Cout, stride)
