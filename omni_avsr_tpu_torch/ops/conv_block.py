"""Conv + folded BN + residual + PReLU for the ResNet trunk (port of
`omni_avsr_tpu/ops/conv_block.py`: `bn_fold`, `_reference_conv`, and the
fused conv kernel B7 behind `fused_conv`).

Two routes, chosen by the caller as the JAX package's `OMNI_CONV_KERNEL`
chooses them (here an argument, `use_kernel`, off by default):
  - `reference_conv`: the conv in the input dtype, the epilogue in f32;
  - `conv2d_fused` (B7): operands rounded to bf16, an f32 accumulator and
    the epilogue in f32 before one store in x's dtype, with no rounding of
    the conv result in between. A CPU tensor takes the plain version
    `conv2d_fused_plain`; a CUDA tensor launches the hand-written kernel
    in `csrc/conv_block.cu` or raises. `FusedConv` is its autograd
    function: the backward recomputes through `reference_conv`, as the
    JAX `custom_vjp` does (the TPU kernel has no backward either).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import check, load


def bn_fold(p: Dict[str, torch.Tensor], eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen BN running stats -> per-channel (scale, bias) affine in f32."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    bias = p["bias"].float() - p["mean"].float() * scale
    return scale, bias


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout) in the JAX "HWIO" layout."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _epilogue(y: torch.Tensor, scale, bias, prelu_a, residual) -> torch.Tensor:
    """f32 y -> affine -> + residual -> PReLU (the BasicBlock order,
    `resnet.py:35-60`)."""
    if scale is not None:
        y = y * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.float()
    if prelu_a is not None:
        a = prelu_a.float()
        y = torch.clamp(y, min=0.0) + a * torch.clamp(y, max=0.0)
    return y


def reference_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    prelu_a: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """conv -> BN affine -> + residual -> PReLU, epilogue in f32, result in
    x's dtype."""
    y = conv2d_nhwc(x, w, stride, pad).float()
    return _epilogue(y, scale, bias, prelu_a, residual).to(x.dtype)


def conv2d_fused_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    prelu_a: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B7's function (`conv2d_fused_pallas`): x and w rounded to bf16, then
    the conv in f32 and the f32 epilogue, one rounding to x's dtype at the
    end. The conv is an im2col product in f32 (a bf16 x bf16 product is
    exact in f32), which no cuDNN TF32 setting changes."""
    Fr, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    Ho, Wo = (H + 2 * pad - kh) // stride + 1, (W + 2 * pad - kw) // stride + 1
    xr = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    cols = F.unfold(xr, (kh, kw), padding=pad, stride=stride)  # (F, Cin*kh*kw, Ho*Wo)
    wr = w.to(torch.bfloat16).float().permute(3, 2, 0, 1).reshape(Cout, Cin * kh * kw)
    y = torch.matmul(wr, cols).reshape(Fr, Cout, Ho, Wo).permute(0, 2, 3, 1)
    return _epilogue(y, scale, bias, prelu_a, residual).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_AFFINE, _ACT, _RESIDUAL, _RESIDUAL_F32, _OUT_F32 = 1, 2, 4, 8, 16


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point, built and typed once per process."""
    fn = load("conv_block").conv_block_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w, stride, pad, scale, bias, prelu_a, residual) -> torch.Tensor:
    Fr, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype}: the kernel stores bf16 or f32")
    if Cin % 8 or Cout % 8:
        raise ValueError(f"Cin {Cin}, Cout {Cout}: the kernel takes multiples of 8")
    if tuple(w.shape) != (kh, kw, Cin, Cout):
        raise ValueError(f"w shape {tuple(w.shape)} for x with {Cin} channels")
    Ho, Wo = (H + 2 * pad - kh) // stride + 1, (W + 2 * pad - kw) // stride + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"conv of {H}x{W} with {kh}x{kw}, pad {pad}: empty output")
    xb = x.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).reshape(kh * kw * Cin, Cout).contiguous()
    check("x", xb, (Fr, H, W, Cin), torch.bfloat16)
    check("w", wb, (kh * kw * Cin, Cout), torch.bfloat16)
    flags, ptrs, keep = 0, [], []
    for flag, vec in ((_AFFINE, scale), (_AFFINE, bias), (_ACT, prelu_a)):
        if vec is None:
            ptrs.append(None)
            continue
        v = vec.float().contiguous()
        check("epilogue vector", v, (Cout,), torch.float32)
        flags |= flag
        ptrs.append(v.data_ptr())
        keep.append(v)
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias come together")
    res_ptr = None
    if residual is not None:
        if residual.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"residual dtype {residual.dtype}: bf16 or f32")
        res = residual.contiguous()
        check("residual", res, (Fr, Ho, Wo, Cout), residual.dtype)
        flags |= _RESIDUAL | (_RESIDUAL_F32 if res.dtype == torch.float32 else 0)
        res_ptr = res.data_ptr()
        keep.append(res)
    if len({t.device for t in (xb, wb, *keep)}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((Fr, Ho, Wo, Cout), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        flags |= _OUT_F32
    with torch.cuda.device(x.device):
        rc = _launcher()(xb.data_ptr(), wb.data_ptr(), *ptrs, res_ptr, out.data_ptr(),
                         Fr, H, W, Cin, Cout, kh, kw, stride, pad, flags,
                         torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_block kernel launch failed: CUDA error {rc}")
    return out


def conv2d_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    prelu_a: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused conv B7, (F, H, W, Cin) NHWC x (kh, kw, Cin, Cout) HWIO ->
    (F, Ho, Wo, Cout) in x's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel and count the launch in
    `conv2d_fused.launches`."""
    if x.device.type == "cpu":
        return conv2d_fused_plain(x, w, stride, pad, scale, bias, prelu_a, residual)
    out = _launch(x, w, stride, pad, scale, bias, prelu_a, residual)
    conv2d_fused.launches += 1
    return out


conv2d_fused.launches = 0


class FusedConv(torch.autograd.Function):
    """B7 forward; the backward recomputes through `reference_conv` and
    differentiates that (`omni_avsr_tpu/ops/conv_block.py:246-270`)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, prelu_a, residual, stride: int, pad: int):
        ctx.save_for_backward(x, w, scale, bias, prelu_a, residual)
        ctx.stride, ctx.pad = stride, pad
        return conv2d_fused(x, w, stride, pad, scale, bias, prelu_a, residual)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if t is not None and need]
        with torch.enable_grad():
            y = reference_conv(inputs[0], inputs[1], ctx.stride, ctx.pad, *inputs[2:])
            grads = iter(torch.autograd.grad(y, wanted, g, allow_unused=True))
        out = [next(grads) if t is not None and need else None
               for t, need in zip(inputs, ctx.needs_input_grad)]
        return (*out, None, None)


def fused_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int = 1,
    pad: int = 1,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    prelu_a: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """conv2d + optional BN affine + optional residual + optional PReLU:
    `reference_conv` when `use_kernel` is off, else B7 through `FusedConv`."""
    if not use_kernel:
        return reference_conv(x, w, stride, pad, scale, bias, prelu_a, residual)
    return FusedConv.apply(x, w, scale, bias, prelu_a, residual, stride, pad)
