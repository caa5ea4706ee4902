"""Fused inference BasicBlock: CUDA kernel wrapper and its plain version.

Replaces ``human_pose_tpu/ops/pallas_conv.py::fused_basic_block``
(``_kernel``). A BasicBlock at inference is conv3x3 -> BN -> ReLU -> conv3x3
-> BN -> + x -> ReLU; with BN folded into the convolutions
(``fold_conv_bn``) it is

    out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)

on NHWC ``x`` with HWIO weights, stride 1, the same channels in and out,
float32 accumulation, the intermediate activation cast to ``x.dtype`` before
the second convolution and the residual added in float32. As in JAX, the
model does not route its blocks through it.

``fused_basic_block`` launches ``csrc/fused_basic_block.cu`` on CUDA tensors
and runs ``fused_basic_block_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.norm import BN_EPS

MAX_C = 256  # channels: one output channel per thread of a 256-thread block


def fold_conv_bn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float = BN_EPS):
    """Fold eval-mode BatchNorm into a conv: HWIO ``kernel`` and the BN's
    scale, bias, running mean and variance -> ``(kernel', bias')``."""
    inv = scale / torch.sqrt(var + eps)
    return kernel * inv[None, None, None, :], bias - mean * inv


def fold_basic_block(block) -> tuple:
    """``(w1, b1, w2, b2)`` of a port ``BasicBlock`` (no downsample) with
    both BNs folded, HWIO weights."""
    if block.downsample is not None:
        raise ValueError("a BasicBlock with a downsample branch is not a fused block")
    out = []
    for conv, bn in ((block.conv1, block.bn1), (block.conv2, block.bn2)):
        out += fold_conv_bn(conv.weight.detach().permute(2, 3, 1, 0), bn.weight.detach(),
                            bn.bias.detach(), bn.running_mean, bn.running_var, bn.eps)
    return tuple(out)


def _conv3x3(x_nchw: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x_nchw, w_hwio.to(torch.float32).permute(3, 2, 0, 1), b.to(torch.float32),
                    padding=1)


def reference_basic_block(x, w1, b1, w2, b2):
    """The JAX package's reference: both convolutions in float32, no cast of
    the intermediate; the result in ``x.dtype``."""
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    y = torch.relu(_conv3x3(xf, w1, b1))
    z = _conv3x3(y, w2, b2)
    return torch.relu(z + xf).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def fused_basic_block_plain(x, w1, b1, w2, b2):
    """Plain version of the kernel; same arguments as ``fused_basic_block``."""
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    y = torch.relu(_conv3x3(xf, w1, b1)).to(x.dtype).to(torch.float32)
    z = _conv3x3(y, w2, b2)
    return torch.relu(z + xf).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def fused_basic_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """``x [B, H, W, C]`` float32 or bfloat16 (NHWC), ``w1, w2 [3, 3, C, C]``
    HWIO with BN folded, ``b1, b2 [C]`` -> ``[B, H, W, C]`` in ``x.dtype``.

    CUDA tensors launch the kernel (counted in ``fused_basic_block.launches``;
    the weights are used as float32); CPU tensors run the plain version."""
    b, h, w, c = x.shape
    if (tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c)
            or tuple(b1.shape) != (c,) or tuple(b2.shape) != (c,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}")
    if x.device.type == "cpu":
        return fused_basic_block_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 or bfloat16 tensor")
    if c > MAX_C or c % 4:
        raise ValueError(f"unsupported C={c} (a multiple of 4, at most {MAX_C})")
    params = [t.to(device=x.device, dtype=torch.float32).contiguous() for t in (w1, b1, w2, b2)]
    from ._build import load_kernel

    lib = load_kernel("fused_basic_block")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.launch_fused_basic_block(
        ctypes.c_void_p(x.data_ptr()), *(ctypes.c_void_p(t.data_ptr()) for t in params),
        ctypes.c_void_p(out.data_ptr()), b, h, w, c, int(x.dtype == torch.bfloat16),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"fused_basic_block kernel launch failed: cudaError {err}")
    fused_basic_block.launches += 1
    return out


fused_basic_block.launches = 0
