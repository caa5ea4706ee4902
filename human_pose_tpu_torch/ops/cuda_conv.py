"""Fused inference BasicBlock: CUDA kernel wrapper and its plain version.

Replaces ``human_pose_tpu/ops/pallas_conv.py::fused_basic_block``
(``_kernel``). A BasicBlock at inference is conv3x3 -> BN -> ReLU -> conv3x3
-> BN -> + x -> ReLU; with BN folded into the convolutions
(``fold_conv_bn``) it is

    out = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2 + x)

on NHWC ``x`` with HWIO weights, stride 1, the same channels in and out,
float32 accumulation, the intermediate activation cast to ``x.dtype`` before
the second convolution and the residual added in float32. For bfloat16 ``x``
both convolutions take bfloat16 operands: the weights are rounded to
bfloat16 (what the Pallas kernel multiplies when its weights are bf16, and
what autocast feeds a bf16 model's convolutions); the biases stay float32.
As in JAX, the model does not route its blocks through it.

``fused_basic_block`` launches ``csrc/fused_basic_block.cu`` on CUDA tensors
and runs ``fused_basic_block_plain`` on CPU tensors. Both instances are
implicit GEMMs on the H100's tensor cores (``wgmma``), which bound them by
operations. bfloat16 multiplies bf16 operands. float32 runs as 3xTF32: the
tensor cores take float32 only as TF32 (10 mantissa bits), and one TF32
product a term misses the block's 1e-4 bound, so each operand is split into
a TF32 high part and the rest (``tf32_split``) and three TF32 products
(lo x hi, hi x lo, hi x hi) keep all but about 2**-21 of each term. Three
products at the 495 TFLOP/s TF32 peak are a floor of 0.088 ms at every
HRNet-W32 branch shape (batch 24), under the 0.216 ms of the float32 CUDA
cores. The kernel takes its weights pre-packed for ``x.dtype``
(``pack_block_weights``: bf16, or the TF32 high and low parts side by side);
``fused_basic_block_packed`` launches it on weights packed once.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.norm import BN_EPS

PADDED_C = (16, 32, 64, 128, 256)  # channel counts the kernel is built for (both dtypes)
MAX_C = PADDED_C[-1]  # channels: the widest instance, the widest wgmma (N = 256)


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
    if x.dtype == torch.bfloat16:  # bf16 operands, as the kernel multiplies them
        w1, w2 = (w.to(torch.bfloat16).to(torch.float32) for w in (w1, w2))
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    y = torch.relu(_conv3x3(xf, w1, b1)).to(x.dtype).to(torch.float32)
    z = _conv3x3(y, w2, b2)
    return torch.relu(z + xf).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def padded_channels(c: int) -> int:
    """The channel count ``CP`` the kernel computes ``c`` channels in (the
    extra input and output channels have zero weights)."""
    for cp in PADDED_C:
        if c <= cp:
            return cp
    raise ValueError(f"unsupported C={c} (at most {PADDED_C[-1]})")


def chunk_channels(cp: int) -> int:
    """Input channels of one weight chunk the bfloat16 kernel streams (one
    tap); the kernel's ``Cfg<CP>::KCH`` in ``csrc/fused_basic_block.cu``."""
    return min(cp, 64)


def tf32_split(w: torch.Tensor):
    """``(hi, lo)`` of float32 ``w``: ``hi`` rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``) and ``lo =
    w - hi``, which is exact, so ``hi + lo == w``."""
    bits = w.to(torch.float32).contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def pack_block_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16):
    """The kernel's operands for ``x`` of ``dtype`` from HWIO ``w1, w2 [3, 3,
    C, C]`` and ``b1, b2 [C]``: ``(wpack, bias)``.

    ``wpack`` is a flat tensor of both convolutions' weights padded to ``CP``
    channels, in the order the kernel streams them: conv, tap (dy, dx), then
    input channels in the layout of ``wgmma``'s K-major B operand without
    swizzle, core matrices of 8 output channels x 16 bytes of input channels
    (128 contiguous bytes).

    - bfloat16: the weights rounded to bf16, in chunks of ``KCH`` input
      channels (``chunk_channels``); within a chunk, core matrices of 8
      input channels ordered (k16 step, output-channel group of 8,
      input-channel half).
    - float32: for each k8 step (8 input channels) the TF32 high parts
      (``tf32_split``), then the low parts, each as core matrices of 4 input
      channels ordered (output-channel group of 8, input-channel half). Any
      run of whole k8 steps is a contiguous slice, so the layout does not
      depend on the kernel's chunk size.

    ``bias`` is ``[2, CP]`` float32, zero past C."""
    c = w1.shape[2]
    cp = padded_channels(c)
    w = torch.zeros((2, 9, cp, cp), dtype=torch.float32, device=w1.device)
    w[:, :, :c, :c] = torch.stack([w1, w2]).to(torch.float32).reshape(2, 9, c, c)
    if dtype == torch.bfloat16:
        kch = chunk_channels(cp)
        # [conv, tap, ci, co] with ci = (kc, ks, kh, k8) and co = (ng, n8)
        w = w.reshape(2, 9, cp // kch, kch // 16, 2, 8, cp // 8, 8)
        wpack = w.permute(0, 1, 2, 3, 6, 4, 7, 5).to(torch.bfloat16).contiguous().reshape(-1)
    elif dtype == torch.float32:
        # [conv, tap, part, ci, co] with ci = (ks, kh, k4) and co = (ng, n8)
        w = torch.stack(tf32_split(w), dim=2).reshape(2, 9, 2, cp // 8, 2, 4, cp // 8, 8)
        wpack = w.permute(0, 1, 3, 2, 6, 4, 7, 5).contiguous().reshape(-1)
    else:
        raise ValueError(f"unsupported dtype {dtype}")
    bias = torch.zeros((2, cp), dtype=torch.float32, device=w1.device)
    bias[0, :c] = b1.to(torch.float32)
    bias[1, :c] = b2.to(torch.float32)
    return wpack, bias


def _check_shapes(x, w1, b1, w2, b2):
    c = x.shape[-1]
    if (x.dim() != 4 or tuple(w1.shape) != (3, 3, c, c) or tuple(w2.shape) != (3, 3, c, c)
            or tuple(b1.shape) != (c,) or tuple(b2.shape) != (c,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}")


def _check_x(x: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B, H, W, C] tensor of float32 or bfloat16")
    c = x.shape[-1]
    if c > MAX_C or c % 4:
        raise ValueError(f"unsupported C={c} (a multiple of 4, at most {MAX_C})")


def fused_basic_block_packed(x: torch.Tensor, wpack: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel on weights packed by ``pack_block_weights(..., x.dtype)``:
    ``x [B, H, W, C]`` float32 or bfloat16 CUDA -> ``[B, H, W, C]`` in
    ``x.dtype``. Counted in ``fused_basic_block.launches``."""
    _check_x(x)
    b, h, w, c = x.shape
    cp = padded_channels(c)
    parts = 2 if x.dtype == torch.float32 else 1  # float32: TF32 high and low parts
    if (wpack.dtype != x.dtype or wpack.numel() != 2 * 9 * cp * cp * parts or bias.dtype != torch.float32
            or tuple(bias.shape) != (2, cp) or wpack.device != x.device or bias.device != x.device
            or not (wpack.is_contiguous() and bias.is_contiguous())):
        raise ValueError(f"packed weights do not fit C={c} {x.dtype} on {x.device}: pack them with "
                         "pack_block_weights(..., x.dtype)")
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from ._build import load_kernel

    lib = load_kernel("fused_basic_block")
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (wpack, bias, out)]
    if x.dtype == torch.bfloat16:
        # TMA needs the pixel stride in 16-byte units: pad the channels to a multiple of 8
        xk = x if c % 8 == 0 else F.pad(x, (0, 8 - c % 8))
        err = lib.launch_fused_basic_block_bf16(ctypes.c_void_p(xk.data_ptr()), *ptrs, b, h, w, c,
                                                xk.shape[-1], cp, stream)
    else:
        err = lib.launch_fused_basic_block(ctypes.c_void_p(x.data_ptr()), *ptrs, b, h, w, c, cp, stream)
    if err != 0:
        raise RuntimeError(f"fused_basic_block ({x.dtype}) kernel launch failed: cudaError {err}")
    fused_basic_block.launches += 1
    return out


def fused_basic_block(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """``x [B, H, W, C]`` float32 or bfloat16 (NHWC), ``w1, w2 [3, 3, C, C]``
    HWIO with BN folded, ``b1, b2 [C]`` -> ``[B, H, W, C]`` in ``x.dtype``.

    CUDA tensors pack the weights for ``x.dtype`` and launch the kernel
    (counted in ``fused_basic_block.launches``); CPU tensors run the plain
    version."""
    _check_shapes(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_basic_block_plain(x, w1, b1, w2, b2)
    _check_x(x)
    params = [t.to(device=x.device) for t in (w1, b1, w2, b2)]
    return fused_basic_block_packed(x, *pack_block_weights(*params, dtype=x.dtype))


fused_basic_block.launches = 0

TILE_FIELDS = ("th", "tw", "kch", "stages", "conv1_passes", "dual", "smem_bytes", "threads", "blocks_per_sm")


def kernel_tile(c: int, dtype: torch.dtype) -> dict:
    """The compiled tile of the instance that runs ``c`` channels of
    ``dtype``, from the library (``TILE_FIELDS``: output tile rows and
    columns, input channels a weight chunk, ring stages, conv1's passes,
    whether the small products have their own accumulator, shared bytes and
    threads a block, and the blocks an SM holds by the occupancy
    calculator). Needs the card."""
    from ._build import load_kernel

    info = (ctypes.c_int * len(TILE_FIELDS))()
    err = load_kernel("fused_basic_block").fused_basic_block_tile(
        padded_channels(c), int(dtype == torch.float32), info)
    if err != 0:
        raise RuntimeError(f"fused_basic_block_tile failed: cudaError {err}")
    return dict(zip(TILE_FIELDS, info))
