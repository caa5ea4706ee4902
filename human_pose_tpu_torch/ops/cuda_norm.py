"""BatchNorm's batch-statistics backward for bf16 and fp16 inputs: CUDA
kernel pair wrapper and its plain version.

Replaces no Pallas kernel (the JAX package leaves BatchNorm to flax and
XLA). ``models/norm.py::_NormalizeWithStats`` calls ``batch_norm_backward``
for a bf16 or fp16 x: the gradient of x in x's dtype and the weight's and
the bias's gradients as float32 sums, as JAX's bf16 step keeps them.
``batch_norm_backward`` launches ``csrc/batch_norm_backward.cu`` (a reduce
and an apply, each over a grid of channel x ``splits``; counted in
``batch_norm_backward.launches``, 2 a call) on CUDA tensors and runs
``batch_norm_backward_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

THREADS = 256  # a kernel block's threads (THREADS in the .cu)
BLOCKS_PER_SM = 2048 // THREADS  # resident blocks an SM at full occupancy
WAVES = 2  # the card's SMs filled this many times over
MIN_VECTORS = 4  # vectors a thread at least, so that a block's loads hide latency
MAX_SPLITS = 65535  # gridDim.y


def batch_norm_sums(grad_y: torch.Tensor, x: torch.Tensor, mean: torch.Tensor) -> tuple:
    """The two channel sums the batch-statistics BatchNorm gradient needs,
    in at least float32: ``(dy, xmu, sum_dy, sum_dy_xmu)`` with ``dy`` and
    ``xmu = x - mean`` widened to that dtype (inputs of ``batch_norm_grad_x``)."""
    stats = torch.promote_types(x.dtype, torch.float32)
    dy = grad_y.to(stats)
    xmu = x.to(stats) - mean[:, None, None]
    return dy, xmu, dy.sum((0, 2, 3)), (dy * xmu).sum((0, 2, 3))


def batch_norm_grad_x(dy, xmu, mean_dy, mean_dy_xmu, weight, invstd, dtype) -> torch.Tensor:
    """grad_x from ``batch_norm_sums``' ``dy`` and ``xmu`` and the channel
    means of ``dy`` and ``dy * xmu`` over the batch's elements (one
    process's, or every process's of a group), rounded once to ``dtype``."""
    c = (slice(None), None, None)
    return ((dy - mean_dy[c] - xmu * (invstd * invstd * mean_dy_xmu)[c])
            * (invstd * weight.to(dy.dtype))[c]).to(dtype)


def batch_norm_backward_plain(grad_y: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                              mean: torch.Tensor, invstd: torch.Tensor, need_x: bool = True):
    """The batch-statistics BatchNorm gradient of ``x [N, C, H, W]`` given
    ``grad_y`` and the forward's ``mean`` and ``invstd``, in at least
    float32: ``(grad_x, grad_w, grad_b)``, ``grad_x`` in x's dtype (None
    without ``need_x``), the other two float32 (x's dtype for float64)."""
    dy, xmu, sum_dy, sum_dy_xmu = batch_norm_sums(grad_y, x, mean)
    grad_x = None
    if need_x:
        n = x.numel() // x.shape[1]
        grad_x = batch_norm_grad_x(dy, xmu, sum_dy / n, sum_dy_xmu / n, weight, invstd, x.dtype)
    return grad_x, sum_dy_xmu * invstd, sum_dy


def splits(channels: int, vectors: int, sm_count: int) -> int:
    """Blocks a channel of ``vectors`` loads: enough that the ``channels``
    channels fill ``sm_count`` SMs ``WAVES`` times at full occupancy, no more
    than leave each thread ``MIN_VECTORS`` loads; 1 where the channels alone
    fill the card."""
    want = -(-sm_count * BLOCKS_PER_SM * WAVES // channels)
    most = max(1, vectors // (THREADS * MIN_VECTORS))
    return max(1, min(want, most, MAX_SPLITS))


def vector_width(hw: int, *tensors) -> int:
    """Elements a load: 8 (16 bytes) where a plane's ``hw`` elements are a
    multiple of 8 and every tensor's base is 16-byte aligned, else 1."""
    if hw % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 8
    return 1


def _launch(grad_y, x, weight, mean, invstd, need_x):
    if x.dtype not in (torch.bfloat16, torch.float16) or grad_y.dtype != x.dtype:
        raise ValueError(f"x and grad_y must be both bfloat16 or both float16, not {x.dtype}, "
                         f"{grad_y.dtype}")
    if x.dim() != 4 or grad_y.shape != x.shape or not (x.is_contiguous() and grad_y.is_contiguous()):
        raise ValueError("x and grad_y must be contiguous NCHW tensors of one shape")
    n, c, h, w = x.shape
    hw = h * w
    if n * hw > 0xFFFFFFFF:
        raise ValueError(f"{n * hw} elements a channel (at most 2**32 - 1)")
    stats = [t.to(torch.float32).contiguous() for t in (weight, mean, invstd)]
    if any(t.shape != (c,) or t.device != x.device for t in stats):
        raise ValueError(f"weight, mean and invstd must be [{c}] on {x.device}")
    from ._build import load_kernel

    lib = load_kernel("batch_norm_backward")
    dev = x.device
    grad_x = torch.empty_like(x) if need_x else None
    vec = vector_width(hw, *(t for t in (x, grad_y, grad_x) if t is not None))
    s = splits(c, n * hw // vec, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((c, s, 2), dtype=torch.float32, device=dev)
    grad_w = torch.empty((c,), dtype=torch.float32, device=dev)
    grad_b = torch.empty((c,), dtype=torch.float32, device=dev)
    err = lib.launch_batch_norm_backward(
        x.data_ptr(), grad_y.data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
        stats[0].data_ptr(), partial.data_ptr(), None if grad_x is None else grad_x.data_ptr(),
        grad_w.data_ptr(), grad_b.data_ptr(), n, c, hw, s, ctypes.c_float(1.0 / (n * hw)),
        int(x.dtype == torch.float16), vec, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"batch_norm_backward kernel launch failed: cudaError {err}")
    batch_norm_backward.launches += 2
    return grad_x, grad_w, grad_b


def batch_norm_backward(grad_y: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                        mean: torch.Tensor, invstd: torch.Tensor, need_x: bool = True):
    """``batch_norm_backward_plain``'s ``(grad_x, grad_w, grad_b)`` for a
    contiguous NCHW bf16 or fp16 ``x`` and ``grad_y`` of x's dtype, with
    float32 ``mean``, ``invstd`` (and ``weight``, any float dtype).

    CUDA tensors launch the kernel pair (counted in
    ``batch_norm_backward.launches``, 2 a call) or raise; CPU tensors run
    the plain version."""
    if x.device.type == "cpu":
        return batch_norm_backward_plain(grad_y, x, weight, mean, invstd, need_x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(grad_y, x, weight, mean, invstd, need_x)


batch_norm_backward.launches = 0
