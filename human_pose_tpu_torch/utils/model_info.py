"""Model cost introspection (port of human_pose_tpu/utils/model_info.py;
counterpart of the reference's thop/torchinfo usage,
src/keypoints/architectures/hrnet.py:403-411 and the hook-based layer
summary in src/utils/model.py:22-160): parameter counts per module group and
FLOPs / memory-traffic counts of one forward for a given input shape."""

from __future__ import annotations

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: nn.Module) -> int:
    """The number of parameters (BatchNorm's running statistics are buffers,
    not counted: the JAX package counts ``params`` without ``batch_stats``)."""
    return sum(p.numel() for p in model.parameters())


def param_table(model: nn.Module, depth: int = 2) -> str:
    """Parameter counts grouped by the first ``depth`` names of each
    parameter's module path, and the total."""
    groups: dict[str, int] = {}
    total = 0
    for name, p in model.named_parameters():
        g = ".".join(name.split(".")[:-1][:depth]) or name
        groups[g] = groups.get(g, 0) + p.numel()
        total += p.numel()
    lines = [f"{g:<50} {n:>14,}" for g, n in sorted(groups.items())]
    lines.append("-" * 66)
    lines.append(f"{'TOTAL':<50} {total:>14,}")
    return "\n".join(lines)


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def model_cost(model: nn.Module, input_shape: tuple, batch: int = 1, train: bool = False) -> dict:
    """Counts of one forward of zeros ``[batch, *input_shape]`` (NCHW) on
    the model's device: 'params'; 'flops', ``FlopCounterMode``'s count (2
    per multiply-add of the convolutions, transposed convolutions and
    matmuls; resizes, BatchNorm and the elementwise ops are not counted);
    'bytes_accessed', the sum over the dispatched ops of their tensor inputs'
    and outputs' bytes. Both count the ops one by one, unfused. The JAX
    package's figures are XLA's cost estimate of its compiled, fused
    program, so the two agree on neither: on the C=8 nets of
    tests/test_torch_port_export.py (batch 2, 64^2) XLA's flops read 0.96
    (HigherHRNet) and 0.92 (ClassificationHRNet) of this count, its bytes
    0.66 and 1.07 of these. ``train`` runs BatchNorm on the batch's
    statistics (the model's mode and state restored after). Counts are per
    batch."""
    device = next(model.parameters()).device
    x = torch.zeros((batch, *input_shape), dtype=torch.float32, device=device)
    was_training = model.training
    state = {k: v.clone() for k, v in model.state_dict().items()} if train else None
    model.train(train)
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as flops, _BytesMode() as nbytes:
            model(x)
    finally:
        model.train(was_training)
        if state is not None:
            model.load_state_dict(state)
    return {
        "params": count_params(model),
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(nbytes.bytes),
    }
