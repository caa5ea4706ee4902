"""Train state: the model, its optimizer, the step count, and where and in
which dtype the step computes (port of human_pose_tpu/train/state.py).

The JAX package's state is an immutable pytree of parameters, BatchNorm
statistics and optimizer state. Here the ``nn.Module`` holds the
parameters and the statistics and the ``torch.optim.Optimizer`` its state;
a step updates both in place. Under data parallelism the state holds
the process's ``parallel.Mesh``: the steps then average the gradients, the
per-process BatchNorm statistics and the metrics over the processes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..device import resolve_device


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    device: torch.device
    dtype: torch.dtype = torch.float32
    mesh: Any = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda", mesh=None) -> "TrainState":
        """A state at step 0 for ``model``, already on ``device`` (the card
        unless the caller asks for the CPU). ``dtype`` is the compute dtype:
        float32, or bfloat16 under ``torch.autocast`` (float32 parameters,
        optimizer state and losses, as in the JAX package's bf16 policy).
        ``mesh`` (a ``parallel.Mesh``) makes the steps data-parallel."""
        dev = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        for name, p in model.named_parameters():
            if p.device.type != dev.type or (dev.index is not None and p.device != dev):
                raise ValueError(f"parameter {name} is on {p.device}, the state's device is {dev}")
        return cls(model=model, optimizer=optimizer, step=0, device=dev, dtype=dtype, mesh=mesh)
