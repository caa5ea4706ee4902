"""Keypoints train and validation steps (port of human_pose_tpu/train/steps.py).

A step takes the learning rate as an argument (``set_learning_rate``; the
schedulers of ``train/optim.py`` run on the host), moves the batch to the
state's device, normalizes uint8 images there (``prep_images``), runs the
model in train mode, the pose loss, the backward and one optimizer update.
It returns ``(state, metrics)``: the same state, updated in place, and a
dict of 0-dim device tensors (no ``.item()``, so no host sync).

The compute dtype is the state's: float32, or bfloat16 under
``torch.autocast`` with float32 outputs, losses, parameters and optimizer
state, and no ``GradScaler`` (bf16 has float32's exponent range), as the
JAX package's bf16 policy does.

batch: ``images`` ``[N, 3, H, W]`` uint8 or float, ``heatmaps`` a list of
``[N, K, h, w]`` per stage, ``masks`` a list of ``[N, h, w]``, ``joints``
``[N, P, K, 3]`` int32 at 1/4-resolution coordinates, padded with vis 0.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.images import prep_images
from .losses import ae_keypoints_loss
from .optim import set_learning_rate
from .state import TrainState

__all__ = ["accumulated_keypoints_train_step", "keypoints_train_step", "keypoints_val_step"]


def _to_device(batch: dict, device: torch.device) -> dict:
    def move(x):
        return [move(v) for v in x] if isinstance(x, (list, tuple)) else x.to(device, non_blocking=True)
    return {key: move(value) for key, value in batch.items()}


def _compute(state: TrainState):
    if state.dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(state.device.type, dtype=state.dtype)


def _keypoints_losses(out, batch: dict):
    stages_hms, tags = out
    return ae_keypoints_loss(stages_hms, tags, batch["heatmaps"], batch["masks"], batch["joints"])


def _keypoints_backward(state: TrainState, batch: dict) -> dict:
    """Forward in train mode (BatchNorm running statistics move), loss and
    backward for one (micro)batch; the gradients add into ``.grad``.
    Returns the detached metrics."""
    state.model.train()
    with _compute(state):
        out = state.model(prep_images(batch["images"]))
    total, metrics = _keypoints_losses(out, batch)
    total.backward()
    return {key: value.detach() for key, value in metrics.items()}


def _update(state: TrainState, lr) -> None:
    set_learning_rate(state.optimizer, lr)
    state.optimizer.step()
    state.step += 1


def keypoints_train_step(state: TrainState, batch: dict, lr):
    """One update on ``batch``. Returns ``(state, metrics)``: metrics
    ``hm_0``, ``hm_1``, ``push``, ``pull``, ``loss``."""
    batch = _to_device(batch, state.device)
    state.optimizer.zero_grad(set_to_none=True)
    metrics = _keypoints_backward(state, batch)
    _update(state, lr)
    return state, metrics


@torch.no_grad()
def keypoints_val_step(state: TrainState, batch: dict):
    """Eval-mode forward and the pose loss. Returns ``(metrics, out)`` with
    ``out`` the model's ``(heatmaps, tags)``."""
    batch = _to_device(batch, state.device)
    state.model.eval()
    with _compute(state):
        out = state.model(prep_images(batch["images"]))
    _, metrics = _keypoints_losses(out, batch)
    return metrics, out


def _split_micro(batch: dict, n_micro: int) -> list:
    """``batch`` as ``n_micro`` consecutive microbatches along dim 0."""
    def split(x):
        if isinstance(x, (list, tuple)):
            return [list(parts) for parts in zip(*(split(v) for v in x))]
        n = x.shape[0]
        if n % n_micro:
            raise ValueError(f"batch {n} not divisible by {n_micro} microbatches")
        return x.split(n // n_micro)

    parts = {key: split(value) for key, value in batch.items()}
    return [{key: value[i] for key, value in parts.items()} for i in range(n_micro)]


def accumulated_keypoints_train_step(n_micro: int):
    """A keypoints step that averages the gradients of ``n_micro``
    microbatches and makes one update at the end. The BatchNorm running
    statistics move through the microbatches in order (each sees the
    previous one's), the batch statistics are each microbatch's own, and
    the metrics are the microbatches' mean; activation memory is that of one
    microbatch. Equals ``keypoints_train_step`` at ``n_micro`` 1."""

    def step(state: TrainState, batch: dict, lr):
        micro = _split_micro(_to_device(batch, state.device), n_micro)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = [_keypoints_backward(state, mb) for mb in micro]
        with torch.no_grad():
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(n_micro)
        _update(state, lr)
        return state, {key: torch.stack([m[key] for m in metrics]).mean(0) for key in metrics[0]}

    return step
