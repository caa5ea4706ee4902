"""Train and validation steps (port of human_pose_tpu/train/steps.py).

A step takes the learning rate as an argument (``set_learning_rate``; the
schedulers of ``train/optim.py`` run on the host), moves the batch to the
state's device, normalizes uint8 images there (``prep_images``), runs the
model in train mode, the task's loss, the backward and one optimizer update.
It returns ``(state, metrics)``: the same state, updated in place, and a
dict of 0-dim device tensors (no ``.item()``, so no host sync).

The compute dtype is the state's: float32, or bfloat16 under
``torch.autocast`` with float32 outputs, losses, parameters and optimizer
state, and no ``GradScaler`` (bf16 has float32's exponent range), as the
JAX package's bf16 policy does.

With a ``parallel.Mesh`` in the state (one process of a data-parallel
group, each on its shard of the global batch), ``_update`` first averages
the parameter gradients and the per-process BatchNorm running statistics
over the processes, and a train step's metrics are averaged before they are
returned: with equal shards, the JAX package's step on the global batch.
Without a mesh nothing of that runs. On a (data, space[, model]) mesh
(``parallel/tensor.py::shard_state_tensor``, a batch of
``parallel/spatial.py::shard_batch_spatial``) the same reductions run over
the moment group, and the keypoints loss takes the tag maps gathered over
the space group (``gather_rows``).

* classification: ``images`` ``[N, 3, H, W]`` uint8 or float and
  ``labels`` ``[N]`` int; cross entropy and the top-1 and top-5 errors.
* keypoints: batch ``images`` as above, ``heatmaps`` a list of
  ``[N, K, h, w]`` per stage, ``masks`` a list of ``[N, h, w]``, ``joints``
  ``[N, P, K, 3]`` int32 at 1/4-resolution coordinates, padded with vis 0.
* top-down (the single-output nets: ``HRNetSPPE``, ``SimpleBaseline``,
  ``HourglassNet``): batch ``images`` of person crops as above,
  ``heatmaps`` ``[N, K, h, w]`` (every stage's target) and
  ``target_weight`` ``[N, K]``; the target-weighted joints MSE.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.grouping import _top_k
from ..ops.images import prep_images
from ..parallel.mesh import all_reduce_mean_, average_gradients_, average_running_stats_
from ..parallel.spatial import gather_rows
from ..utils.profiling import span
from .losses import ae_keypoints_loss, classification_loss, joints_mse_loss
from .optim import set_learning_rate
from .state import TrainState

__all__ = ["accumulated_classification_train_step", "accumulated_keypoints_train_step",
           "accumulated_sppe_train_step", "classification_train_step", "classification_val_step",
           "keypoints_train_step", "keypoints_val_step", "sppe_train_step", "sppe_val_step",
           "topk_error"]


def _to_device(batch: dict, device: torch.device) -> dict:
    def move(x):
        return [move(v) for v in x] if isinstance(x, (list, tuple)) else x.to(device, non_blocking=True)
    return {key: move(value) for key, value in batch.items()}


def _compute(state: TrainState):
    if state.dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(state.device.type, dtype=state.dtype)


def topk_error(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """The share of rows whose label is not among the ``k`` largest logits;
    ties go to the lowest index, as ``jax.lax.top_k`` (a stable sort, not
    ``torch.topk``)."""
    _, idx = _top_k(logits, min(k, logits.shape[-1]))
    correct = (idx == labels[:, None]).any(1)
    return 1.0 - correct.float().mean()


# -- classification -------------------------------------------------------------------

def _classification_metrics(logits: torch.Tensor, labels: torch.Tensor):
    loss = classification_loss(logits, labels)
    with torch.no_grad():
        return loss, {"loss": loss.detach(), "top-1_error": topk_error(logits, labels, 1),
                      "top-5_error": topk_error(logits, labels, 5)}


def _classification_backward(state: TrainState, batch: dict) -> dict:
    """Forward in train mode, cross entropy and backward for one
    (micro)batch ``{"images", "labels"}``; the gradients add into ``.grad``.
    Returns the detached metrics."""
    state.model.train()
    with span("train.forward"), _compute(state):
        logits = state.model(prep_images(batch["images"]))
    with span("train.loss"):
        loss, metrics = _classification_metrics(logits, batch["labels"])
    with span("train.backward"):
        loss.backward()
    return metrics


def classification_train_step(state: TrainState, images, labels, lr):
    """One update on ``(images, labels)``. Returns ``(state, metrics)``:
    metrics ``loss``, ``top-1_error``, ``top-5_error``."""
    batch = _to_device({"images": images, "labels": labels}, state.device)
    state.optimizer.zero_grad(set_to_none=True)
    metrics = _classification_backward(state, batch)
    _update(state, lr)
    return state, _global_metrics(state, metrics)


@torch.no_grad()
def classification_val_step(state: TrainState, images, labels):
    """Eval-mode forward, the loss and the errors. Returns ``(metrics,
    logits)``, logits ``[N, num_classes]`` float32."""
    batch = _to_device({"images": images, "labels": labels}, state.device)
    state.model.eval()
    with _compute(state):
        logits = state.model(prep_images(batch["images"]))
    _, metrics = _classification_metrics(logits, batch["labels"])
    return metrics, logits


def accumulated_classification_train_step(n_micro: int):
    """A classification step averaging the gradients of ``n_micro``
    microbatches (see ``accumulated_keypoints_train_step``)."""

    def step(state: TrainState, images, labels, lr):
        batch = _to_device({"images": images, "labels": labels}, state.device)
        return _accumulated(state, _split_micro(batch, n_micro), _classification_backward, lr)

    return step


# -- keypoints --------------------------------------------------------------------------

def _keypoints_losses(out, batch: dict):
    stages_hms, tags = out
    return ae_keypoints_loss(stages_hms, tags, batch["heatmaps"], batch["masks"], batch["joints"])


def _keypoints_backward(state: TrainState, batch: dict) -> dict:
    """Forward in train mode (BatchNorm running statistics move), loss and
    backward for one (micro)batch; the gradients add into ``.grad``.
    Returns the detached metrics."""
    state.model.train()
    with span("train.forward"), _compute(state):
        out = state.model(prep_images(batch["images"]))
    with span("train.loss"):
        if state.mesh is not None and state.mesh.dims:
            out = (out[0], gather_rows(out[1], state.mesh))
        total, metrics = _keypoints_losses(out, batch)
    with span("train.backward"):
        total.backward()
    return {key: value.detach() for key, value in metrics.items()}


@span("train.update")
def _update(state: TrainState, lr) -> None:
    if state.mesh is not None:
        average_gradients_(state.mesh, state.model)
        average_running_stats_(state.mesh, state.model)
    set_learning_rate(state.optimizer, lr)
    state.optimizer.step()
    state.step += 1


def _global_metrics(state: TrainState, metrics: dict) -> dict:
    """A train step's metrics, averaged over the mesh's processes (the
    global batch's means for equal shards); as they are without a mesh."""
    if state.mesh is None:
        return metrics
    values = torch.stack([v.float() for v in metrics.values()])
    all_reduce_mean_(state.mesh, [values])
    return dict(zip(metrics, values.unbind()))


def keypoints_train_step(state: TrainState, batch: dict, lr):
    """One update on ``batch``. Returns ``(state, metrics)``: metrics
    ``hm_0``, ``hm_1``, ``push``, ``pull``, ``loss``."""
    batch = _to_device(batch, state.device)
    state.optimizer.zero_grad(set_to_none=True)
    metrics = _keypoints_backward(state, batch)
    _update(state, lr)
    return state, _global_metrics(state, metrics)


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


# -- top-down ---------------------------------------------------------------------------

def _sppe_losses(out: list, batch: dict):
    return joints_mse_loss(out, batch["heatmaps"], batch["target_weight"])


def _sppe_backward(state: TrainState, batch: dict) -> dict:
    """Forward in train mode, the joints MSE and backward for one
    (micro)batch of crops; the gradients add into ``.grad``. Returns the
    detached metrics."""
    state.model.train()
    with span("train.forward"), _compute(state):
        out = state.model(prep_images(batch["images"]))
    with span("train.loss"):
        total, metrics = _sppe_losses(out, batch)
    with span("train.backward"):
        total.backward()
    return {key: value.detach() for key, value in metrics.items()}


def sppe_train_step(state: TrainState, batch: dict, lr):
    """One update of a single-output net on a batch of crops. Returns
    ``(state, metrics)``: metrics ``hm_{i}`` a stage and ``loss``."""
    batch = _to_device(batch, state.device)
    state.optimizer.zero_grad(set_to_none=True)
    metrics = _sppe_backward(state, batch)
    _update(state, lr)
    return state, _global_metrics(state, metrics)


@torch.no_grad()
def sppe_val_step(state: TrainState, batch: dict):
    """Eval-mode forward and the joints MSE. Returns ``(metrics, out)`` with
    ``out`` the model's list of heatmap stages."""
    batch = _to_device(batch, state.device)
    state.model.eval()
    with _compute(state):
        out = state.model(prep_images(batch["images"]))
    _, metrics = _sppe_losses(out, batch)
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


def _accumulated(state: TrainState, micro: list, backward, lr):
    """The gradients of ``backward`` over the microbatches ``micro``, in
    order, averaged into one update; the metrics are the microbatches'
    mean."""
    state.optimizer.zero_grad(set_to_none=True)
    metrics = [backward(state, mb) for mb in micro]
    with torch.no_grad():
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.div_(len(micro))
    _update(state, lr)
    return state, _global_metrics(
        state, {key: torch.stack([m[key] for m in metrics]).mean(0) for key in metrics[0]})


def accumulated_keypoints_train_step(n_micro: int):
    """A keypoints step that averages the gradients of ``n_micro``
    microbatches and makes one update at the end. The BatchNorm running
    statistics move through the microbatches in order (each sees the
    previous one's), the batch statistics are each microbatch's own, and
    the metrics are the microbatches' mean; activation memory is that of one
    microbatch. Equals ``keypoints_train_step`` at ``n_micro`` 1."""

    def step(state: TrainState, batch: dict, lr):
        micro = _split_micro(_to_device(batch, state.device), n_micro)
        return _accumulated(state, micro, _keypoints_backward, lr)

    return step


def accumulated_sppe_train_step(n_micro: int):
    """A top-down step averaging the gradients of ``n_micro`` microbatches
    (see ``accumulated_keypoints_train_step``)."""

    def step(state: TrainState, batch: dict, lr):
        micro = _split_micro(_to_device(batch, state.device), n_micro)
        return _accumulated(state, micro, _sppe_backward, lr)

    return step
