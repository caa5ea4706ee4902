"""Model export (port of human_pose_tpu/utils/export.py; counterpart of the
reference's ONNX export, src/base/model.py:66-75): the eval forward as a
``torch.export`` program (``.pt2``, the port's counterpart of the JAX
package's StableHLO artifact), plus the flat-weights npz in the JAX
package's layout for interop."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..loggers.pylogger import log
from .weights import variables_from_state_dict


class _AutocastForward(nn.Module):
    """``model``'s forward under ``torch.autocast`` to ``dtype``, as the
    inference models run a bfloat16 forward."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, x):
        with torch.autocast(x.device.type, dtype=self.dtype):
            return self.model(x)


def export_program(model: nn.Module, input_shape: tuple, path: str | Path,
                   dtype: torch.dtype = torch.float32) -> None:
    """``torch.export`` the eval-mode ``model``'s forward for input
    ``[1, *input_shape]`` (``input_shape`` = (3, H, W), NCHW, float32 on the
    model's device) and save it to ``path`` (``torch.export.save``; read it
    back with ``torch.export.load(path).module()``). ``dtype`` bfloat16
    traces the forward under ``torch.autocast``; a dtype torch cannot export
    raises, it is never replaced by another."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    was_training = model.training
    model.eval()
    try:
        device = next(model.parameters()).device
        x = torch.zeros((1, *input_shape), dtype=torch.float32, device=device)
        fwd = model if dtype == torch.float32 else _AutocastForward(model, dtype)
        with torch.no_grad():
            program = torch.export.export(fwd, (x,))
    finally:
        model.train(was_training)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    log.info(f"exported the {dtype} forward ({path.stat().st_size} bytes) to {path}")


def export_weights_npz(model_or_state_dict, path: str | Path) -> None:
    """Flat {path: array} npz of params + batch_stats in flax's names and
    shapes: the file the JAX package's ``export_weights_npz`` writes for the
    same weights, which ``utils.weights.load_flax_npz`` and the JAX
    package's trainers read."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    variables = variables_from_state_dict(sd)
    flat = {}
    for col in ("params", "batch_stats"):
        stack = [((), variables.get(col, {}))]
        while stack:
            keys, node = stack.pop()
            for name, value in node.items():
                if isinstance(value, dict):
                    stack.append((keys + (name,), value))
                else:
                    flat[f"{col}/" + "/".join(keys + (name,))] = np.asarray(value)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    log.info(f"exported {len(flat)} weight tensors to {path}")
