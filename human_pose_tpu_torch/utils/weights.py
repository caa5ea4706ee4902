"""flax variable trees -> reference-layout torch state dicts.

The JAX package stores weights as flax trees (``{"params": ..., "batch_stats":
...}``, NHWC/HWIO); the port's modules are named after the reference torch
implementation's state-dict keys, so a converted tree loads with
``load_state_dict(strict=True)``. This module keeps its own copy of the key
grammar and leaf transforms (the JAX package's ``utils/torch_interop.py``
cannot be imported without JAX) and works on nested dicts of numpy arrays.

Layout conventions converted:

* conv weights: flax HWIO -> torch OIHW
* transposed conv (the deconv head): flax ``nn.ConvTranspose`` HWIO ->
  torch (I, O, kH, kW) with the spatial taps flipped, which makes
  ``ConvTranspose2d(k4, s2, p1)`` equal flax's 'SAME' transposed conv
* BatchNorm: scale/bias -> weight/bias; mean/var -> running_mean/running_var
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

__all__ = [
    "strip_torch_prefixes",
    "torch_key_for",
    "variables_to_torch",
    "load_flax_npz",
]

# name prefixes the reference strips when loading (utils/model.py:163-171):
# DDP wrap ("module."), torch.compile ("_orig_mod."), model wrapper ("net.")
_PREFIXES = ("module.", "_orig_mod.", "net.")


def strip_torch_prefixes(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Remove DDP/compile/wrapper prefixes from state_dict keys."""
    out = {}
    for key, value in state_dict.items():
        changed = True
        while changed:
            changed = False
            for p in _PREFIXES:
                if key.startswith(p):
                    key = key[len(p):]
                    changed = True
        out[key] = value
    return out


def _unit_child(base: str, rest: tuple[str, ...]) -> tuple[str, str]:
    """Residual-unit child path (cb1/cb2/cb3/downsample)/(conv|bn) -> torch
    module prefix + kind."""
    child, sub = rest[0], rest[1]
    if child == "downsample":  # torch: downsample = Sequential(conv, bn)
        return f"{base}.downsample.{0 if sub == 'conv' else 1}", sub
    idx = {"cb1": 1, "cb2": 2, "cb3": 3}[child]
    return f"{base}.{'conv' if sub == 'conv' else 'bn'}{idx}", sub


def torch_key_for(path: tuple[str, ...]) -> tuple[str, str]:
    """Translate a flax variable path (module names only, no leaf) into the
    torch module prefix and its kind ("conv" | "deconv" | "bn")."""
    if path[0] == "backbone":
        rest = path[1:]
        if rest[0] in ("stem1", "stem2"):
            n = rest[0][-1]
            return f"backbone.{'conv' if rest[1] == 'conv' else 'bn'}{n}", rest[1]
        if rest[0].startswith("stage"):
            s = int(rest[0][len("stage"):]) - 1  # torch stages are 0-indexed
            inner = rest[1]
            if inner.startswith("block"):
                b = int(inner[len("block"):])
                scale, unit = rest[2].split("_")  # "scale{i}_unit{j}"
                i, j = int(scale[len("scale"):]), int(unit[len("unit"):])
                base = f"backbone.stages.{s}.blocks.{2 * b}.scales_blocks.{i}.{j}"
                return _unit_child(base, rest[3:])
            if inner.startswith("fusion"):
                b = int(inner[len("fusion"):])
                base = f"backbone.stages.{s}.blocks.{2 * b + 1}.scales_fusion_layers"
                name, sub = rest[2], rest[3]
                if name.endswith("_up"):  # out{i}_in{j}_up: Sequential(conv, bn, up)
                    i, j = name[:-3].replace("out", "").split("_in")
                    return f"{base}.{i}.{j}.{0 if sub == 'conv' else 1}", sub
                # out{i}_in{j}_down{k}: Sequential of Sequential(conv, bn[, relu])
                head, k = name.split("_down")
                i, j = head.replace("out", "").split("_in")
                return f"{base}.{i}.{j}.{k}.{0 if sub == 'conv' else 1}", sub
            if inner == "transition":
                name, sub = rest[2], rest[3]
                idx = s + 1 if name == "new_branch" else int(name[len("branch"):])
                base = f"backbone.stages.{s}.transition_layer.transition_blocks.{idx}"
                return f"{base}.{0 if sub == 'conv' else 1}", sub
        raise KeyError(f"unmapped backbone path: {path}")
    if path[0] == "init_heatmaps_head":
        return "init_heatmaps_head", "conv"
    if path[0].startswith("deconv"):
        base = f"deconv_layers.{int(path[0][len('deconv'):])}"
        inner = path[1]
        if inner == "deconv":
            return f"{base}.deconv.0", "deconv"
        if inner == "deconv_bn":
            return f"{base}.deconv.1", "bn"
        if inner.startswith("resid"):
            return _unit_child(f"{base}.resid_blocks.{int(inner[len('resid'):])}", path[2:])
        if inner == "final_conv":
            return f"{base}.final_layer", "conv"
    # the classification and SPPE heads join this grammar with their models
    raise KeyError(f"unmapped flax path: {path}")


def _to_torch_leaf(kind: str, leaf: str, value) -> np.ndarray:
    value = np.asarray(value)
    if leaf == "kernel":
        if kind == "conv":
            return value.transpose(3, 2, 0, 1)
        if kind == "deconv":
            return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return value


_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: dict, visit: Callable, path: tuple = ()) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            _walk(value, visit, path + (name,))
        else:
            visit(path, name, value)


def variables_to_torch(variables: dict) -> dict[str, np.ndarray]:
    """Export a flax-layout ``{"params", "batch_stats"}`` tree of arrays as a
    reference-layout torch state dict of numpy arrays (no
    ``num_batches_tracked``; ``BatchNorm2d`` fills it in on load)."""
    out: dict[str, np.ndarray] = {}

    def visitor(leaf_map):
        def visit(path, leaf, value):
            prefix, kind = torch_key_for(path)
            out[f"{prefix}.{leaf_map[leaf]}"] = _to_torch_leaf(kind, leaf, value)
        return visit

    _walk(variables["params"], visitor(_PARAM_LEAF))
    if "batch_stats" in variables:
        _walk(variables["batch_stats"], visitor(_STATS_LEAF))
    return out


def load_flax_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Read a flat ``params/...``/``batch_stats/...`` npz (the layout of
    ``tests/data/ap_fixture_weights.npz``, written by the JAX package's
    trainers) and return a float32 reference-layout torch state dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key].astype(np.float32)
    return {
        k: np.ascontiguousarray(v) for k, v in variables_to_torch(tree).items()
    }
