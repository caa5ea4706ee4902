"""flax variable trees <-> reference-layout torch state dicts.

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
* dense (the classifier): flax ``[in, out]`` -> torch ``[out, in]``
* BatchNorm: scale/bias -> weight/bias; mean/var -> running_mean/running_var

The model zoo's keys: ``ResNet`` (alone, or as ``SimpleBaseline``'s
``backbone``) carries torchvision's names; ``SimpleBaseline``'s
``deconv{i}`` / ``deconv_bn{i}`` / ``final``, ``HRNetSPPE``'s
``final_conv`` and the hourglasses' ``trunk.*`` are the flax names joined
with dots. ``resnet_variables_from_torchvision`` and
``load_torchvision_backbone`` take a torchvision state dict.

``variables_from_torch`` goes the other way, so that weights the port holds
load back into the JAX package; ``variables_from_state_dict`` does so
without a JAX template (``flax_path_for``, the inverse of
``torch_key_for``), for the flat-weights npz of ``utils/export.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

__all__ = [
    "flax_path_for",
    "load_torchvision_backbone",
    "resnet_variables_from_torchvision",
    "strip_torch_prefixes",
    "torch_key_for",
    "variables_from_state_dict",
    "variables_from_torch",
    "variables_to_torch",
    "load_flax_npz",
    "read_state_dict",
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


# the torch module names of a ResNet's own layers (torchvision's)
_RESNET_TOP = ("conv1", "bn1", "fc")
# the last name of an hourglass path: a ConvBnAct's conv or bn, or a head's
# biased 1x1 conv
_HOURGLASS_LEAF = ("conv", "bn", "heatmaps", "remap_feats", "remap_heatmaps", "tags")


def _is_resnet(name: str) -> bool:
    return name in _RESNET_TOP or name.startswith("layer")


def _resnet_key(path: tuple[str, ...]) -> tuple[str, str]:
    """A ``models.resnet.ResNet`` flax path as its torchvision prefix and
    kind: ``conv1``, ``bn1``, ``fc``, ``layer{L}/b{i}/cb{j}/(conv|bn)`` ->
    ``layer{L}.{i}.(conv|bn){j}``, ``layer{L}/b{i}/down/(conv|bn)`` ->
    ``layer{L}.{i}.downsample.(0|1)``."""
    if len(path) == 1 and path[0] in _RESNET_TOP:
        return path[0], {"conv1": "conv", "bn1": "bn", "fc": "dense"}[path[0]]
    if len(path) != 4 or not path[1].startswith("b") or path[3] not in ("conv", "bn"):
        raise KeyError(f"unmapped ResNet path: {path}")
    layer, unit, child, sub = path
    base = f"{layer}.{int(unit[1:])}"
    if child == "down":
        return f"{base}.downsample.{0 if sub == 'conv' else 1}", sub
    return f"{base}.{sub}{int(child[len('cb'):])}", sub


def torch_key_for(path: tuple[str, ...]) -> tuple[str, str]:
    """Translate a flax variable path (module names only, no leaf) into the
    torch module prefix and its kind ("conv" | "deconv" | "dense" | "bn")."""
    if _is_resnet(path[0]):
        return _resnet_key(path)
    if path[0] == "trunk" and path[-1] in _HOURGLASS_LEAF:
        return ".".join(path), "bn" if path[-1] == "bn" else "conv"
    if len(path) == 1:  # SimpleBaseline's head, HRNetSPPE's final_conv
        name = path[0]
        if name in ("init_heatmaps_head", "final", "final_conv"):
            return name, "conv"
        if name.startswith("deconv_bn"):
            return f"deconv_bn{int(name[len('deconv_bn'):])}", "bn"
        if name.startswith("deconv"):
            return f"deconv{int(name[len('deconv'):])}", "deconv"
        raise KeyError(f"unmapped flax path: {path}")
    if path[0] == "backbone":
        rest = path[1:]
        if _is_resnet(rest[0]):  # SimpleBaseline's
            prefix, kind = _resnet_key(rest)
            return f"backbone.{prefix}", kind
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
    if path[0] == "head":  # ClassificationHead
        base = "classification_head"
        inner = path[1]
        if inner.startswith("incr"):
            return _unit_child(f"{base}.chann_incr_blocks.{int(inner[len('incr'):])}", path[2:])
        if inner.startswith("down"):  # down{i}_conv / down{i}_bn: Sequential(conv, bn, relu)
            i, sub = inner[len("down"):].split("_")
            return f"{base}.downsample_blocks.{int(i)}.{0 if sub == 'conv' else 1}", sub
        if inner == "final_conv":
            return f"{base}.final_conv.0", "conv"
        if inner == "final_bn":
            return f"{base}.final_conv.1", "bn"
        if inner == "classifier":
            return f"{base}.classifier", "dense"
    raise KeyError(f"unmapped flax path: {path}")


def _unit_path(parts: list[str]) -> tuple[str, ...]:
    """Inverse of ``_unit_child``: a residual unit's torch child
    (``conv{n}``/``bn{n}``/``downsample.{0|1}``) as its flax path."""
    if parts[0] == "downsample":
        return ("downsample", "conv" if parts[1] == "0" else "bn")
    sub, n = parts[0][:-1], parts[0][-1]
    return (f"cb{n}", "conv" if sub == "conv" else "bn")


def _sub(index: str) -> str:
    """A ``Sequential(conv, bn[, ...])`` index as the flax module's name."""
    return "conv" if index == "0" else "bn"


def _resnet_path(parts: list[str]) -> tuple[str, ...]:
    """Inverse of ``_resnet_key``."""
    if len(parts) == 1:
        return (parts[0],)
    layer, unit = parts[0], f"b{parts[1]}"
    if parts[2] == "downsample":
        return (layer, unit, "down", _sub(parts[3]))
    sub, n = parts[2][:-1], parts[2][-1]
    return (layer, unit, f"cb{n}", sub)


def _flax_path(parts: list[str], resnet_backbone: bool = False) -> tuple[str, ...]:
    if _is_resnet(parts[0]):
        return _resnet_path(parts)
    if parts[0] == "trunk" or len(parts) == 1:  # the hourglasses; the SPPE heads
        return tuple(parts)
    if parts[0] == "backbone" and resnet_backbone:
        return ("backbone", *_resnet_path(parts[1:]))
    if parts[0] == "backbone":
        rest = parts[1:]
        if len(rest) == 1:  # stem: conv1/bn1, conv2/bn2
            kind, n = rest[0][:-1], rest[0][-1]
            return ("backbone", f"stem{n}", "conv" if kind == "conv" else "bn")
        s = int(rest[1])
        stage = f"stage{s + 1}"
        if rest[2] == "transition_layer":  # .transition_blocks.{idx}.{0|1}
            idx = int(rest[4])
            name = "new_branch" if idx == s + 1 else f"branch{idx}"
            return ("backbone", stage, "transition", name, _sub(rest[5]))
        k = int(rest[3])  # blocks.{k}: even k a residual block, odd k a fusion
        if rest[4] == "scales_blocks":
            i, j = rest[5], rest[6]
            return ("backbone", stage, f"block{k // 2}", f"scale{i}_unit{j}",
                    *_unit_path(rest[7:]))
        i, j = rest[5], rest[6]
        if len(rest) == 8:  # Sequential(conv, bn, up)
            return ("backbone", stage, f"fusion{k // 2}", f"out{i}_in{j}_up", _sub(rest[7]))
        return ("backbone", stage, f"fusion{k // 2}", f"out{i}_in{j}_down{rest[7]}",
                _sub(rest[8]))
    if parts[0] == "deconv_layers":
        base = f"deconv{parts[1]}"
        if parts[2] == "deconv":
            return (base, "deconv" if parts[3] == "0" else "deconv_bn")
        if parts[2] == "resid_blocks":
            return (base, f"resid{parts[3]}", *_unit_path(parts[4:]))
        if parts[2] == "final_layer":
            return (base, "final_conv")
    if parts[0] == "classification_head":
        if parts[1] == "chann_incr_blocks":
            return ("head", f"incr{parts[2]}", *_unit_path(parts[3:]))
        if parts[1] == "downsample_blocks":
            return ("head", f"down{parts[2]}_{_sub(parts[3])}")
        if parts[1] == "final_conv":
            return ("head", "final_conv" if parts[2] == "0" else "final_bn")
        if parts[1] == "classifier":
            return ("head", "classifier")
    raise KeyError(".".join(parts))


def flax_path_for(prefix: str, resnet_backbone: bool = False) -> tuple[tuple[str, ...], str]:
    """The inverse of ``torch_key_for``: a torch module prefix (no leaf) of
    a port model as its flax variable path and kind. ``resnet_backbone``
    says that the model's ``backbone`` is a ResNet (``SimpleBaseline``),
    whose ``backbone.conv1`` is HRNet's first stem conv otherwise. Checked
    against ``torch_key_for``, so a prefix it cannot map back raises
    ``KeyError``."""
    try:
        path = _flax_path(prefix.split("."), resnet_backbone)
        back, kind = torch_key_for(path)
    except (KeyError, IndexError, ValueError) as e:
        raise KeyError(f"unmapped torch prefix: {prefix}") from e
    if back != prefix:
        raise KeyError(f"unmapped torch prefix: {prefix} (maps back to {back})")
    return path, kind


def resnet_variables_from_torchvision(state_dict: Mapping[str, Any]) -> dict:
    """A torchvision ResNet state dict (any of resnet18..152: the weights
    the reference's SimpleBaseline pulls through ``torch.hub``,
    simple_baseline.py:17) as the flax variable tree of the JAX package's
    ``models.resnet.ResNet``, ``fc`` included, ``num_batches_tracked``
    dropped. A key outside torchvision's ResNet names raises."""
    for key in state_dict:
        if not _is_resnet(key.split(".")[0]):
            raise KeyError(f"unrecognized torchvision key {key}")
    return variables_from_state_dict(state_dict)


def load_torchvision_backbone(model, state_dict: Mapping[str, Any],
                              module: str | None = "backbone"):
    """Load a torchvision ResNet state dict (tensors or arrays) into the
    port's ResNet ``model.<module>`` (``SimpleBaseline``'s ``backbone``;
    ``module=None`` for a bare ``ResNet``), in place, and return ``model``:
    the reference's pretrained-backbone construction
    (simple_baseline.py:17). ``fc`` is dropped when the ResNet has no
    classifier and ``num_batches_tracked`` is ignored; every other key of
    the ResNet must be given, with its shape, and no key besides."""
    import torch

    target = model if module is None else model.get_submodule(module)
    drop_fc = getattr(target, "fc", None) is None
    sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
          for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked") and not (drop_fc and k.split(".")[0] == "fc")}
    own = {k: v for k, v in target.state_dict().items() if not k.endswith("num_batches_tracked")}
    missing, unexpected = sorted(own.keys() - sd.keys()), sorted(sd.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"torchvision state dict vs {type(target).__name__}: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: torchvision {tuple(value.shape)} vs "
                             f"{tuple(own[key].shape)}")
    target.load_state_dict(sd, strict=False)  # strict but for num_batches_tracked
    return model


_TORCH_LEAF = {"weight": ("params", None), "bias": ("params", "bias"),
               "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def variables_from_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """A reference-layout torch state dict (tensors or arrays) as a flax
    ``{"params", "batch_stats"}`` tree of numpy arrays in flax's names and
    shapes, without a template: the inverse of ``variables_to_torch``
    (prefixes stripped, ``num_batches_tracked`` dropped). A ``backbone``
    with ``layer{L}`` units is a ResNet (``SimpleBaseline``)."""
    out: dict = {"params": {}, "batch_stats": {}}
    state_dict = strip_torch_prefixes(state_dict)
    resnet_backbone = any(k.startswith("backbone.layer") for k in state_dict)
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf not in _TORCH_LEAF:
            raise KeyError(f"unmapped torch key: {key}")
        path, kind = flax_path_for(prefix, resnet_backbone)
        col, name = _TORCH_LEAF[leaf]
        if name is None:
            name = "scale" if kind == "bn" else "kernel"
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        node = out[col]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(_from_torch_leaf(kind, name, value))
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def _to_torch_leaf(kind: str, leaf: str, value) -> np.ndarray:
    value = np.asarray(value)
    if leaf == "kernel":
        if kind == "conv":
            return value.transpose(3, 2, 0, 1)
        if kind == "deconv":
            return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        if kind == "dense":
            return value.transpose(1, 0)  # (in, out) -> (out, in)
    return value


def _from_torch_leaf(kind: str, leaf: str, value) -> np.ndarray:
    value = np.asarray(value)
    if leaf == "kernel":
        if kind == "conv":
            return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        if kind == "deconv":
            return value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        if kind == "dense":
            return value.transpose(1, 0)  # (out, in) -> (in, out)
    return value


_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: dict, visit: Callable, path: tuple = ()) -> dict:
    """The tree with every leaf replaced by ``visit(path, name, leaf)``."""
    return {name: _walk(value, visit, path + (name,)) if isinstance(value, dict)
            else visit(path, name, value) for name, value in tree.items()}


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


def variables_from_torch(state_dict: Mapping[str, Any], variables: dict) -> dict:
    """Fill a flax-layout ``{"params", "batch_stats"}`` template (any tree
    whose leaves have ``shape`` and ``dtype``) with a reference-layout torch
    state dict's weights; the inverse of ``variables_to_torch``. Prefixes
    are stripped; every template leaf must find its key with the template's
    shape, and every key but ``num_batches_tracked`` must be used."""
    sd = strip_torch_prefixes(state_dict)
    used = set()

    def visitor(leaf_map):
        def visit(path, leaf, template):
            prefix, kind = torch_key_for(path)
            key = f"{prefix}.{leaf_map[leaf]}"
            if key not in sd:
                raise KeyError(f"torch state dict misses {key} (for {path})")
            value = _from_torch_leaf(kind, leaf, sd[key])
            if tuple(value.shape) != tuple(template.shape):
                raise ValueError(f"shape mismatch at {key}: torch {tuple(value.shape)} vs "
                                 f"flax {tuple(template.shape)}")
            used.add(key)
            return np.ascontiguousarray(value.astype(np.dtype(template.dtype)))
        return visit

    out = {"params": _walk(variables["params"], visitor(_PARAM_LEAF))}
    if "batch_stats" in variables:
        out["batch_stats"] = _walk(variables["batch_stats"], visitor(_STATS_LEAF))
    left = sorted(k for k in sd if k not in used and not k.endswith("num_batches_tracked"))
    if left:
        raise KeyError(f"unused torch keys: {left[:8]}")
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


def read_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The tensors of a reference-layout state dict, on the CPU, from a port
    checkpoint (a file, or a directory of ``trainer.ckpt_backend: orbax``),
    a reference ``.pt`` (a bare state dict or the trainer-state layout
    ``{"module": {"model": state_dict, ...}, ...}``, prefixes stripped), a
    flax npz (``load_flax_npz``) or a native JAX trainer checkpoint (a
    pickle around flax msgpack, ``utils/flax_msgpack.py``; its float arrays
    as float32, as the npz's). A directory that orbax itself wrote raises,
    naming the npz exporter."""
    import pickle
    import zipfile

    import torch

    path = Path(path)
    if path.is_dir():
        from ..train.checkpoint_orbax import read_model_state_dict

        return read_model_state_dict(path)
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            head = f.read(1)
        if head != b"\x80":  # a pickle's protocol opcode
            raise ValueError(f"unrecognized checkpoint format at {path}")
        from .flax_msgpack import load_jax_trainer_checkpoint

        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in variables_to_torch(load_jax_trainer_checkpoint(path)).items()}
    with zipfile.ZipFile(path) as z:
        is_npz = all(name.endswith(".npy") for name in z.namelist())
    if is_npz:
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in load_flax_npz(path).items()}
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: not a plain torch checkpoint ({e})") from e
    if isinstance(ckpt, dict) and isinstance(ckpt.get("module"), dict):
        ckpt = ckpt["module"].get("model", ckpt["module"])
    if not isinstance(ckpt, dict):
        raise ValueError(f"unrecognized torch checkpoint payload in {path}")
    return {k: v for k, v in strip_torch_prefixes(ckpt).items() if torch.is_tensor(v)}
