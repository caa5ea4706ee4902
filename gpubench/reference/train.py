"""Plain float32 training steps: the benchmark's reference for the program's
keypoints and classification steps.

* keypoints (HigherHRNet, Cheng et al. 2020): the mean over every element
  of the crowd-masked squared error of each heatmap stage, plus 1e-3 times
  the associative-embedding push and pull (Newell et al. 2017) read from
  the 1/4 tag map at each visible joint's integer coordinate (clipped into
  the map): pull, a person's mean squared tag deviation, averaged over the
  sample's persons; push, ``exp(-(ref_i - ref_j)^2)`` over ordered pairs of
  distinct persons, halved, over ``(n - 1) * n``; both summed over the
  batch and divided by its size;
* classification: the mean cross entropy of the labels.

Gradients by ``torch.autograd`` through ``reference/nets.py`` in train mode;
the updates are written out: Adam (betas 0.9 and 0.999, eps 1e-8, bias
corrected) and SGD (momentum, Nesterov, weight decay added to the gradient).
Images are uint8 and normalized with the ImageNet mean and std.
"""

from __future__ import annotations

import torch

from .nets import Net

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TAG_WEIGHT = 1e-3


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, 3, H, W]`` -> float32, ImageNet mean and std."""
    dev = images.device
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)[:, None, None]
    std = torch.tensor(STD, dtype=torch.float32, device=dev)[:, None, None]
    return (images.to(torch.float32) / torch.tensor(255.0, device=dev) - mean) / std


def ae_loss(tags: torch.Tensor, joints: torch.Tensor):
    """``tags [N, K, h, w]``, ``joints [N, P, K, 3]`` -> (push, pull) of the
    batch, unweighted."""
    n, k, h, w = tags.shape
    x = joints[..., 0].long().clamp(0, w - 1)
    y = joints[..., 1].long().clamp(0, h - 1)
    vis = (joints[..., 2] > 0).to(tags.dtype)  # [N, P, K]
    t = tags[torch.arange(n, device=tags.device)[:, None, None],
             torch.arange(k, device=tags.device)[None, None, :], y, x]
    cnt = vis.sum(2)
    has = cnt > 0
    ref = (t * vis).sum(2) / cnt.clamp(min=1)
    pull_p = ((t - ref[..., None]) ** 2 * vis).sum(2) / cnt.clamp(min=1)
    n_obj = has.sum(1).to(tags.dtype)
    pull = (pull_p * has).sum(1) / n_obj.clamp(min=1)
    pair = has[:, :, None] & has[:, None, :] & ~torch.eye(has.shape[1], dtype=torch.bool,
                                                           device=tags.device)
    dd = (ref[:, :, None] - ref[:, None, :]) ** 2
    push = (torch.exp(-dd) * pair).sum((1, 2)) / ((n_obj - 1) * n_obj).clamp(min=1) * 0.5
    push = torch.where(n_obj > 1, push, torch.zeros_like(push))
    return push.sum() / n, pull.sum() / n


def keypoints_terms(out, batch: dict) -> dict:
    """The terms of the keypoints loss: ``hm_<i>`` of each heatmap stage,
    ``push`` and ``pull`` weighted, and their sum ``loss``."""
    stages, tags = out
    terms = {f"hm_{i}": ((p - t) ** 2 * m[:, None]).mean()
             for i, (p, t, m) in enumerate(zip(stages, batch["heatmaps"], batch["masks"]))}
    push, pull = ae_loss(tags, batch["joints"])
    terms.update(push=TAG_WEIGHT * push, pull=TAG_WEIGHT * pull)
    terms["loss"] = sum(terms.values())
    return terms


def classification_terms(logits, batch: dict) -> dict:
    return {"loss": torch.nn.functional.cross_entropy(logits, batch["labels"].long())}


def terms_of(arch: dict):
    """The loss terms of the architecture: ``terms(out, batch) -> {name:
    scalar}``, the loss under ``"loss"``."""
    return keypoints_terms if arch["model"] == "HigherHRNet" else classification_terms


def flat(output) -> list:
    """A network's output as a flat list of tensors."""
    if isinstance(output, (list, tuple)):
        return [t for o in output for t in flat(o)]
    return [output]


def structure(arch: dict, tensors: list):
    """``flat``'s list back in the network's output structure: the heatmap
    stages and the tag map, or the logits."""
    return (list(tensors[:-1]), tensors[-1]) if arch["model"] == "HigherHRNet" else tensors[0]


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    def first_gradient(self, name: str, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The gradient the update takes in: Adam's raw gradient."""
        return g

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.t += 1
        for name, g in grads.items():
            zero = torch.zeros_like(g)
            m = self.m[name] = self.b1 * self.m.get(name, zero) + (1 - self.b1) * g
            v = self.v[name] = self.b2 * self.v.get(name, zero) + (1 - self.b2) * g * g
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            params[name] = params[name] - self.lr * mh / (vh.sqrt() + self.eps)


class SGD:
    def __init__(self, lr: float, momentum: float = 0.9, weight_decay: float = 1e-4,
                 nesterov: bool = True):
        self.lr, self.mu, self.wd, self.nesterov = lr, momentum, weight_decay, nesterov
        self.buf = {}

    def first_gradient(self, name: str, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The gradient the update takes in: with the weight decay added."""
        return g + self.wd * p

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        for name, g in grads.items():
            d = g + self.wd * params[name]
            b = self.buf[name] = d if name not in self.buf else self.mu * self.buf[name] + d
            d = d + self.mu * b if self.nesterov else b
            params[name] = params[name] - self.lr * d


def make_optimizer(spec: dict):
    """``{"name": "Adam"|"SGD", "lr": ..., ...}`` -> the optimizer."""
    kw = {k: v for k, v in spec.items() if k != "name"}
    return {"Adam": Adam, "SGD": SGD}[spec["name"]](**kw)


def _leaves(state: dict) -> list:
    return [n for n, t in state.items() if t.is_floating_point()
            and not n.endswith(("running_mean", "running_var"))]


def train_steps(arch: dict, state: dict, batches: list, optimizer, products=None,
                terms=None) -> dict:
    """Train steps on ``batches`` in order, from the float32 ``state`` (every
    parameter and buffer by name, updated in place), on the loss of
    ``terms`` (``terms_of(arch)`` unless given). Returns ``{"loss": [per
    step], "terms": {name: float}, "out": [tensors], "stats": {BN name:
    (mean, var)}, "first_gradient": {leaf: tensor}}``: the first step's loss
    terms, forward output, batch moments, and the gradient that the first
    update took in."""
    names = _leaves(state)
    terms = terms or terms_of(arch)
    losses, first = [], None
    for batch in batches:
        leaves = {n: state[n].detach().requires_grad_(True) for n in names}
        net = Net(arch, {**state, **leaves}, train=True, products=products)
        out = net(normalize(batch["images"]))
        step_terms = terms(out, batch)
        loss = step_terms["loss"]
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: optimizer.first_gradient(n, state[n], g) for n, g in grads.items()}
            out1, stats1 = [t.detach() for t in flat(out)], net.batch_stats
            terms1 = {k: float(v.detach()) for k, v in step_terms.items()}
        del loss, leaves, out, step_terms
        params = {n: state[n] for n in names}
        optimizer.update(params, grads)
        state.update(params)
        state.update(net.new_stats)
        for n in state:
            if n.endswith("num_batches_tracked"):
                state[n] = state[n] + 1
        del grads, net
    return {"loss": losses, "terms": terms1, "first_gradient": first, "out": out1,
            "stats": stats1}
