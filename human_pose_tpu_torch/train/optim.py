"""Optimizer and learning-rate scheduler factories (port of
human_pose_tpu/train/optim.py).

The JAX package builds optax transformations whose learning rate is data
(``inject_hyperparams``); its schedulers are host-side counters. Here each
optimizer is a ``torch.optim.Optimizer`` over the model's parameters, the
learning rate is written into every ``param_group`` before each update
(``set_learning_rate``), and the schedulers are the same host-side objects.

Each optimizer does optax's update for the JAX package's arguments:

* ``SGD``: ``torch.optim.SGD`` with ``dampening`` 0 (optax's ``trace`` has
  none; the JAX factory takes ``dampening`` and ignores it).
* ``Adam``: ``torch.optim.Adam``. With ``weight_decay`` optax adds the
  decayed weights after the Adam scaling, which is ``torch.optim.AdamW``'s
  decoupled decay (``torch.optim.Adam`` adds them to the gradient).
* ``AdamW``, ``Adamax``, ``Adadelta``: their ``torch.optim`` classes, whose
  updates are optax's (Adamax's infinity norm is ``max(b2 * u, |g| + eps)``
  in both).
* ``Adagrad``, ``RMSprop``: classes of this module. optax's Adagrad starts
  its accumulator at 0.1 and scales by ``rsqrt(acc + eps)``; torch starts
  at 0 and divides by ``sqrt(acc) + eps``. optax's RMSprop takes ``eps``
  inside the square root and applies momentum to the update after the
  learning rate; torch's before it.

``clip_norm`` clips the global gradient norm before the update as optax's
``clip_by_global_norm`` does: ``g / norm * clip_norm`` when ``norm >=
clip_norm``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable

import torch

__all__ = [
    "OPTIMIZERS", "LR_SCHEDULERS", "LRScheduler", "clip_by_global_norm_", "create_lr_scheduler",
    "create_optimizer", "set_learning_rate",
]


class Adagrad(torch.optim.Optimizer):
    """optax's ``adagrad``: ``acc += g^2`` from ``initial_accumulator_value``,
    ``p -= lr * g * rsqrt(acc + eps)`` where ``acc > 0`` (0 elsewhere)."""

    def __init__(self, params, lr: float, eps: float = 1e-10, initial_accumulator_value: float = 0.1):
        super().__init__(params, {"lr": lr, "eps": eps,
                                  "initial_accumulator_value": initial_accumulator_value})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                acc = state["sum_of_squares"]
                acc.add_(p.grad.square())
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))
                p.add_(scale.mul_(p.grad).mul_(-group["lr"]))


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop``: ``nu = decay * nu + (1 - decay) * g^2`` from 0,
    ``u = -lr * g * rsqrt(nu + eps)``; with ``momentum``, ``t = u +
    momentum * t`` and the update is ``t``."""

    def __init__(self, params, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0):
        super().__init__(params, {"lr": lr, "alpha": alpha, "eps": eps, "momentum": momentum})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, momentum = group["alpha"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).add_(p.grad.square().mul_(1 - decay))
                update = torch.rsqrt(nu + group["eps"]).mul_(p.grad).mul_(-group["lr"])
                if momentum:
                    update = state["trace"].mul_(momentum).add_(update)
                p.add_(update)


def _sgd(params, lr, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False,
         dampening: float = 0.0):
    return torch.optim.SGD(params, lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum), dampening=0.0)


def _adam(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
    if weight_decay:
        return torch.optim.AdamW(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr, betas=tuple(betas), eps=eps)


def _adamw(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
    return torch.optim.AdamW(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)


def _adamax(params, lr, betas=(0.9, 0.999), eps=1e-8):
    return torch.optim.Adamax(params, lr, betas=tuple(betas), eps=eps)


def _adadelta(params, lr, rho=0.9, eps=1e-6, weight_decay=0.0):
    return torch.optim.Adadelta(params, lr, rho=rho, eps=eps, weight_decay=weight_decay)


def _adagrad(params, lr, eps=1e-10):
    return Adagrad(params, lr, eps=eps)


def _rmsprop(params, lr, alpha=0.99, eps=1e-8, momentum=0.0):
    return RMSprop(params, lr, alpha=alpha, eps=eps, momentum=momentum)


OPTIMIZERS: dict[str, Callable[..., torch.optim.Optimizer]] = {
    "SGD": _sgd,
    "Adam": _adam,
    "AdamW": _adamw,
    "Adamax": _adamax,
    "Adadelta": _adadelta,
    "Adagrad": _adagrad,
    "RMSprop": _rmsprop,
}


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` unless ``norm < max_norm``, where ``norm`` is
    the global L2 norm of all of them. No host sync."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def create_optimizer(parameters: Iterable[torch.nn.Parameter], name: str, lr: float,
                     clip_norm: float | None = None, **params) -> torch.optim.Optimizer:
    """The optimizer ``name`` (a key of ``OPTIMIZERS``) over ``parameters``
    with the JAX package's arguments ``params``. ``clip_norm``: clip the
    global gradient norm before each update (off by default, as in the
    reference)."""
    optimizer = OPTIMIZERS[name](list(parameters), lr, **params)
    if clip_norm is not None:
        max_norm = float(clip_norm)

        def clip(opt, args, kwargs):
            grads = [p.grad for group in opt.param_groups for p in group["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, max_norm)

        optimizer.register_step_pre_hook(clip)
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Write ``lr`` into every parameter group: the learning rate is an
    argument of each step, not a constant of the optimizer."""
    for group in optimizer.param_groups:
        group["lr"] = lr


# ---------------------------------------------------------------------------
# LR schedulers: host-side counters, the JAX package's formulas
# ---------------------------------------------------------------------------


class LRScheduler:
    """lr = f(counter); the counter advances per 'epoch' or per 'step'."""

    def __init__(self, base_lr: float, interval: str = "epoch"):
        if interval not in ("epoch", "step"):
            raise ValueError(f"interval must be 'epoch' or 'step', not {interval!r}")
        self.base_lr = base_lr
        self.interval = interval
        self.last_count = 0

    def get_lr(self, count: int) -> float:
        raise NotImplementedError

    @property
    def lr(self) -> float:
        return self.get_lr(self.last_count)

    def step(self, metric: float | None = None) -> float:
        self.last_count += 1
        return self.lr

    def state_dict(self) -> dict:
        return {"last_count": self.last_count}

    def load_state_dict(self, state: dict) -> None:
        self.last_count = int(state["last_count"])


class ConstantLR(LRScheduler):
    def get_lr(self, count):
        return self.base_lr


class MultiStepLR(LRScheduler):
    def __init__(self, base_lr, milestones, gamma=0.1, interval="epoch"):
        super().__init__(base_lr, interval)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def get_lr(self, count):
        passed = sum(1 for m in self.milestones if count >= m)
        return self.base_lr * self.gamma**passed


class ExponentialLR(LRScheduler):
    def __init__(self, base_lr, gamma, interval="epoch"):
        super().__init__(base_lr, interval)
        self.gamma = gamma

    def get_lr(self, count):
        return self.base_lr * self.gamma**count


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr, T_max, eta_min=0.0, interval="epoch"):
        super().__init__(base_lr, interval)
        self.T_max = T_max
        self.eta_min = eta_min

    def get_lr(self, count):
        t = min(count, self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, base_lr, T_0, T_mult=1, eta_min=0.0, interval="epoch"):
        super().__init__(base_lr, interval)
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def get_lr(self, count):
        t, T_i = count, self.T_0
        while t >= T_i:
            t -= T_i
            T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / T_i)) / 2


class PolynomialLR(LRScheduler):
    def __init__(self, base_lr, total_iters=5, power=1.0, interval="epoch"):
        super().__init__(base_lr, interval)
        self.total_iters = total_iters
        self.power = power

    def get_lr(self, count):
        t = min(count, self.total_iters)
        return self.base_lr * (1 - t / self.total_iters) ** self.power


class OneCycleLR(LRScheduler):
    """Cosine-annealed one-cycle policy (warm up to max_lr, then anneal)."""

    def __init__(self, base_lr, total_steps, max_lr=None, pct_start=0.3,
                 div_factor=25.0, final_div_factor=1e4, interval="step"):
        max_lr = max_lr if max_lr is not None else base_lr
        super().__init__(max_lr, interval)
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.initial_lr = max_lr / div_factor
        self.min_lr = self.initial_lr / final_div_factor

    def get_lr(self, count):
        t = min(count, self.total_steps)
        up = self.pct_start * self.total_steps
        if t <= up:
            frac = t / max(up, 1)
            return self.initial_lr + (self.base_lr - self.initial_lr) * (1 - math.cos(math.pi * frac)) / 2
        frac = (t - up) / max(self.total_steps - up, 1)
        return self.min_lr + (self.base_lr - self.min_lr) * (1 + math.cos(math.pi * frac)) / 2


class ReduceLROnPlateau(LRScheduler):
    def __init__(self, base_lr, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0, interval="epoch"):
        super().__init__(base_lr, interval)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.current_lr = base_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0

    def get_lr(self, count):
        return self.current_lr

    def step(self, metric: float | None = None) -> float:
        self.last_count += 1
        if metric is None:
            return self.current_lr
        improved = (
            metric < self.best - self.threshold
            if self.mode == "min"
            else metric > self.best + self.threshold
        )
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.current_lr

    def state_dict(self):
        return {
            "last_count": self.last_count,
            "current_lr": self.current_lr,
            "best": self.best,
            "num_bad": self.num_bad,
        }

    def load_state_dict(self, state):
        self.last_count = int(state["last_count"])
        self.current_lr = float(state["current_lr"])
        self.best = float(state["best"])
        self.num_bad = int(state["num_bad"])


LR_SCHEDULERS: dict[str, Any] = {
    "ConstantLR": ConstantLR,
    "MultiStepLR": MultiStepLR,
    "ExponentialLR": ExponentialLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "PolynomialLR": PolynomialLR,
    "OneCycleLR": OneCycleLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def create_lr_scheduler(base_lr: float, name: str, interval: str = "epoch", **params) -> LRScheduler:
    return LR_SCHEDULERS[name](base_lr, interval=interval, **params)
