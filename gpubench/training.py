"""What the training kinds share (``traffic/keypoints_train.py``,
``traffic/classification_train.py``): training steps on batches made on
the device from the seed, a pool of ``pool`` distinct batches cycled,
through the program's train step on one ``TrainState`` with the
configuration's optimizer and precision; and the check of those steps
against the float32 reference.

Set-up builds the state, and its first ``check_steps`` steps (on pool
batches 0, 1, 2) are the warm-up, read for the check: in the first, the
forward output and the first BatchNorm's batch moments (hooks), the loss
and its terms as the step reports them, and the norm of each leaf's
gradient as the optimizer took it in (Adam's first moment over 1 - beta1;
SGD's momentum buffer); after the last, each leaf's change (parameters
and BatchNorm running statistics). The window goes on from there with the
same state. After the window the float32 reference recomputes those steps
from the same weights and batches, and works out the loss terms again on
the program's own first forward output; ``compare`` lists the numbers.
"""

from __future__ import annotations

import math
import sys

import torch
from torch.profiler import record_function

from gpubench import counts
from gpubench.harness import Laps, arch_of
from gpubench.reference.nets import spec
from gpubench.reference.train import flat, make_optimizer, structure, terms_of, train_steps
from gpubench.weights import make_weights


class TrainCell:
    """A training kind's ``Cell``. A subclass names the ``MODEL`` its
    configurations have and gives ``make_batches(seed, config, params,
    device)``, ``build(config, device)`` (the program's model) and
    ``step(state, batch, lr)`` (the program's train step; its metrics)."""

    MODEL = ""

    def __init__(self, ctx):
        from human_pose_tpu_torch.train.optim import create_optimizer
        from human_pose_tpu_torch.train.state import TrainState

        lap = Laps()
        p, c = ctx.params, ctx.config
        if c["model"] != self.MODEL:
            raise ValueError(f"{type(self).__module__} trains {self.MODEL}, not {c['model']}")
        self.ctx, self.p, dev = ctx, p, ctx.device
        self.arch = arch_of(c)
        self.hw = (p["size"], p["size"])
        model = self.build(c, dev)
        self.spec = spec(self.arch, self.hw)
        model.load_state_dict(make_weights(self.spec, ctx.seed, dev), strict=True)
        opt = dict(c["optimizer"])
        self.lr = opt.pop("lr")
        name = opt.pop("name")
        optimizer = create_optimizer(model.parameters(), name, self.lr, **opt)
        self.state = TrainState.create(model, optimizer, dtype=getattr(torch, c["precision"]),
                                       device=dev)
        lap("model, weights and state")
        self.pool = self.make_batches(ctx.seed, c, p, dev)
        lap("batches")
        self.steps, self.window_losses = 0, []

        # the first steps: the warm-up, read for the check. The first
        # step's forward output and the first BatchNorm's batch moments are
        # read on their way (hooks, removed after it)
        self.first_out, self.first_moments = [], None
        bn1 = next(n for n, _, kind in self.spec if kind == "bn_weight").rsplit(".", 1)[0]
        hooks = [self.state.model.register_forward_hook(self._keep_output),
                 self.state.model.get_submodule(bn1).register_forward_hook(self._keep_moments)]
        self.first_terms = self._step()
        for h in hooks:
            h.remove()
        self.first_losses = [self.first_terms["loss"]]
        self.first_grad = self._first_gradient(name)
        for _ in range(p["check_steps"] - 1):
            self.first_losses.append(self._step()["loss"])
        self.change = self._change()
        lap("first steps and their readings")

    @staticmethod
    def make_batches(seed: int, config: dict, p: dict, dev) -> list:
        raise NotImplementedError

    def build(self, config: dict, dev):
        raise NotImplementedError

    def step(self, state, batch: dict, lr) -> dict:
        raise NotImplementedError

    def _keep_output(self, module, inputs, output) -> None:
        self.first_out = [t.detach().to("cpu", torch.float32, copy=True) for t in flat(output)]

    @torch.no_grad()
    def _keep_moments(self, module, inputs, output) -> None:
        """The batch mean and biased variance, in float32, of what the
        first BatchNorm normalizes."""
        x = inputs[0].float()
        mean = x.mean((0, 2, 3))
        self.first_moments = [mean.cpu(), (x - mean[:, None, None]).square().mean((0, 2, 3)).cpu()]

    def _step(self) -> dict:
        batch = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        with record_function("step"):
            return self.step(self.state, batch, self.lr)

    @torch.no_grad()
    def _first_gradient(self, name: str) -> dict:
        """The norm of each leaf's gradient as the first update took it in."""
        opt = self.state.optimizer
        out = {}
        for leaf, param in self.state.model.named_parameters():
            st = opt.state.get(param, {})
            if name == "Adam" and "exp_avg" in st:
                g = st["exp_avg"] / (1 - opt.param_groups[0]["betas"][0])
            elif name == "SGD" and st.get("momentum_buffer") is not None:
                g = st["momentum_buffer"]
            else:
                continue
            out[leaf] = g.float().norm()
        return out

    @torch.no_grad()
    def _change(self) -> dict:
        start = make_weights(self.spec, self.ctx.seed, self.ctx.device)
        sd = self.state.model.state_dict()
        return {n: (sd[n].float() - start[n]).norm() for n, t in start.items()
                if t.is_floating_point()}

    def unit(self, i: int):
        self.window_losses.append(self._step()["loss"])

    def drain(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def end_to_end(self, ctx) -> dict:
        return {"train_img_per_s": self.p["batch"] * ctx.units / ctx.window_s}

    @property
    def attempted(self) -> int:
        return len(self.window_losses)

    @property
    def failed(self) -> int:
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def trace(self, ctx) -> None:
        from gpubench.trace import profile_units

        ctx.extra["flops_per_unit"] = counts.flops(self.arch, self.hw, train=True) * self.p["batch"]
        ctx.trace = profile_units(lambda i: self._step(), self.p["trace_units"])

    def release(self) -> None:
        self.first_losses = [float(x) for x in self.first_losses]
        self.first_terms = {n: float(v) for n, v in self.first_terms.items()}
        self.first_grad = {n: float(v) for n, v in self.first_grad.items()}
        self.change = {n: float(v) for n, v in self.change.items()}
        del self.state
        self.window_losses = []
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, ctx) -> list:
        if not self.first_out:  # the program's first step never ran the network
            return checks({k: math.inf for k in ctx.limits}, ctx.limits)
        prog = {"loss": self.first_losses, "grad": self.first_grad, "change": self.change,
                "out": self.first_out, "moments": self.first_moments}
        ref = reference_readings(self.arch, self.spec, ctx.seed, ctx.device,
                                 self.pool[:self.p["check_steps"]], ctx.config["optimizer"])
        for what in ("grad", "change"):
            print(f"worst leaves of {what}: " + "; ".join(
                f"{n} {prog[what].get(n, 0.0)!r} against {ref[what][n]!r}"
                for n in worst(prog[what], ref[what], 4)), file=sys.stderr)
        readings = compare(prog, ref)
        readings["loss1_terms_err"] = terms_err(self.arch, self.first_out, self.pool[0],
                                                self.first_terms)
        return checks(readings, ctx.limits)


def checks(readings: dict, limits: dict) -> list:
    """The readings that the cell compares, each with its limit; the others
    reported on standard error."""
    for name, value in readings.items():
        if name not in limits:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    return [(name, readings[name], limit) for name, limit in limits.items()]


def _norms(leaves: dict) -> dict:
    return {k: float(g.norm()) for k, g in leaves.items()}


def reference_readings(arch: dict, spec_: list, seed: int, device, batches: list, optimizer: dict,
                       products=None, terms=None) -> dict:
    """The reference's steps on ``batches`` from the seed's weights (float32
    products unless ``products`` says otherwise; TF32 off; the loss terms
    of ``terms_of`` unless ``terms`` says otherwise): each step's loss; the
    first step's loss terms, forward output, first BatchNorm's batch
    moments and each leaf's first-gradient norm; each leaf's change over
    the steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = make_weights(spec_, seed, device)
    out = train_steps(arch, state, batches, make_optimizer(optimizer), products, terms)
    start = make_weights(spec_, seed, device)
    with torch.no_grad():
        change = {k: float((state[k] - start[k]).norm()) for k, t in start.items()
                  if t.is_floating_point()}
    return {"loss": out["loss"], "terms": out["terms"], "grad": _norms(out["first_gradient"]),
            "change": change, "out": out["out"],
            "moments": list(next(iter(out["stats"].values())))}


@torch.no_grad()
def terms_err(arch: dict, out: list, batch: dict, reported: dict) -> float:
    """The loss terms that a step reported for its first batch against the
    reference's terms worked out on that step's own forward output ``out``
    (flat, float32) and the same batch: the largest gap of a term, over the
    larger of the reference's term and a millionth of its loss (a term that
    is nought to rounding reads its rounding against the loss)."""
    dev, n = batch["images"].device, batch["images"].shape[0]
    if any(t.shape[0] != n for t in out):  # not an output of this batch
        return math.inf
    ref = terms_of(arch)(structure(arch, [t.to(dev) for t in out]), batch)
    floor = 1e-6 * abs(float(ref["loss"]))
    return max(abs(float(reported[k]) - float(v)) / max(abs(float(v)), floor, 1e-30)
               if k in reported else math.inf for k, v in ref.items())


def worst(prog: dict, ref: dict, n: int) -> list:
    """The ``n`` leaves of the largest gap, largest first."""
    med = float(torch.tensor(list(ref.values())).median())
    return sorted(ref, key=lambda k: -abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30))[:n]


def gaps(prog: dict, ref: dict, names: list) -> list:
    """Each leaf's gap between the program's and the reference's norm, over
    the larger of the reference's norm of that leaf and of the median leaf."""
    med = float(torch.tensor([ref[n] for n in names]).median())
    return [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return math.inf
    a, b = a.to(b.device).double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def compare(prog: dict, ref: dict) -> dict:
    """The program's first three steps against the reference's.
    ``moments1_err``: the larger relative L2 error of the first BatchNorm's
    batch mean and variance; ``out1_err``: the largest relative L2 error of
    an output of the first forward; ``loss1_gap`` and ``loss_gap``: the
    relative gap of the first step's loss and the largest of any step's;
    ``grad_gap_med`` and ``grad_gap``: the median and the worst leaf's gap
    of first-gradient norms (``gaps``); ``change_gap_med`` and
    ``change_gap``: the same of each leaf's change over the steps. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move under Adam by round-off alone and are not held to the change."""
    names = sorted(ref["grad"])
    med = float(torch.tensor(list(ref["grad"].values())).median())
    moved = [k for k in ref["change"] if ref["grad"].get(k, math.inf) >= 1e-3 * med]
    g, c = gaps(prog["grad"], ref["grad"], names), gaps(prog["change"], ref["change"], moved)
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"])]
    return {
        "moments1_err": max(rel_l2(p, r) for p, r in zip(prog["moments"], ref["moments"])),
        "out1_err": max(rel_l2(p, r) for p, r in zip(prog["out"], ref["out"])),
        "loss1_gap": loss[0], "loss_gap": max(loss),
        "grad_gap_med": float(torch.tensor(g).median()), "grad_gap": max(g),
        "change_gap_med": float(torch.tensor(c).median()), "change_gap": max(c),
    }
