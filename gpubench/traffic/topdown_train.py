"""Top-down training (pose_hrnet) at the published point: the program's
``sppe_train_step`` on a pool of batches of person crops made on the device
from the seed. ``gpubench/training.py`` has the window and the readings of
the first steps; ``gpubench/topdown.py`` the float32 reference's readings
(``reference/sppe.py``) that the check compares with them.

Parameters: ``batch`` uint8 crops a batch of ``height`` x ``width``, a
``pool`` of distinct batches cycled, ``check_steps`` steps read for the
check, ``trace_units`` steps traced; the targets at a quarter of the
crop's size: each of the K joints labelled with probability ``visible`` at
a uniform pixel of the map, a Gaussian of ``sigma`` there (peak 1, zero
background) and target weight 1; an unlabelled joint an empty map and
weight 0.
"""

from __future__ import annotations

import sys

import torch

from gpubench.harness import Laps, arch_of
from gpubench.reference.sppe import flops, spec
from gpubench.topdown import input_hw, reference_readings, terms_err
from gpubench.training import TrainCell, checks, compare, worst
from gpubench.weights import make_weights


def topdown_batch(gen, dev, n: int, hw: tuple, k: int, p: dict) -> dict:
    h, w = hw[0] // 4, hw[1] // 4
    images = torch.randint(0, 256, (n, 3, *hw), generator=gen, device=dev, dtype=torch.uint8)
    scale = torch.tensor([w, h], device=dev, dtype=torch.float32)
    xy = (torch.rand((n, k, 2), generator=gen, device=dev) * scale).floor()
    vis = (torch.rand((n, k), generator=gen, device=dev) < p["visible"]).float()
    two_s2 = 2 * p["sigma"] ** 2
    gx = torch.exp(-(torch.arange(w, device=dev) - xy[..., 0, None]) ** 2 / two_s2)
    gy = torch.exp(-(torch.arange(h, device=dev) - xy[..., 1, None]) ** 2 / two_s2)
    heatmaps = (gy * vis[..., None])[..., :, None] * gx[..., None, :]
    return {"images": images, "heatmaps": heatmaps, "target_weight": vis}


class Cell(TrainCell):
    MODEL = "HRNetSPPE"

    def __init__(self, ctx):
        # the program's top-down step first: a program without it fails here
        from human_pose_tpu_torch.train.steps import sppe_train_step
        from human_pose_tpu_torch.train.optim import create_optimizer
        from human_pose_tpu_torch.train.state import TrainState

        lap = Laps()
        p, c = ctx.params, ctx.config
        if c["model"] != self.MODEL:
            raise ValueError(f"{type(self).__module__} trains {self.MODEL}, not {c['model']}")
        self.train_step = sppe_train_step
        self.ctx, self.p, dev = ctx, p, ctx.device
        self.arch = arch_of(c)
        self.hw = input_hw(p)
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

        # the first steps, as TrainCell reads them
        self.first_out, self.first_moments = [], None
        hooks = [self.state.model.register_forward_hook(self._keep_output),
                 self.state.model.backbone.bn1.register_forward_hook(self._keep_moments)]
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
        """The cell's ``pool`` batches, made on ``dev`` from the seed."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed % 2**63)
        return [topdown_batch(gen, dev, p["batch"], input_hw(p), config["num_kpts"], p)
                for _ in range(p["pool"])]

    def build(self, c: dict, dev):
        from human_pose_tpu_torch.models import HRNetSPPE

        return HRNetSPPE(num_keypoints=c["num_kpts"], C=c["C"],
                         num_blocks_per_stage=tuple(c["num_blocks_per_stage"]),
                         num_units=c["num_units"], heatmap_softmax=c["heatmap_softmax"],
                         device=dev)

    def step(self, state, batch: dict, lr) -> dict:
        return self.train_step(state, batch, lr)[1]

    def trace(self, ctx) -> None:
        from gpubench.trace import profile_units

        ctx.extra["flops_per_unit"] = flops(self.arch, self.hw, train=True) * self.p["batch"]
        ctx.trace = profile_units(lambda i: self._step(), self.p["trace_units"])

    def check(self, ctx) -> list:
        if not self.first_out:  # the program's first step never ran the network
            return checks({k: float("inf") for k in ctx.limits}, ctx.limits)
        prog = {"loss": self.first_losses, "grad": self.first_grad, "change": self.change,
                "out": self.first_out, "moments": self.first_moments}
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        ref = reference_readings(self.arch, self.spec, ctx.seed, ctx.device,
                                 self.pool[:self.p["check_steps"]], ctx.config["optimizer"])
        for what in ("grad", "change"):
            print(f"worst leaves of {what}: " + "; ".join(
                f"{n} {prog[what].get(n, 0.0)!r} against {ref[what][n]!r}"
                for n in worst(prog[what], ref[what], 4)), file=sys.stderr)
        if ctx.device.type == "cuda":
            print(f"reference peak {torch.cuda.max_memory_allocated(ctx.device) / 2**30:.2f} GiB",
                  file=sys.stderr)
        readings = compare(prog, ref)
        readings["loss1_terms_err"] = terms_err(self.first_out, self.pool[0], self.first_terms)
        return checks(readings, ctx.limits)
