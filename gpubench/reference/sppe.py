"""Plain float32 top-down pose_hrnet (Sun et al., CVPR 2019,
arXiv:1902.09212; ``leoxiaobin/deep-high-resolution-net.pytorch``,
lib/models/pose_hrnet.py and lib/core/loss.py): the benchmark's reference
for the program's ``HRNetSPPE`` with the published head and its top-down
training step.

* forward: ``reference/nets.py``'s backbone with the single 1/4-scale
  output (``single=True``), then the biased 1x1 ``final_conv`` to the K
  heatmaps, with no softmax; one stage;
* loss: ``JointsMSELoss(use_target_weight=True)``, ``0.5 * mean((w * pred
  - w * target)^2)`` over the batch, the joints and the pixels, reported
  as ``hm_0`` and ``loss``;
* steps: gradients by ``torch.autograd``, ``reference/train.py``'s Adam
  and SGD. The stem and each stage can be recomputed in the backward
  (``recompute``, ``torch.utils.checkpoint``) so that a batch of 96 crops
  at 384x288 fits one card in float32: the arithmetic is the same, the
  batch moments are those of the one forward of each layer.

Departure from the source: BatchNorm is flax's (momentum 0.9, biased
running variance), as in ``reference/nets.py``; the source's uses
PyTorch's (0.1 of the batch, unbiased). Plain ``torch``; imports nothing
of the program.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch.utils.flop_counter import FlopCounterMode

from .nets import Net, stage_table
from .train import _leaves, normalize


class SPPENet(Net):
    """``Net`` with pose_hrnet's head: ``[heatmaps]`` at 1/4. With
    ``recompute`` the stem and the stages of a train forward keep only
    their inputs for the backward."""

    recompute = False

    def _segment(self, fn, *args):
        if self.recompute and self.train and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def backbone(self, x, single: bool) -> list:
        c = self.arch["C"]
        table = stage_table(c, tuple(self.arch.get("num_blocks_per_stage", (1, 1, 4, 3))),
                            self.arch.get("num_units", 4))

        def stem(x):
            x = self.bn("backbone.bn1", self.conv("backbone.conv1", x, 64, 3, 2), True)
            return self.bn("backbone.bn2", self.conv("backbone.conv2", x, 64, 3, 2), True)

        xs = [self._segment(stem, x)]
        for s in range(len(table)):
            xs = self._segment(lambda *t, s=s: self.stage(f"backbone.stages.{s}", list(t), s,
                                                          table, single), *xs)
        return xs

    def __call__(self, x):
        feats = self.backbone(x, single=True)[0]
        return [self.conv("final_conv", feats, self.arch["num_kpts"], 1, bias=True)]


def spec(arch: dict, input_hw: tuple) -> list:
    """Every parameter and buffer of the top-down net: ``[(name, shape,
    kind)]`` in the order the network uses them."""
    net = SPPENet(arch)
    net(torch.empty((1, 3, *input_hw), device="meta"))
    return net.recorded


def joints_mse_terms(out: list, batch: dict) -> dict:
    """``hm_<i>`` of each stage of ``out`` against ``batch["heatmaps"]``
    ``[N, K, h, w]`` under ``batch["target_weight"]`` ``[N, K]``, and their
    sum ``loss``."""
    w = batch["target_weight"][:, :, None, None]
    terms = {f"hm_{i}": 0.5 * ((p * w - batch["heatmaps"] * w) ** 2).mean()
             for i, p in enumerate(out)}
    terms["loss"] = sum(terms.values())
    return terms


def train_steps(arch: dict, state: dict, batches: list, optimizer, products=None, terms=None,
                recompute: bool = False) -> dict:
    """``reference/train.py::train_steps`` for the top-down net: train steps
    on ``batches`` in order from the float32 ``state`` (updated in place),
    on the loss of ``terms`` (``joints_mse_terms`` unless given). Returns
    each step's loss and the first step's terms, output, batch moments and
    the gradient its update took in."""
    names = _leaves(state)
    terms = terms or joints_mse_terms
    losses, first = [], None
    for batch in batches:
        leaves = {n: state[n].detach().requires_grad_(True) for n in names}
        net = SPPENet(arch, {**state, **leaves}, train=True, products=products)
        net.recompute = recompute
        out = net(normalize(batch["images"]))
        stats, new_stats = dict(net.batch_stats), dict(net.new_stats)  # before any recompute
        step_terms = terms(out, batch)
        loss = step_terms["loss"]
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: optimizer.first_gradient(n, state[n], g) for n, g in grads.items()}
            out1, stats1 = [t.detach() for t in out], stats
            terms1 = {k: float(v.detach()) for k, v in step_terms.items()}
        del loss, leaves, out, step_terms
        params = {n: state[n] for n in names}
        optimizer.update(params, grads)
        state.update(params)
        state.update(new_stats)
        for n in state:
            if n.endswith("num_batches_tracked"):
                state[n] = state[n] + 1
        del grads, net
    return {"loss": losses, "terms": terms1, "first_gradient": first, "out": out1,
            "stats": stats1}


def flops(arch: dict, input_hw: tuple, train: bool = False) -> float:
    """Operations of one crop through the top-down net, by
    ``counts.flops``' method: convolutions counted by ``FlopCounterMode``
    on meta tensors (2 a multiply-add), a forward or with ``train`` a
    forward and the backward."""
    params = {n: torch.empty(s, device="meta", requires_grad=train and k != "bn_count")
              for n, s, k in spec(arch, input_hw)}
    x = torch.empty((1, 3, *input_hw), device="meta")
    with FlopCounterMode(display=False) as counter:
        out = SPPENet(arch, params, train=train)(x)
        if train:
            torch.autograd.backward([o.sum() for o in out])
    return float(counter.get_total_flops())
