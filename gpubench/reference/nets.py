"""Plain float32 HRNet-W32 networks as functions of a state dict.

The benchmark's reference for the forward and the training step. Written
from the published topology (HRNet, arXiv:1902.09212; HigherHRNet,
arXiv:1908.10357; HRNet-W32-C, HRNet/HRNet-Image-Classification): the stem
of two stride-2 3x3 convolutions, four stages of multi-resolution units
with all-to-all fusion, and either the HigherHRNet heads (1x1 init head of
K heatmaps and K tags at 1/4, a 4x4 stride-2 transposed convolution, four
BasicBlocks and a 1x1 conv to K heatmaps at 1/2) or the classification head
(bottlenecks to 128..1024 channels, a stride-2 cascade, a 1x1 conv to 2048,
the global mean and a linear layer).

Parameters are named as the reference projects' ``state_dict`` keys, so the
same dict loads into the program under test. Everything here is plain
``torch.nn.functional``; it imports nothing of the program.

BatchNorm follows flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5): in train
mode the output is normalized with the batch's biased variance and the
running statistics move towards the batch mean and the biased variance; in
eval mode the running statistics normalize.

``Net.products`` computes every convolution, transposed convolution and
linear layer: in float32 for the reference, rounded to a lower precision
for the control (``gpubench/reference/precision.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Exact

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running = 0.9 * running + 0.1 * batch
HEAD_CHANNELS = (128, 256, 512, 1024)
FINAL_CHANNELS = 2048


def stage_table(c: int, blocks=(1, 1, 4, 3), units: int = 4) -> list:
    """Per stage: (blocks, units, block kind, input widths, output widths)."""
    return [
        (blocks[0], units, "bottleneck", [64], [c, 2 * c]),
        (blocks[1], units, "basic", [c, 2 * c], [c, 2 * c, 4 * c]),
        (blocks[2], units, "basic", [c, 2 * c, 4 * c], [c, 2 * c, 4 * c, 8 * c]),
        (blocks[3], units, "basic", [c, 2 * c, 4 * c, 8 * c], [c, 2 * c, 4 * c, 8 * c]),
    ]


class Net:
    """One network's parameters and how to apply them.

    ``params``: name -> tensor (float32 weights, BN buffers). ``spec``
    mode (``params is None``) applies the network to meta tensors and
    records every parameter's name, shape and kind instead (``spec()``)."""

    def __init__(self, arch: dict, params: dict | None = None, train: bool = False,
                 products=None):
        self.arch = arch
        self.params = params
        self.train = train
        self.products = products or Exact()
        self.batch_stats: dict = {}  # BN name -> (mean, biased var) of a train forward
        self.recorded: list = []
        self.new_stats: dict = {}  # BN buffer name -> value after a train forward

    # -- parameters -----------------------------------------------------------------

    def _get(self, name: str, shape: tuple, kind: str, device) -> torch.Tensor:
        if self.params is None:
            self.recorded.append((name, tuple(shape), kind))
            return torch.empty(shape, device="meta")
        t = self.params[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        return t

    def conv(self, name: str, x, cout: int, k: int, stride: int = 1, bias: bool = False):
        cin = x.shape[1]
        w = self._get(f"{name}.weight", (cout, cin, k, k), "conv", x.device)
        y = self.products.conv2d(x, w, stride, (k - 1) // 2)
        if bias:
            y = y + self._get(f"{name}.bias", (cout,), "bias", x.device)[:, None, None]
        return y

    def deconv(self, name: str, x, cout: int):
        """4x4 stride-2 transposed convolution, padding 1 (2x upsample)."""
        w = self._get(f"{name}.weight", (x.shape[1], cout, 4, 4), "deconv", x.device)
        return self.products.conv_transpose2d(x, w, 2, 1)

    def linear(self, name: str, x, cout: int):
        w = self._get(f"{name}.weight", (cout, x.shape[1]), "linear", x.device)
        return self.products.linear(x, w) + self._get(f"{name}.bias", (cout,), "bias", x.device)

    def bn(self, name: str, x, relu: bool = False):
        c = x.shape[1]
        w = self._get(f"{name}.weight", (c,), "bn_weight", x.device)
        b = self._get(f"{name}.bias", (c,), "bn_bias", x.device)
        mean = self._get(f"{name}.running_mean", (c,), "bn_mean", x.device)
        var = self._get(f"{name}.running_var", (c,), "bn_var", x.device)
        if self.params is None:
            self.recorded.append((f"{name}.num_batches_tracked", (), "bn_count"))
        if self.train:
            with torch.no_grad():
                bm = x.mean((0, 2, 3))
                bv = (x - bm[:, None, None]).square().mean((0, 2, 3))
                self.batch_stats[name] = (bm, bv)
                self.new_stats[f"{name}.running_mean"] = BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * bm
                self.new_stats[f"{name}.running_var"] = BN_MOMENTUM * var + (1 - BN_MOMENTUM) * bv
            y = F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)
        else:
            y = F.batch_norm(x, mean, var, w, b, False, 0.0, BN_EPS)
        return torch.relu(y) if relu else y

    def conv_bn(self, name: str, x, cout: int, k: int, stride: int = 1, relu: bool = False):
        return self.bn(f"{name}.1", self.conv(f"{name}.0", x, cout, k, stride), relu)

    # -- units ----------------------------------------------------------------------

    def bottleneck(self, name: str, x, features: int):
        mid = features // 4
        out = self.bn(f"{name}.bn1", self.conv(f"{name}.conv1", x, mid, 1), True)
        out = self.bn(f"{name}.bn2", self.conv(f"{name}.conv2", out, mid, 3), True)
        out = self.bn(f"{name}.bn3", self.conv(f"{name}.conv3", out, features, 1))
        res = x if x.shape[1] == features else self.conv_bn(f"{name}.downsample", x, features, 1)
        return torch.relu(out + res)

    def basic(self, name: str, x, features: int):
        out = self.bn(f"{name}.bn1", self.conv(f"{name}.conv1", x, features, 3), True)
        out = self.bn(f"{name}.bn2", self.conv(f"{name}.conv2", out, features, 3))
        res = x if x.shape[1] == features else self.conv_bn(f"{name}.downsample", x, features, 1)
        return torch.relu(out + res)

    def fusion(self, name: str, xs: list, widths: list, n_out: int) -> list:
        """Scale i sums every scale j: j < i through (i - j) stride-2 3x3
        conv+BN (ReLU between), j == i as is, j > i through a 1x1 conv+BN
        and a nearest 2^(j-i) upsample; then ReLU."""
        outs = []
        for i in range(n_out):
            acc = None
            for j, x in enumerate(xs):
                base = f"{name}.scales_fusion_layers.{i}.{j}"
                if i > j:
                    y = x
                    for k in range(i - j):
                        last = k == i - j - 1
                        y = self.conv_bn(f"{base}.{k}", y, widths[i] if last else widths[j], 3, 2,
                                         relu=not last)
                elif i < j:
                    y = self.bn(f"{base}.1", self.conv(f"{base}.0", x, widths[i], 1))
                    y = F.interpolate(y, scale_factor=2 ** (j - i), mode="nearest")
                else:
                    y = x
                acc = y if acc is None else acc + y
            outs.append(torch.relu(acc))
        return outs

    def stage(self, name: str, xs: list, s: int, table: list, single: bool) -> list:
        n_blocks, n_units, kind, cin, cout = table[s]
        final = s == len(table) - 1
        widths = [c * 4 for c in cin] if kind == "bottleneck" else list(cout[: len(cin)])
        unit = self.bottleneck if kind == "bottleneck" else self.basic
        for b in range(n_blocks):
            outs = []
            for i, x in enumerate(xs):
                for u in range(n_units):
                    feat = cin[i] * 4 if kind == "bottleneck" else cin[i]
                    x = unit(f"{name}.blocks.{2 * b}.scales_blocks.{i}.{u}", x, feat)
                outs.append(x)
            n_out = 1 if final and single and b == n_blocks - 1 else len(cin)
            xs = self.fusion(f"{name}.blocks.{2 * b + 1}", outs, widths, n_out)
            cin = widths
        if final:
            return xs
        t = f"{name}.transition_layer.transition_blocks"
        outs = [self.conv_bn(f"{t}.{i}", x, cout[i], 3, relu=True) if s == 0 else x
                for i, x in enumerate(xs)]
        outs.append(self.conv_bn(f"{t}.{len(xs)}", xs[-1], cout[-1], 3, 2, relu=True))
        return outs

    def backbone(self, x, single: bool) -> list:
        c = self.arch["C"]
        table = stage_table(c, tuple(self.arch.get("num_blocks_per_stage", (1, 1, 4, 3))),
                            self.arch.get("num_units", 4))
        x = self.bn("backbone.bn1", self.conv("backbone.conv1", x, 64, 3, 2), True)
        xs = [self.bn("backbone.bn2", self.conv("backbone.conv2", x, 64, 3, 2), True)]
        for s in range(len(table)):
            xs = self.stage(f"backbone.stages.{s}", xs, s, table, single)
        return xs

    # -- networks -------------------------------------------------------------------

    def higher_hrnet(self, x):
        """``([heatmaps at 1/4, heatmaps at 1/2], tags at 1/4)``."""
        k, c = self.arch["num_kpts"], self.arch["C"]
        feats = self.backbone(x, single=True)[0]
        init = self.conv("init_heatmaps_head", feats, 2 * k, 1, bias=True)
        y = torch.cat([feats, init], 1)
        y = self.bn("deconv_layers.0.deconv.1", self.deconv("deconv_layers.0.deconv.0", y, c), True)
        for r in range(self.arch.get("num_deconv_resid_blocks", 4)):
            y = self.basic(f"deconv_layers.0.resid_blocks.{r}", y, c)
        half = self.conv("deconv_layers.0.final_layer", y, k, 1, bias=True)
        return [init[:, :k], half], init[:, k:]

    def classifier(self, x):
        """Logits ``[N, num_classes]``."""
        xs = self.backbone(x, single=False)
        h = "classification_head"
        out = self.bottleneck(f"{h}.chann_incr_blocks.0", xs[0], HEAD_CHANNELS[0])
        for i in range(1, len(HEAD_CHANNELS)):
            down = self._biased_conv_bn(f"{h}.downsample_blocks.{i - 1}", out,
                                        HEAD_CHANNELS[i], 3, 2)
            out = self.bottleneck(f"{h}.chann_incr_blocks.{i}", xs[i], HEAD_CHANNELS[i]) + down
        out = self._biased_conv_bn(f"{h}.final_conv", out, FINAL_CHANNELS, 1, 1)
        return self.linear(f"{h}.classifier", out.mean((2, 3)), self.arch["num_classes"])

    def _biased_conv_bn(self, name: str, x, cout: int, k: int, stride: int):
        """The classification head's conv (with a bias) + BN + ReLU."""
        return self.bn(f"{name}.1", self.conv(f"{name}.0", x, cout, k, stride, bias=True), True)

    def __call__(self, x):
        return self.higher_hrnet(x) if self.arch["model"] == "HigherHRNet" else self.classifier(x)


def spec(arch: dict, input_hw: tuple) -> list:
    """Every parameter and buffer of ``arch``: ``[(name, shape, kind)]`` in
    the order the network uses them."""
    net = Net(arch)
    net(torch.empty((1, 3, *input_hw), device="meta"))
    return net.recorded
