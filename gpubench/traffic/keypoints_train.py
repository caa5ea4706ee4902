"""Keypoints training (HigherHRNet) at the published point: the program's
``keypoints_train_step`` on a pool of batches made on the device from the
seed (``gpubench/training.py`` has the step, the window and the check).

Parameters: ``batch`` images a batch at ``size`` x ``size``, a ``pool`` of
distinct batches cycled, ``check_steps`` steps read for the check,
``trace_units`` steps traced, and the targets': persons an image drawn
skewed toward few (1 + floor(max_people * u^3)), each a centre and joints
scattered around it at a person scale of 4 to 16 quarter-resolution
pixels, every joint visible with probability ``visible``; target heatmaps
at 1/4 and 1/2 (a Gaussian of ``sigma`` at each visible joint, the maximum
over persons); masks of ones with, in a share ``crowd`` of the images, a
crowd rectangle of zeros; joints ``[N, max_people, K, 3]``.
"""

from __future__ import annotations

import torch

from gpubench.training import TrainCell


def keypoints_batch(gen, dev, n: int, size: int, k: int, p: dict) -> dict:
    q, m, sigma = size // 4, p["max_people"], p["sigma"]
    images = torch.randint(0, 256, (n, 3, size, size), generator=gen, device=dev,
                           dtype=torch.uint8)
    u = torch.rand(n, generator=gen, device=dev)
    persons = (1 + (m * u ** 3).floor()).clamp(max=m)
    present = torch.arange(m, device=dev)[None] < persons[:, None]
    centre = torch.rand((n, m, 1, 2), generator=gen, device=dev) * q
    scale = 4 + 12 * torch.rand((n, m, 1, 1), generator=gen, device=dev)
    xy = (centre + torch.randn((n, m, k, 2), generator=gen, device=dev) * scale).round()
    xy = xy.clamp(0, q - 1)
    vis = (torch.rand((n, m, k), generator=gen, device=dev) < p["visible"]) & present[..., None]
    joints = torch.cat([xy, 2 * vis[..., None].float()], -1).to(torch.int32)
    crowd = torch.rand(n, generator=gen, device=dev) < p["crowd"]
    corner = torch.rand((n, 2), generator=gen, device=dev) * q * 0.75
    extent = (0.1 + 0.2 * torch.rand((n, 2), generator=gen, device=dev)) * q
    heatmaps, masks = [], []
    for res in (q, 2 * q):
        f = res / q
        grid = torch.arange(res, device=dev, dtype=torch.float32)
        hm = torch.zeros((n, k, res, res), device=dev)
        for person in range(m):
            jx, jy = xy[:, person, :, 0] * f, xy[:, person, :, 1] * f  # [N, K]
            w = vis[:, person].float()
            gx = torch.exp(-(grid - jx[..., None]) ** 2 / (2 * sigma ** 2))
            gy = torch.exp(-(grid - jy[..., None]) ** 2 / (2 * sigma ** 2)) * w[..., None]
            hm = torch.maximum(hm, gy[..., :, None] * gx[..., None, :])
        lo, hi = corner * f, (corner + extent) * f
        ys, xs = grid[None, :, None], grid[None, None, :]
        inside = ((ys >= lo[:, 1, None, None]) & (ys < hi[:, 1, None, None])
                  & (xs >= lo[:, 0, None, None]) & (xs < hi[:, 0, None, None]))
        masks.append(torch.where(inside & crowd[:, None, None], 0.0, 1.0))
        heatmaps.append(hm)
    return {"images": images, "heatmaps": heatmaps, "masks": masks, "joints": joints}


class Cell(TrainCell):
    MODEL = "HigherHRNet"

    @staticmethod
    def make_batches(seed: int, config: dict, p: dict, dev) -> list:
        """The cell's ``pool`` batches, made on ``dev`` from the seed."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed % 2**63)
        return [keypoints_batch(gen, dev, p["batch"], p["size"], config["num_kpts"], p)
                for _ in range(p["pool"])]

    def build(self, c: dict, dev):
        from human_pose_tpu_torch.models import HigherHRNet

        return HigherHRNet(num_kpts=c["num_kpts"], C=c["C"],
                           num_blocks_per_stage=tuple(c["num_blocks_per_stage"]),
                           num_units=c["num_units"],
                           num_deconv_resid_blocks=c["num_deconv_resid_blocks"], device=dev)

    def step(self, state, batch: dict, lr) -> dict:
        from human_pose_tpu_torch.train import steps

        return steps.keypoints_train_step(state, batch, lr)[1]
