"""Offline batched inference: one caller sends batches of frames back to
back through the program's keypoints inference model and waits for each
batch's joints, scores and valid flags on the host.

Parameters: ``batch`` frames a batch of ``height`` x ``width`` uint8 model
inputs (a frame already resized into its 64-aligned bucket), a ``pool`` of
distinct batches made from the seed on the host and cycled, ``flip`` (the
flip test), ``det_thr``, ``tag_thr``, ``max_people``; ``keep_every`` and
``keep_max`` choose which frames the check holds: one frame of every
``keep_every``-th batch from an offset drawn from the seed, at most
``keep_max``, at the positions in the batch of a permutation drawn from
the seed, taken in turn (so that they spread over the batch);
``trace_units`` batches are traced. A held frame's maps are copied to the
host once its batch's latency is taken.

The window's unit: ``to_device``, ``forward_scale``, ``decode_masked``, and
the copies of joints, scores and valid to the host. Its latency is that
unit's host wall time.

The check, after the window: the reference network in float32 (TF32 off)
recomputes each held frame's heatmaps and tags from the same weights and
frame (``fwd_err``: the largest relative L2 error of a map), and the
reference decode decodes the program's own maps of that frame
(``decode_mismatch``: joints, valid flags and person scores that differ).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from gpubench import counts
from gpubench.harness import arch_of
from gpubench.reference.decode import decode
from gpubench.reference.nets import Net, spec
from gpubench.reference.pose import maps
from gpubench.weights import make_weights

REFINE = ("refine_scan_kernel", "refine_merge_kernel")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def decode_mismatches(pj, ps, pv, rj, rs, rv) -> int:
    """Valid flags, joint rows (x, y, score, tags: exact) and person scores
    (a float32 mean of K scores, summed in another order: within 1e-5 of the
    person's largest joint score) that differ."""
    n = int((pv != rv).sum())
    same = (pj == rj) | (np.isnan(pj) & np.isnan(rj))
    n += int((~same.all(-1)).sum())
    tol = 1e-5 * np.maximum(np.abs(rj[..., 2]).max(-1), 1e-30)
    return n + int((~(np.abs(ps - rs) <= tol)).sum())


def make_pool(seed: int, p: dict) -> list:
    """The cell's ``pool`` host batches of uint8 frames ``[B, H, W, 3]``."""
    rng = np.random.default_rng([seed % 2**63, 0])
    return [rng.integers(0, 256, (p["batch"], p["height"], p["width"], 3), dtype=np.uint8)
            for _ in range(p["pool"])]


def frame(pool: list, b: int, k: int, device) -> torch.Tensor:
    """Frame ``k`` of pool batch ``b`` as ``[1, 3, H, W]`` uint8 on ``device``."""
    return torch.from_numpy(pool[b][k:k + 1]).permute(0, 3, 1, 2).to(device)


def maps_error(avg, tags, r_avg, r_tags) -> float:
    """The largest relative L2 error of a frame's heatmaps and tag maps."""
    return max([rel_l2(avg, r_avg)] + [rel_l2(t, r) for t, r in zip(tags, r_tags)])


class Cell:
    def __init__(self, ctx):
        from human_pose_tpu_torch.inference.models import InferenceKeypointsModel
        from human_pose_tpu_torch.models import HigherHRNet
        from human_pose_tpu_torch.ops import cuda_decode, cuda_match

        from gpubench.harness import Laps

        lap = Laps()
        p, c = ctx.params, ctx.config
        if c["model"] != "HigherHRNet":
            raise ValueError(f"frames: a keypoints model is decoded, not {c['model']}")
        self.ctx, self.p = ctx, p
        self.arch = arch_of(c)
        self.hw = (p["height"], p["width"])
        self.launches = {"refine_scan_kernel": lambda: cuda_decode.refine_argmax_batch.launches,
                         "match_kernel": lambda: cuda_match.match_by_tag_batched.launches}
        dev = ctx.device
        model = HigherHRNet(num_kpts=c["num_kpts"], C=c["C"],
                            num_blocks_per_stage=tuple(c["num_blocks_per_stage"]),
                            num_units=c["num_units"],
                            num_deconv_resid_blocks=c["num_deconv_resid_blocks"], device=dev)
        weights = make_weights(spec(self.arch, self.hw), ctx.seed, dev)
        model.load_state_dict(weights, strict=True)
        del weights
        model.eval()
        self.model = InferenceKeypointsModel(
            model, det_thr=p["det_thr"], tag_thr=p["tag_thr"], use_flip=p["flip"],
            input_size=c["input_size"], max_num_people=p["max_people"], compact_inputs=True,
            dtype=getattr(torch, c["precision"]), device=dev)
        lap("model and weights")
        self.pool = make_pool(ctx.seed, p)
        lap("frames")
        self.keep_rng = np.random.default_rng([ctx.seed % 2**63, 1])
        self.keep_offset = int(self.keep_rng.integers(p["keep_every"]))
        self.keep_at = self.keep_rng.permutation(p["batch"])
        self.kept = []
        self.images = 0
        self.failed = 0
        self.bound_s = 0.0
        for i in range(2):  # every shape the window uses; the first builds the kernels
            self._batch(i)
            lap(f"warm-up batch {i}")

    def _batch(self, i: int):
        xs = self.pool[i % len(self.pool)]
        with record_function("to_device"):
            x = self.model.to_device(xs)
        with record_function("forward"):
            avg, tags = self.model.forward_scale(x, self.hw)
        with record_function("decode"):
            joints, scores, valid, _ = self.model.decode_masked(avg, tags, self.hw, 1.0)
        with record_function("to_host"):
            out = joints.cpu().numpy(), scores.cpu().numpy(), valid.cpu().numpy()
        return avg, tags, out

    def unit(self, i: int) -> float:
        t = time.perf_counter()
        avg, tags, (j, s, v) = self._batch(i)
        lat = time.perf_counter() - t
        self.images += j.shape[0]
        self.failed += int((~np.isfinite(j).all((1, 2, 3))).sum())
        p = self.p
        n = len(self.kept)
        if i % p["keep_every"] == self.keep_offset and n < p["keep_max"]:
            k = int(self.keep_at[n % len(self.keep_at)])
            self.kept.append((i % len(self.pool), k, avg[k].cpu(), [t[k].cpu() for t in tags],
                              j[k], s[k], v[k]))
        return lat

    def drain(self) -> None:
        """Each unit ends on the host: nothing is in flight."""

    def end_to_end(self, ctx) -> dict:
        from gpubench.harness import p95

        return {"infer_img_per_s": self.images / ctx.window_s,
                "infer_p95_ms": p95(ctx.latencies_s) * 1e3}

    @property
    def attempted(self) -> int:
        return self.images

    def trace(self, ctx) -> None:
        from gpubench.trace import profile_units

        b, k = self.p["batch"], self.arch["num_kpts"]
        e = 2 if self.p["flip"] else 1
        ctx.extra["flops_per_unit"] = counts.flops(self.arch, self.hw) * e * b
        hw = self.hw[0] * self.hw[1]

        def unit(i):
            _, _, (j, _, _) = self._batch(i)
            if i == 0:  # untraced: each attempt starts the sum again
                self.bound_s = 0.0
            else:
                det = (j[..., 2] > 0).any(-1)  # [B, P]: persons the refine scans
                last = np.where(det, np.arange(det.shape[1])[None], -1).max(1) + 1
                ms, _ = counts.refine_bound(b, k, e, hw, j.shape[1], int(last.sum()))
                self.bound_s += ms / 1e3

        ctx.trace = profile_units(unit, self.p["trace_units"], self.launches)
        ctx.extra["refine_bound_s"] = self.bound_s
        ctx.extra["refine_kernels"] = REFINE

    def release(self) -> None:
        del self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, ctx) -> list:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        net = Net(self.arch, make_weights(spec(self.arch, self.hw), ctx.seed, ctx.device))
        p = self.p
        fwd_err, mismatch = (0.0, 0) if self.kept else (float("inf"), 0)
        for b, k, avg, tags, j, s, v in self.kept:
            avg, tags = avg.to(ctx.device), [t.to(ctx.device) for t in tags]
            r_avg, r_tags = maps(net, frame(self.pool, b, k, ctx.device), p["flip"], self.hw)
            fwd_err = max(fwd_err, maps_error(avg, tags, r_avg[0], [r[0] for r in r_tags]))
            rj, rs, rv = decode(avg, torch.stack(tags, 1), p["max_people"], p["det_thr"],
                                p["tag_thr"])
            mismatch += decode_mismatches(j, s, v, rj, rs, rv)
        lim = ctx.limits
        return [("fwd_err", fwd_err, lim["fwd_err"]),
                ("decode_mismatch", float(mismatch), lim["decode_mismatch"])]
