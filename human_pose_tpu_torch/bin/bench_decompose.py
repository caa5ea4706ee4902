"""Headline-bench decomposition: forward vs decode, best vs worst case (port
of human_pose_tpu/bin/bench_decompose.py).

Times each stage of the headline pipeline (HigherHRNet-W32 with a bfloat16
forward, then the dense associative-embedding decode at det_thr 0.05,
tag_thr 0.5, 30 people) separately on the card:

  forward        the model's outputs only
  decode_sparse  ``decode_batch`` on GT-like maps (a few clean gaussian
                 peaks a joint): the regime of a trained model
  decode_noise   ``decode_batch`` on uniform-noise heatmaps and unit-normal
                 tags: the adversarial case for the AE grouping (every NMS
                 survivor is a candidate, the Hungarian runs maximal
                 augmenting paths)
  e2e            forward, then decode of its outputs

    python -m human_pose_tpu_torch.bin.bench_decompose [--batch=8] [--iters=10] [--size=512]
        [--device=cuda]  # --device=cpu runs the plain PyTorch path

Weights from ``init_flax_default_`` (seed 0), images seeded standard normal
in bfloat16, maps drawn from seeded ``torch.Generator``s on the host (the
draws do not depend on the device). Each stage runs ``iters`` iterations
once to warm up, then ``iters`` iterations launched back to back with one
synchronisation at the end, over which the host wall (and, on the card,
CUDA events) is read; iteration ``i`` perturbs the input by ``i * 1e-4``
(images) or ``i * 1e-6`` (maps). The decode's own host syncs in each
iteration are part of what is timed. A NaN in the accumulated sum raises.

Prints one JSON line per stage: {"stage", "ms_per_img", "img_per_s",
"platform"} and, on the card, "stream_ms_per_img": the stream's time
between two CUDA events recorded at the window's ends, an image. That is
wall time on the card's clock, not the time its kernels were busy: it
equals the host wall whenever the host holds the card back.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import HigherHRNet, init_flax_default_
from ..ops import decode_batch
from ..utils.argv import parse_flags

K = 17
N_PERSONS = 4  # persons of a sparse map
SIGMA = 8.0  # their gaussians' sigma in pixels of the map
DECODE = {"max_num_people": 30, "det_thr": 0.05, "tag_thr": 0.5}
STAGES = ("forward", "decode_sparse", "decode_noise", "e2e")


def sparse_heatmaps(cy: torch.Tensor, cx: torch.Tensor, tags: torch.Tensor, h: int, w: int):
    """GT-like maps from given centres: for each (image, joint) the max over
    persons of a ``SIGMA`` gaussian at ``(cy, cx)`` (``[B, P, K]`` pixels),
    and the tags ``[B, K, h, w]`` (unit normal) scaled by 0.1. Returns
    ``(heatmaps, tags)``, both ``[B, K, h, w]`` float32 on ``cy``'s device."""
    ky = torch.arange(h, dtype=torch.float32, device=cy.device)[:, None]
    kx = torch.arange(w, dtype=torch.float32, device=cy.device)[None, :]
    hm = None
    for p in range(cy.shape[1]):
        d2 = (ky - cy[:, p, :, None, None]) ** 2 + (kx - cx[:, p, :, None, None]) ** 2
        peak = torch.exp(-d2 / (2 * SIGMA**2))
        hm = peak if hm is None else torch.maximum(hm, peak)
    return hm, tags * 0.1


def sparse_maps(gen: torch.Generator, batch: int, size: int, device) -> tuple:
    """``sparse_heatmaps`` of ``N_PERSONS`` persons a joint, centres
    uniform in [0.1, 0.9) of ``size`` per joint, drawn from ``gen``."""
    lo, span = 0.1 * size, 0.8 * size
    cy = torch.rand((batch, N_PERSONS, K), generator=gen) * span + lo
    cx = torch.rand((batch, N_PERSONS, K), generator=gen) * span + lo
    tags = torch.randn((batch, K, size, size), generator=gen)
    return sparse_heatmaps(cy.to(device), cx.to(device), tags.to(device), size, size)


def noise_maps(gen: torch.Generator, batch: int, size: int, device) -> tuple:
    """Uniform [0, 1) heatmaps at 1/4 and 1/2 of ``size`` and unit-normal
    tags at 1/4, drawn from ``gen``: ``(quarter, half, tags)``."""
    hq, hh = size // 4, size // 2
    quarter = torch.rand((batch, K, hq, hq), generator=gen)
    half = torch.rand((batch, K, hh, hh), generator=gen)
    tags = torch.randn((batch, K, hq, hq), generator=gen)
    return quarter.to(device), half.to(device), tags.to(device)


def bench_maps(batch: int, size: int, device) -> dict:
    """The two decode stages' maps, ``{stage: (quarter, half, tags)}``: the
    sparse quarter stage and its tags from seed 1, the sparse half stage
    from seed 2, the noise maps from seed 3 (the JAX package's keys)."""
    sp_q, tg_q = sparse_maps(torch.Generator().manual_seed(1), batch, size // 4, device)
    sp_h, _ = sparse_maps(torch.Generator().manual_seed(2), batch, size // 2, device)
    return {"decode_sparse": (sp_q, sp_h, tg_q),
            "decode_noise": noise_maps(torch.Generator().manual_seed(3), batch, size, device)}


def decode_maps(quarter, half, tags, size: int, jitter: float = 0.0):
    """``decode_batch`` of two heatmap stages and quarter-resolution tags at
    input ``size`` with ``jitter`` added to both stages; returns its
    ``(joints, scores, valid)``."""
    return decode_batch([quarter + jitter, half + jitter], [tags], (size, size), **DECODE)


def forward(model, images, i: int):
    """The model's ``(heatmaps, tags)`` on ``images + bf16(i) * bf16(1e-4)``
    under bfloat16 autocast."""
    step = float(torch.tensor(i, dtype=torch.bfloat16) * torch.tensor(1e-4, dtype=torch.bfloat16))
    with torch.no_grad(), torch.autocast(images.device.type, dtype=torch.bfloat16):
        return model(images + step)


def map_jitter(i: int) -> float:
    """``float32(i) * float32(1e-6)``, the maps' perturbation of iteration ``i``."""
    return float(np.float32(i) * np.float32(1e-6))


def timed(fn, iters: int, device: torch.device) -> tuple:
    """Run ``fn(i)`` (a 0-dim tensor) for ``i < iters`` once to warm up,
    then again with one synchronisation at the end. Returns the second
    pass's host seconds and the ms between CUDA events recorded at its two
    ends (stream wall time, idle gaps included; None on the CPU).
    Raises if either pass's sum is NaN."""
    def run():
        acc = torch.zeros((), device=device)
        for i in range(iters):
            acc = acc + fn(i)
        return acc

    def check(acc: float) -> None:
        if acc != acc:
            raise FloatingPointError("NaN in the benched computation")

    check(float(run()))
    events = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    acc = run()
    if events:
        events[1].record()
    total = float(acc)
    dt = time.perf_counter() - t0
    check(total)
    return dt, events[0].elapsed_time(events[1]) if events else None


def stage_fns(batch: int, size: int, device) -> dict:
    """``{stage: fn}`` in ``STAGES`` order, ``fn(i)`` one iteration of the
    stage returning a 0-dim tensor: the seeded W32 model in eval mode on
    seeded bfloat16 images, and ``bench_maps``."""
    model = HigherHRNet(num_kpts=K, C=32, device=device)
    init_flax_default_(model, torch.Generator().manual_seed(0)).eval()
    images = torch.randn((batch, 3, size, size), generator=torch.Generator().manual_seed(0))
    images = images.to(device, torch.bfloat16)

    def fwd(i):
        hms, tags = forward(model, images, i)
        return hms[-1].sum() + tags.sum() * 0

    def e2e(i):
        hms, tags = forward(model, images, i)
        return decode_batch(hms, [tags], (size, size), **DECODE)[1].sum()

    fns = {"forward": fwd}
    for stage, maps in bench_maps(batch, size, device).items():
        fns[stage] = lambda i, maps=maps: decode_maps(*maps, size, map_jitter(i))[1].sum()
    fns["e2e"] = e2e
    return fns


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the four stages on ``argv`` (default ``sys.argv[1:]``); prints
    and returns their records."""
    args, _ = parse_flags(sys.argv[1:] if argv is None else list(argv),
                          {"batch": 8, "iters": 10, "size": 512, "device": "cuda"})
    dev = resolve_device(args["device"])
    batch, iters, size = args["batch"], args["iters"], args["size"]
    if iters < 1:
        raise SystemExit("--iters must be at least 1")
    platform = "gpu" if dev.type == "cuda" else "cpu"
    records = []

    def report(stage: str, fn) -> None:
        dt, stream_ms = timed(fn, iters, dev)
        n = batch * iters
        rec = {"stage": stage, "ms_per_img": dt / n * 1e3, "img_per_s": n / dt, "platform": platform}
        if stream_ms is not None:
            rec["stream_ms_per_img"] = stream_ms / n
        print(json.dumps(rec), flush=True)
        records.append(rec)

    for stage, fn in stage_fns(batch, size, dev).items():
        report(stage, fn)
    return records


if __name__ == "__main__":
    main()
