"""Serving benchmark: closed-loop concurrent load on the dynamic batcher
(port of human_pose_tpu/bin/bench_serve.py).

Measures what a deployment cares about — per-request latency percentiles and
aggregate throughput — for the keypoints inference server
(inference/serving.py) on the card, bypassing HTTP (threaded submit() calls;
the HTTP layer is covered by the serving tests).

    python -m human_pose_tpu_torch.bin.bench_serve [--concurrency=16] [--requests=8]
        [--input_size=512] [--max_batch=16] [--max_wait_ms=5] [--tiny]
        [--compact_inputs=true]  # uint8 upload + on-device normalize
        [--device=cuda]          # --device=cpu runs the plain PyTorch path

HigherHRNet-W32 with a bfloat16 forward (``--tiny``: a C=8 net in float32),
seeded random weights (``init_flax_default_``, seed 0). Prints one JSON line:
{p50_ms, p95_ms, p99_ms, throughput_rps, mean_batch_size, platform, ...}.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import torch

from ..utils.argv import parse_flags


def main(argv: list[str] | None = None) -> dict:
    """Run the benchmark on ``argv`` (default ``sys.argv[1:]``); prints and
    returns its record."""
    args, _ = parse_flags(
        sys.argv[1:] if argv is None else list(argv),
        {
            "concurrency": 16, "requests": 8, "input_size": 512,
            "max_batch": 16, "max_wait_ms": 5.0, "tiny": False,
            "compact_inputs": False, "device": "cuda",
        },
    )

    from ..inference import InferenceKeypointsModel
    from ..inference.serving import BatchedKeypointsPredictor, DynamicBatcher
    from ..models import HigherHRNet, init_flax_default_

    device = args["device"]
    if args["tiny"]:
        model = HigherHRNet(
            num_kpts=17, C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1,
            num_deconv_resid_blocks=1, device=device,
        )
        dtype = torch.float32
    else:
        model = HigherHRNet(num_kpts=17, C=32, device=device)
        dtype = torch.bfloat16
    init_flax_default_(model, torch.Generator().manual_seed(0)).eval()
    size = args["input_size"]
    im = InferenceKeypointsModel(
        model, input_size=size, max_num_people=30,
        compact_inputs=args["compact_inputs"], dtype=dtype, device=device,
    )
    batcher = DynamicBatcher(
        BatchedKeypointsPredictor(im),
        max_batch=args["max_batch"], max_wait_ms=args["max_wait_ms"],
    )

    rs = np.random.RandomState(0)
    # square raw images -> one shape bucket (the deployment-steady state)
    images = [
        (rs.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(4)
    ]
    # warm up EVERY power-of-two batch bucket the batcher can form, so the
    # measurement window times serving, not cuDNN's plans or kernel builds
    batcher.predictor.warmup(images[0], args["max_batch"])
    lat, wall = closed_loop(batcher, images, args["concurrency"], args["requests"])
    batcher.close()
    record = {
        "requests": len(lat),
        "concurrency": args["concurrency"],
        "input_size": size,
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
        "throughput_rps": round(len(lat) / wall, 2),
        "mean_batch_size": batcher.stats()["mean_batch_size"],
        "platform": "gpu" if im.device.type == "cuda" else "cpu",
    }
    print(json.dumps(record), flush=True)
    return record


def closed_loop(batcher, images: list, concurrency: int, requests: int) -> tuple[np.ndarray, float]:
    """``concurrency`` client threads, each submitting ``requests`` images
    one after another (image ``(i + r) % len(images)``). Returns the sorted
    latencies in ms and the wall seconds of the whole load."""
    latencies: list[float] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        for r in range(requests):
            t0 = time.perf_counter()
            batcher.submit(images[(i + r) % len(images)], timeout=600.0)
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                latencies.append(dt)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return np.sort(np.asarray(latencies)), wall


if __name__ == "__main__":
    main()
