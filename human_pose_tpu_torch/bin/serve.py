"""Inference HTTP server with dynamic batching, keypoints or classification
(port of human_pose_tpu/bin/serve.py).

The reference has no serving path (offline CLIs only,
reference src/keypoints/bin/inference.py); this stands up one process
owning the card, coalescing concurrent POST /predict requests into batched
device calls (inference/serving.py). Runs on the card unless
``--trainer.accelerator=cpu``.

    python -m human_pose_tpu_torch.bin.serve --config=experiments/keypoints/higher_hrnet_32.yaml \
        --inference.ckpt_path=... [--task=keypoints|classification] \
        [--port=8000] [--max_batch=16] [--max_wait_ms=5] [--max_body_mb=64] \
        [--warmup=512x512,480x640]   # run these raw-image shape buckets before listening

    curl -X POST --data-binary @some.jpg localhost:8000/predict
    curl localhost:8000/healthz ; curl localhost:8000/stats

``--task`` defaults from the config path (like bin/export.py): keypoints
serves multi-person pose payloads, classification serves top-5 label/prob.
``--port=0`` binds a free port; the log line "serving ... on host:port"
names it.
"""

from __future__ import annotations

import signal
import sys
import threading

import numpy as np

from ..inference.serving import (
    BatchedClassificationPredictor,
    BatchedKeypointsPredictor,
    DynamicBatcher,
    make_server,
)
from ..loggers.pylogger import log
from ..utils.argv import parse_flags


def main(argv: list[str] | None = None) -> None:
    """Serve until SIGTERM or Ctrl-C on ``argv`` (default ``sys.argv[1:]``)."""
    flags, passthrough = parse_flags(
        sys.argv[1:] if argv is None else list(argv),
        {
            "config": "experiments/keypoints/higher_hrnet_32.yaml",
            "task": "", "host": "0.0.0.0", "port": 8000, "max_batch": 16,
            "max_wait_ms": 5.0, "warmup": "", "max_body_mb": 64,
        },
        allow_passthrough=True,  # --a.b.c=v config overrides
    )
    cfg_path, host, port = flags["config"], flags["host"], flags["port"]
    max_batch, max_wait_ms, warmup = (
        flags["max_batch"], flags["max_wait_ms"], flags["warmup"],
    )
    task = flags["task"] or (
        "classification" if "classification" in cfg_path else "keypoints"
    )
    if task == "classification":
        from ..configs.classification import ClassificationConfig as ConfigClass
    elif task == "keypoints":
        from ..configs.keypoints import KeypointsConfig as ConfigClass
    else:
        raise SystemExit(f"--task must be keypoints or classification, got {task!r}")

    cfg_dict = ConfigClass.from_yaml_to_dict(cfg_path, passthrough)
    cfg_dict.setdefault("setup", {})["is_train"] = False
    cfg = ConfigClass.from_dict(cfg_dict)
    cfg.apply_cudnn()
    model = cfg.create_inference_model()
    predictor = (
        BatchedClassificationPredictor(model)
        if task == "classification"
        else BatchedKeypointsPredictor(model)
    )
    batcher = DynamicBatcher(
        predictor, max_batch=max_batch, max_wait_ms=max_wait_ms
    )
    # run every power-of-two batch bucket of each requested raw shape so the
    # first real request never waits on cuDNN's plans or a kernel build
    for spec in filter(None, warmup.split(",")):
        h, w = (int(v) for v in spec.split("x"))
        predictor.warmup(np.zeros((h, w, 3), np.uint8), max_batch)
        log.info(f"warmed up {spec}")
    server = make_server(
        batcher, host=host, port=port,
        max_body_bytes=flags["max_body_mb"] * 1024 * 1024,
    )

    # graceful preemption: SIGTERM stops accepting connections and fails
    # queued requests fast instead of letting clients time out
    def _terminate(signum, frame):
        log.info("SIGTERM: shutting down server")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _terminate)

    log.info(
        f"serving {task} on {host}:{server.server_address[1]} "
        f"(max_batch={max_batch}, max_wait_ms={max_wait_ms}, device={model.device})"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
