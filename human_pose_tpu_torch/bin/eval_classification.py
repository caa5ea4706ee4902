"""ImageNet evaluation CLI (port of human_pose_tpu/bin/eval_classification.py;
the reference's src/classification/bin/eval.py is an empty stub).

Top-1 and top-5 error of the inference model over the val split.
``--batch_size=N`` runs N center crops a forward (the tail batch padded by
repeating its last image, the padded rows dropped); ``--limit=N`` truncates
the split. Prints the stats dict last. Runs on the card unless
``--trainer.accelerator=cpu``.

Usage:
    python -m human_pose_tpu_torch.bin.eval_classification \
        --config=experiments/classification/hrnet_32.yaml \
        [--inference.ckpt_path=...] [--batch_size=N] [--limit=N]
"""

from __future__ import annotations

import sys

import numpy as np

from ..configs.classification import ClassificationConfig
from ..loggers.pylogger import log


def evaluate_split(model, ds, total: int, batch_size: int = 1) -> dict:
    """Top-1 and top-5 error over ``ds[:total]``, one forward a batch; the
    top 5 by a stable sort of the host probabilities (ties to the lowest
    index)."""
    from tqdm.auto import tqdm

    top1_err, top5_err, n = 0, 0, 0
    for start in tqdm(range(0, total, batch_size), desc="ImageNet val"):
        idxs = list(range(start, min(start + batch_size, total)))
        xs = np.stack([model.transform.inference(ds.load_image(i)) for i in idxs])
        labels = np.array([ds.samples[i][1] for i in idxs])
        if len(idxs) < batch_size:  # pad the tail to the batch shape
            xs = np.concatenate([xs, np.repeat(xs[-1:], batch_size - len(idxs), axis=0)])
        probs = model.probs(model.to_device(xs))[: len(idxs)].cpu().numpy()
        top5 = np.argsort(-probs, axis=1, kind="stable")[:, :5]
        top1_err += int((top5[:, 0] != labels).sum())
        top5_err += int((top5 != labels[:, None]).all(axis=1).sum())
        n += len(idxs)
    return {"top1_error": top1_err / n, "top5_error": top5_err / n, "n": n}


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    stats it prints."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg_path = "experiments/classification/hrnet_32.yaml"
    limit = -1
    batch_size = 1
    for tok in argv:
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
        if tok.startswith("--limit="):
            limit = int(tok.split("=", 1)[1])
        if tok.startswith("--batch_size="):
            batch_size = int(tok.split("=", 1)[1])
    cfg_dict = ClassificationConfig.from_yaml_to_dict(cfg_path, argv)
    cfg_dict.setdefault("setup", {})["is_train"] = False
    cfg = ClassificationConfig.from_dict(cfg_dict)
    cfg.apply_cudnn()
    dm = cfg.create_datamodule()
    model = cfg.create_inference_model()

    ds = dm.val_ds
    total = len(ds) if limit <= 0 else min(limit, len(ds))
    stats = evaluate_split(model, ds, total, batch_size=batch_size)
    log.info(f"top-1 error: {stats['top1_error']:.4f}, top-5 error: {stats['top5_error']:.4f} "
             f"({stats['n']} images)")
    print(stats)
    return stats


if __name__ == "__main__":
    main()
