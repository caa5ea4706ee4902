"""COCO val2017 keypoint evaluation CLI (port of
human_pose_tpu/bin/eval_keypoints.py).

Counterpart of reference src/keypoints/bin/eval.py: builds the inference
model, runs the whole val split, writes ``val2017_results.json`` +
``config.yaml`` + ``coco_output.txt`` (the AP table) into
``evaluation_results/<timestamp>/``.

Usage:
    python -m human_pose_tpu_torch.bin.eval_keypoints \
        --config=experiments/keypoints/higher_hrnet_32.yaml \
        --inference.ckpt_path=... [--inference.use_flip=True] \
        [--inference.scales=[0.5,1,2]] [--limit=N] [--batch_size=N] [--sharded=true]

``--batch_size`` > 1 switches to the batched evaluator
(``inference/batched_eval.py``): shape-bucketed whole-batch forward + decode
with only the decoded joints copied to the host, the same detections as the
per-image loop. ``--sharded=true`` evaluates over the processes of a
torchrun launch (``parallel.setup_distributed``: NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--trainer.accelerator=cpu``), each on every ``world_size``-th
image with ``batch_size // world_size`` images a batch; rank 0 gathers the
detections and alone writes the three files and runs the COCO evaluation.
Without torchrun's environment it evaluates as one process. Runs on the
card unless ``--trainer.accelerator=cpu``.

    python -m torch.distributed.run --nproc_per_node=N -m human_pose_tpu_torch.bin.eval_keypoints \
        --config=... --batch_size=8 --sharded=true
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from ..configs.keypoints import KeypointsConfig
from ..data.coco import CocoKeypointsDataset
from ..inference.batched_eval import evaluate_dataset_batched, image_id_from_path, image_oks
from ..loggers.pylogger import log
from ..metrics.cocoeval import COCOKeypointsEval
from ..parallel import barrier, finalize_distributed, make_mesh, setup_distributed
from ..utils.files import load_json, save_json, save_yaml
from ..utils.utils import process_group_initialized


def evaluate_dataset(model, ds: CocoKeypointsDataset, limit: int = -1) -> list[dict]:
    """One image at a time through ``model.__call__`` (the reference's loop),
    with the per-image OKS logged."""
    from tqdm.auto import tqdm

    results = []
    oks_values = []
    n = len(ds) if limit <= 0 else min(limit, len(ds))
    pbar = tqdm(range(n), desc="evaluating val2017")
    for idx in pbar:
        image = ds.load_image(idx)
        annot = ds.load_annot(idx)
        result = model(image, annot=annot)
        # per-image OKS like the reference (results.py:300-304)
        oks = image_oks(result)
        if oks >= 0:
            oks_values.append(oks)
            pbar.set_postfix({"OKS": f"{oks:.2f}", "mean": f"{np.mean(oks_values):.3f}"})
        image_id = image_id_from_path(ds.images_filepaths[idx], fallback=idx)
        results.extend(result.to_coco_detections(image_id))
    if oks_values:
        log.info(f"mean image OKS over {len(oks_values)} images: {np.mean(oks_values):.4f}")
    return results


def main(argv: list[str] | None = None) -> Path | None:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    output directory (None on the ranks other than 0 of a sharded run)."""
    argv = sys.argv[1:] if argv is None else argv
    cfg_path = "experiments/keypoints/higher_hrnet_32.yaml"
    limit = -1
    batch_size = 1
    sharded = False
    for tok in argv:
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
        if tok.startswith("--limit="):
            limit = int(tok.split("=", 1)[1])
        if tok.startswith("--batch_size="):
            batch_size = int(tok.split("=", 1)[1])
        if tok.startswith("--sharded="):
            sharded = tok.split("=", 1)[1].lower() in ("1", "true", "yes")
    if sharded and batch_size <= 1:
        raise SystemExit(
            "--sharded=true requires --batch_size>1 (a multiple of the device "
            "count): distributed eval shards whole batches over the mesh"
        )
    cfg_dict = KeypointsConfig.from_yaml_to_dict(cfg_path, argv)
    cfg_dict.setdefault("setup", {})["is_train"] = False
    if not sharded:
        return _evaluate(KeypointsConfig.from_dict(cfg_dict), batch_size, limit)
    accelerator = (cfg_dict.get("trainer") or {}).get("accelerator")
    setup_distributed("cpu" if accelerator == "cpu" else "cuda")
    try:
        cfg = KeypointsConfig.from_dict(cfg_dict)
        mesh = make_mesh() if process_group_initialized() else None
        out_dir = _evaluate(cfg, batch_size, limit, mesh)
        barrier("eval_keypoints")
        return out_dir
    finally:
        finalize_distributed()


def _evaluate(cfg: KeypointsConfig, batch_size: int, limit: int, mesh=None) -> Path | None:
    """Evaluate the val split and, on rank 0, write the three files; the
    output directory, or None on the other ranks of ``mesh``."""
    cfg.apply_cudnn()
    model = cfg.create_inference_model()
    ds = CocoKeypointsDataset(cfg.dataloader.val_ds.root, cfg.dataloader.val_ds.split,
                              transform=None)
    main_process = mesh is None or mesh.rank == 0
    if main_process:
        out_dir = Path("evaluation_results") / time.strftime("%Y-%m-%d_%H-%M-%S")
        out_dir.mkdir(parents=True, exist_ok=True)

    if batch_size > 1:
        detections = evaluate_dataset_batched(model, ds, batch_size=batch_size, limit=limit,
                                              mesh=mesh, progress=main_process)
    else:
        detections = evaluate_dataset(model, ds, limit)
    if not main_process:
        return None
    save_json(detections, out_dir / "val2017_results.json")
    save_yaml(cfg.to_dict(), out_dir / "config.yaml")

    gt_path = Path(cfg.dataloader.val_ds.root) / "annotations" / (
        f"person_keypoints_{cfg.dataloader.val_ds.split}.json"
    )
    evaluator = COCOKeypointsEval(load_json(gt_path), detections)
    evaluator.evaluate()
    summary = evaluator.summarize()
    (out_dir / "coco_output.txt").write_text(summary)
    log.info("\n" + summary)
    print(summary)
    return out_dir


if __name__ == "__main__":
    main()
