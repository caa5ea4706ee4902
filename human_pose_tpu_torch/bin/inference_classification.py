"""Classification inference CLI (port of
human_pose_tpu/bin/inference_classification.py; counterpart of reference
src/classification/bin/inference.py): ``--mode val`` (the first 8 images of
the val split, labels from its classes) or ``--mode custom --dirpath=DIR``,
each image's top-5 probability overlay written to
``inference_results/classification/``. Runs on the card unless
``--trainer.accelerator=cpu``.

Usage:
    python -m human_pose_tpu_torch.bin.inference_classification \
        --config=experiments/classification/hrnet_32.yaml [--inference.ckpt_path=...] \
        [--mode=val | --mode=custom --dirpath=DIR]
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..configs.classification import ClassificationConfig
from ..data.imagenet import ImagenetClassificationDataset
from ..loggers.pylogger import log

IMG_EXTS = {".jpg", ".jpeg", ".png", ".JPEG", ".JPG"}
OUT_DIR = Path("inference_results") / "classification"


def main(argv: list[str] | None = None) -> list[Path]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    plots it wrote."""
    import cv2

    argv = sys.argv[1:] if argv is None else list(argv)
    cfg_path = "experiments/classification/hrnet_32.yaml"
    mode, dirpath = "val", None
    for tok in argv:
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
        if tok.startswith("--mode="):
            mode = tok.split("=", 1)[1]
        if tok.startswith("--dirpath="):
            dirpath = Path(tok.split("=", 1)[1])
    cfg_dict = ClassificationConfig.from_yaml_to_dict(cfg_path, argv)
    cfg_dict.setdefault("setup", {})["is_train"] = False
    cfg = ClassificationConfig.from_dict(cfg_dict)
    cfg.apply_cudnn()

    labels = None
    if mode == "val":
        ds = ImagenetClassificationDataset(cfg.dataloader.val_ds.root, cfg.dataloader.val_ds.split)
        labels = [ds.idx_to_label[i] for i in range(len(ds.idx_to_label))]
        paths = [Path(p) for p, _ in ds.samples[:8]]
    elif mode == "custom":
        if dirpath is None:
            raise ValueError("--mode=custom requires --dirpath")
        paths = sorted(p for p in dirpath.iterdir() if p.suffix in IMG_EXTS)
    else:
        raise ValueError(f"--mode must be val or custom, got {mode!r}")

    model = cfg.create_inference_model(labels=labels)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    written = []
    for p in paths:
        img = cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
        result = model(img)
        for name, plot in result.plot().items():
            out = OUT_DIR / f"{p.stem}_{name}.jpg"
            cv2.imwrite(str(out), cv2.cvtColor(plot, cv2.COLOR_RGB2BGR))
            written.append(out)
        log.info(f"{p.name}: top-1 idx {int(result.probs.argmax())}")
    return written


if __name__ == "__main__":
    main()
