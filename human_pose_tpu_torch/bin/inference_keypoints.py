"""Keypoints inference CLI: val split, images, a directory or a video (port
of human_pose_tpu/bin/inference_keypoints.py).

Counterpart of reference src/keypoints/bin/inference.py: ``--mode val|custom``
with ``--path`` dispatching to directory, image or video inference; persons
sorted by mean tag for stable colors in video. Plots go to
``inference_results/{val,custom,video}/``. Runs on the card unless
``--trainer.accelerator=cpu``.

Usage:
    python -m human_pose_tpu_torch.bin.inference_keypoints \
        --config=experiments/keypoints/higher_hrnet_32.yaml \
        --inference.ckpt_path=... --mode=custom --path=<image|dir|video>
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..configs.keypoints import KeypointsConfig
from ..data.coco import CocoKeypointsDataset
from ..data.video import InferenceVideoDataset, VideoProcessingResult
from ..inference.visualization import plot_connections
from ..loggers.pylogger import log
from ..utils.utils import elapsed_timer

IMG_EXTS = {".jpg", ".jpeg", ".png", ".JPEG", ".JPG"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv"}


def save_plots(result, out_dir: Path, stem: str) -> None:
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, img in result.plot().items():
        cv2.imwrite(str(out_dir / f"{stem}_{name}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def image_inference(model, paths: list[Path], out_dir: Path, annots=None) -> None:
    import cv2

    for i, p in enumerate(paths):
        img = cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
        annot = annots[i] if annots else None
        result = model(img, annot=annot)
        save_plots(result, out_dir, p.stem)
        log.info(f"processed {p.name} -> {out_dir}")


def video_inference(model, filepath: Path, out_dir: Path) -> None:
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / f"{filepath.stem}_out.mp4"

    def process_frame(frame: np.ndarray) -> VideoProcessingResult:
        with elapsed_timer() as elapsed:
            result = model(frame, annot=None)
        ms = elapsed() * 1000
        # stable person colors: sort by mean tag (reference inference.py:56-60)
        if len(result.kpts_tags):
            order = np.argsort(result.kpts_tags.mean(axis=(1, 2)))
            coords, scores = result.kpts_coords[order], result.kpts_scores[order]
        else:
            coords, scores = result.kpts_coords, result.kpts_scores
        frame_out = plot_connections(frame.copy(), coords, scores, model.limbs, thr=model.det_thr)
        h = 640
        w = int(frame_out.shape[1] * h / frame_out.shape[0])
        frame_out = cv2.resize(frame_out, (w, h))
        return VideoProcessingResult(
            speed_ms=ms, model_input_shape=model.model_input_shape, out_frame=frame_out
        )

    ds = InferenceVideoDataset(str(filepath), str(out_file))
    ds.run(process_frame)
    log.info(f"wrote {out_file}")


def main(argv: list[str] | None = None) -> None:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``)."""
    argv = sys.argv[1:] if argv is None else argv
    cfg_path = "experiments/keypoints/higher_hrnet_32.yaml"
    mode, path = "val", None
    for tok in argv:
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
        if tok.startswith("--mode="):
            mode = tok.split("=", 1)[1]
        if tok.startswith("--path="):
            path = Path(tok.split("=", 1)[1])
    cfg_dict = KeypointsConfig.from_yaml_to_dict(cfg_path, argv)
    cfg_dict.setdefault("setup", {})["is_train"] = False
    cfg = KeypointsConfig.from_dict(cfg_dict)
    cfg.apply_cudnn()
    model = cfg.create_inference_model()
    out_dir = Path("inference_results")

    if mode == "val":
        ds = CocoKeypointsDataset(cfg.dataloader.val_ds.root, cfg.dataloader.val_ds.split,
                                  transform=None)
        for idx in range(min(8, len(ds))):
            result = model(ds.load_image(idx), annot=ds.load_annot(idx))
            save_plots(result, out_dir / "val", Path(ds.images_filepaths[idx]).stem)
    elif path is not None and path.suffix in VIDEO_EXTS:
        video_inference(model, path, out_dir / "video")
    elif path is not None and path.is_dir():
        paths = sorted(p for p in path.iterdir() if p.suffix in IMG_EXTS)
        image_inference(model, paths, out_dir / "custom")
    elif path is not None:
        image_inference(model, [path], out_dir / "custom")
    else:
        raise SystemExit("--mode=custom requires --path=<image|dir|video>")


if __name__ == "__main__":
    main()
