"""Model export CLI (port of human_pose_tpu/bin/export.py; counterpart of the
reference's ONNX export surface, reference src/base/model.py:66-75):
the eval forward as a ``torch.export`` program, in the config's dtype (the
yaml's accelerator "tpu" means bfloat16, as in the JAX package), plus the
flat-weights npz in the JAX package's layout. Runs on the card unless
``--trainer.accelerator=cpu``.

    python -m human_pose_tpu_torch.bin.export --config=experiments/keypoints/higher_hrnet_32.yaml \
        [--task=keypoints|classification] [--inference.ckpt_path=...] \
        [--out=exports] [--input_size=512]

Writes <out>/<architecture>.pt2 and <out>/<architecture>.weights.npz.
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..loggers.pylogger import log
from ..utils.argv import parse_flags
from ..utils.export import export_program, export_weights_npz


def main(argv: list[str] | None = None) -> tuple[Path, Path]:
    """Export on ``argv`` (default ``sys.argv[1:]``); returns the program's
    and the npz's paths."""
    flags, passthrough = parse_flags(
        sys.argv[1:] if argv is None else list(argv),
        {
            "config": "experiments/keypoints/higher_hrnet_32.yaml",
            "out": "exports", "input_size": 0, "task": "",
        },
        allow_passthrough=True,  # --a.b.c=v config overrides
    )
    cfg_path, out, task = flags["config"], flags["out"], flags["task"]
    input_size = flags["input_size"] or None

    if not task:  # infer from the config path, default keypoints
        task = "classification" if "classification" in cfg_path else "keypoints"
    if task == "classification":
        from ..configs.classification import ClassificationConfig as ConfigClass
    else:
        from ..configs.keypoints import KeypointsConfig as ConfigClass

    cfg_dict = ConfigClass.from_yaml_to_dict(cfg_path, passthrough)
    cfg_dict.setdefault("setup", {})["is_train"] = False
    cfg = ConfigClass.from_dict(cfg_dict)
    infer = cfg.create_inference_model()
    model = infer.model
    size = input_size or cfg.inference.input_size

    arch = cfg.setup.architecture or type(model).__name__
    out_dir = Path(out)
    program = out_dir / f"{arch}.pt2"
    weights = out_dir / f"{arch}.weights.npz"
    export_program(model, (3, size, size), program, dtype=infer.dtype)
    export_weights_npz(model, weights)
    log.info(f"export complete: {out_dir}/{arch}.(pt2|weights.npz)")
    return program, weights


if __name__ == "__main__":
    main()
