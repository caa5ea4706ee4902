"""The port's COCO evaluation against the JAX package's, part 2: the trained
C=8 fixture (tests/ap_fixture.py's corpus, 10 images of 2 persons, and the
committed tests/data/ap_fixture_weights.npz, carried to JAX as a
reference-layout ``.pt`` that both packages' loaders read), flip on, input
64, through each package's ``bin.eval_keypoints`` on one yaml.

JAX's CLI runs once, batched at batch size 2 (its
``evaluate_dataset_batched``), its checkpoint template's shapes from
``jax.eval_shape`` (``_variables_from_shapes``). Against it: the port's batched evaluator per
image within tests/test_batched_eval.py's tolerances (coordinates < 0.5 px,
scores within 1e-3, equal person counts), and the port's CLI, serial and
batched: the same output files, detections with the same keys, the same
config, and an AP within 0.03 of JAX's (the band of test_torch_port_ap.py).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from human_pose_tpu.bin.eval_keypoints import main as jax_main
from human_pose_tpu.inference import models as jax_inference_models
from human_pose_tpu.metrics.cocoeval import COCOKeypointsEval as JaxCOCOKeypointsEval
from human_pose_tpu_torch.bin.eval_keypoints import main
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.data import CocoKeypointsDataset, prebake_annotations
from human_pose_tpu_torch.inference import evaluate_dataset_batched, load_inference_weights
from human_pose_tpu_torch.metrics import COCOKeypointsEval
from human_pose_tpu_torch.models import HigherHRNet
from tests.ap_fixture import K, WEIGHTS_PATH, build_corpus
from human_pose_tpu.utils.torch_interop import (
    is_torch_checkpoint, load_torch_state_dict, variables_from_torch,
)
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)
from tests.test_batched_eval import assert_detections_match

OUT_FILES = ["coco_output.txt", "config.yaml", "val2017_results.json"]




def _run_cli(run, work: Path, argv: list) -> Path:
    """Run a CLI with ``work`` as the working directory; its output dir."""
    work.mkdir()
    with contextlib.chdir(work):
        run(argv)
    (out,) = (work / "evaluation_results").iterdir()
    return out


def _jax_cli(argv):
    saved = sys.argv
    sys.argv = ["eval"] + argv
    try:
        jax_main()
    finally:
        sys.argv = saved


def _variables_from_shapes(model, ckpt_path, input_shape=(64, 64, 3)):
    """The JAX package's ``load_variables_from_ckpt`` for a reference
    ``.pt``, its template's shapes from ``jax.eval_shape`` rather than from
    an eager ``model.init`` (~30 s of per-op compiles on the CPU), whose
    values the checkpoint replaces leaf for leaf."""
    assert is_torch_checkpoint(ckpt_path)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *input_shape), getattr(model, "dtype", jnp.float32)),
        train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return variables_from_torch(load_torch_state_dict(ckpt_path), template)


@pytest.fixture(scope="module")
def env(tmp_path_factory, light_jax_reference):  # noqa: F811
    tmp = tmp_path_factory.mktemp("eval_jax")
    root = tmp / "coco"
    gt = build_corpus(root)
    prebake_annotations(str(root), "val2017")
    net = HigherHRNet(num_kpts=K, C=8, device="cpu").eval()
    net.load_state_dict(load_inference_weights(WEIGHTS_PATH))
    ckpt = tmp / "fixture.pt"
    torch.save({"module": {"model": net.state_dict()}, "epoch": 0}, ckpt)
    cfg = tmp / "cfg.yaml"
    cfg.write_text(f"""
setup: {{experiment_name: kp, architecture: HigherHRNet, run_name: fixture}}
trainer: {{accelerator: cpu, use_DDP: false}}
dataloader:
  val_ds: {{root: {root}, split: val2017}}
net:
  params: {{num_kpts: {K}, C: 8, s2d: false}}
inference: {{input_size: 64, use_flip: true, det_thr: 0.25, tag_thr: 0.4, ckpt_path: {ckpt}}}
""")
    argv = [f"--config={cfg}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_inference_models, "load_variables_from_ckpt", _variables_from_shapes)
        jax_out = _run_cli(_jax_cli, tmp / "jax", argv + ["--batch_size=2"])
    jax_dets = json.loads((jax_out / "val2017_results.json").read_text())
    return {"tmp": tmp, "root": root, "gt": gt, "cfg": cfg, "argv": argv, "jax_out": jax_out,
            "jax_dets": jax_dets, "jax_ap": JaxCOCOKeypointsEval(gt, jax_dets).evaluate()[0]}


def test_batched_evaluator_matches_jax(env):
    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(str(env["cfg"]), []))
    im = cfg.create_inference_model()
    assert im.use_flip and im.device == torch.device("cpu") and im.dtype == torch.float32
    ds = CocoKeypointsDataset(str(env["root"]), "val2017")
    dets = evaluate_dataset_batched(im, ds, batch_size=2, progress=False)
    assert len({d["image_id"] for d in dets}) == 10
    assert_detections_match(env["jax_dets"], dets)
    ap = COCOKeypointsEval(env["gt"], dets).evaluate()[0]
    assert ap > 0.6 and abs(ap - env["jax_ap"]) <= 0.03, (ap, env["jax_ap"])


@pytest.mark.parametrize("mode", ["serial", "batched"])
def test_eval_cli_matches_jax(env, mode):
    argv = env["argv"] + (["--batch_size=2"] if mode == "batched" else [])
    out = _run_cli(main, env["tmp"] / f"port_{mode}", argv)
    jax_out = env["jax_out"]
    assert sorted(p.name for p in out.iterdir()) == sorted(p.name for p in jax_out.iterdir()) \
        == OUT_FILES
    dets = json.loads((out / "val2017_results.json").read_text())
    assert dets and all(set(d) == set(env["jax_dets"][0]) for d in dets)
    assert all(len(d["keypoints"]) == 3 * K for d in dets)
    assert_detections_match(env["jax_dets"], dets)
    ap = COCOKeypointsEval(env["gt"], dets).evaluate()[0]
    assert abs(ap - env["jax_ap"]) <= 0.03, (ap, env["jax_ap"])
    assert "Average Precision" in (out / "coco_output.txt").read_text()
    assert yaml.safe_load((out / "config.yaml").read_text()) == \
        yaml.safe_load((jax_out / "config.yaml").read_text())
