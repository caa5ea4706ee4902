"""The port's sharded COCO evaluation against one process and against the
JAX package's mesh-sharded evaluator, on the CPU.

The trained C=8 fixture (tests/ap_fixture.py's weights) on 9 images of its
corpus, three of them two images side by side (96x192, four persons; two
shape buckets at input 64, an
odd count: at a global batch of 4 over two processes rank 0 dispatches a
padded partial batch), no flip:

* two gloo processes launched with torchrun's environment run
  ``BatchedKeypointsEvaluator(mesh=make_mesh())``, each adding its shard
  (``tests/test_torch_port_sharded_eval_worker.py``); rank 0's detections
  and OKS values, grouped by image, equal the one-process port run's at the
  per-process batch size bit for bit, in dataset order; rank 1 returns
  empty lists;
* they match the JAX package's ``evaluate_dataset_batched(mesh=make_mesh(2))``
  on the same images within tests/test_batched_eval.py's tolerances
  (coordinates < 0.5 px, scores within 1e-3, equal person counts), the
  tolerance of test_torch_port_eval_jax.py;
* ``python -m torch.distributed.run --nproc_per_node=2 -m
  human_pose_tpu_torch.bin.eval_keypoints --sharded=true --batch_size=4``
  writes one output directory (rank 0's), whose ``val2017_results.json``
  equals the one-process CLI's at ``--batch_size=2`` image by image;
* the refusals: a batch the mesh does not divide (JAX's message), an image
  of another rank's shard, and ``--sharded=true`` with ``--batch_size<=1``.

The processes start before the JAX package compiles and run meanwhile.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.configs.keypoints import KeypointsConfig as JaxKeypointsConfig
from human_pose_tpu.data import CocoKeypointsDataset as JaxCocoKeypointsDataset
from human_pose_tpu.inference import BatchedKeypointsEvaluator as JaxBatchedKeypointsEvaluator
from human_pose_tpu.inference import evaluate_dataset_batched as jax_evaluate_dataset_batched
from human_pose_tpu.inference import models as jax_inference_models
from human_pose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from human_pose_tpu.utils.torch_interop import load_torch_state_dict, variables_from_torch
from human_pose_tpu_torch.bin.eval_keypoints import main
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.data import CocoKeypointsDataset, prebake_annotations
from human_pose_tpu_torch.inference import (
    BatchedKeypointsEvaluator, evaluate_dataset_batched, load_inference_weights,
)
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.parallel import Mesh
from tests.ap_fixture import K, WEIGHTS_PATH, build_corpus
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)
from tests.test_batched_eval import assert_detections_match

ROOT = Path(__file__).resolve().parent.parent
N_IMAGES, WIDE = 9, (1, 4, 7)
BATCH, WORLD = 4, 2
TIMEOUT_S = 150


def _mixed_corpus(root: Path) -> None:
    """The fixture corpus of ``N_IMAGES``, images ``WIDE`` made 96x192: each
    is put beside one more image of the corpus, whose two persons join it
    (their x moved by 96), so every image is of the kind the fixture was
    trained on."""
    gt = build_corpus(root, n_images=N_IMAGES + len(WIDE))
    images = root / "images" / "val2017"
    by_id = {im["id"]: im for im in gt["images"]}
    for wide, extra in zip(WIDE, range(N_IMAGES, N_IMAGES + len(WIDE))):
        left, right = (cv2.imread(str(images / by_id[i]["file_name"])) for i in (wide, extra))
        cv2.imwrite(str(images / by_id[wide]["file_name"]), np.concatenate([left, right], axis=1))
        (images / by_id[extra]["file_name"]).unlink()
        by_id[wide]["width"] = 2 * left.shape[1]
        for a in gt["annotations"]:
            if a["image_id"] == extra:
                a["image_id"] = wide
                a["keypoints"] = [v + left.shape[1] * (j % 3 == 0) for j, v in enumerate(a["keypoints"])]
                a["bbox"][0] += left.shape[1]
                a["segmentation"] = [[v + left.shape[1] * (j % 2 == 0) for j, v in enumerate(poly)]
                                     for poly in a["segmentation"]]
    gt["images"] = [im for im in gt["images"] if im["id"] < N_IMAGES]
    (root / "annotations" / "person_keypoints_val2017.json").write_text(json.dumps(gt))
    prebake_annotations(str(root), "val2017")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return {**env, **extra}


def _launch_workers(cfg: Path, tmp: Path) -> list:
    port = _free_port()
    code = "from tests.test_torch_port_sharded_eval_worker import worker; worker({!r}, {}, {!r})"
    return [subprocess.Popen(
        [sys.executable, "-c", code.format(str(cfg), BATCH, str(tmp / f"r{rank}.json"))], cwd=ROOT,
        env=_env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]


def _launch_cli(cfg: Path, work: Path) -> subprocess.Popen:
    work.mkdir()
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={WORLD}", "--nnodes=1",
         "--master_addr=127.0.0.1", f"--master_port={_free_port()}",
         "-m", "human_pose_tpu_torch.bin.eval_keypoints", f"--config={cfg}",
         f"--batch_size={BATCH}", "--sharded=true"],
        cwd=work, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _variables_from_shapes(model, ckpt_path, input_shape=(64, 64, 3)):
    """JAX's ``load_variables_from_ckpt`` with its template's shapes from
    ``jax.eval_shape`` (tests/test_torch_port_eval_jax.py's)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *input_shape), jnp.float32), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return variables_from_torch(load_torch_state_dict(ckpt_path), template)


@pytest.fixture(scope="module")
def env(tmp_path_factory, light_jax_reference):  # noqa: F811
    tmp = tmp_path_factory.mktemp("sharded_eval")
    root = tmp / "coco"
    _mixed_corpus(root)
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
inference: {{input_size: 64, use_flip: false, det_thr: 0.25, tag_thr: 0.4, ckpt_path: {ckpt}}}
""")
    procs = _launch_workers(cfg, tmp) + [_launch_cli(cfg, tmp / "cli_sharded")]
    try:
        port_cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(str(cfg), []))
        im = port_cfg.create_inference_model()
        ds = CocoKeypointsDataset(str(root), "val2017")
        one = BatchedKeypointsEvaluator(im, batch_size=BATCH // WORLD)
        for idx in range(len(ds)):
            one.add(ds.load_image(idx), idx, ds.load_annot(idx))
        one_dets, one_oks = one.finish()
        oks_in_order = [oks for _, _, oks in sorted(one._records, key=lambda r: r[0])]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_inference_models, "load_variables_from_ckpt", _variables_from_shapes)
            jax_cfg = JaxKeypointsConfig.from_dict(JaxKeypointsConfig.from_yaml_to_dict(str(cfg), []))
            jax_im = jax_cfg.create_inference_model()
        jax_dets = jax_evaluate_dataset_batched(
            jax_im, JaxCocoKeypointsDataset(str(root), "val2017", transform=None), BATCH,
            mesh=jax_make_mesh(WORLD), progress=False)
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        yield {"tmp": tmp, "cfg": cfg, "im": im, "jax_im": jax_im, "one_dets": one_dets,
               "one_oks": one_oks, "oks_in_dataset_order": oks_in_order, "jax_dets": jax_dets, "cli_log": logs[-1],
               "ranks": [json.loads((tmp / f"r{r}.json").read_text()) for r in range(WORLD)]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _by_image(dets: list) -> dict:
    out: dict = {}
    for d in dets:
        out.setdefault(d["image_id"], []).append(d)
    return out


def test_two_processes_equal_one_process(env):
    """Rank 0's detections equal the one-process run's image by image (the
    same batch size a process), in dataset order; its OKS values are the
    one-process run's in that order; rank 1 returns nothing; rank 0
    dispatched a padded partial batch of the wide bucket."""
    r0, r1 = env["ranks"]
    assert r0["shard"] == list(range(0, N_IMAGES, WORLD)) and r1["shard"] == list(range(1, N_IMAGES, WORLD))
    assert r0["local_batch_size"] == r1["local_batch_size"] == BATCH // WORLD
    # rank 0: squares 0, 2, 6, 8 and wide 4 alone; rank 1: wide 1, 7, squares 3, 5
    assert r0["n_batches"] == 3 and r1["n_batches"] == 2 and len(r0["buckets"]) == 2
    assert r1["dets"] == [] and r1["oks"] == []
    dets = r0["dets"]
    ids = [d["image_id"] for d in dets]
    assert ids == sorted(ids) and set(ids) == set(range(N_IMAGES))
    assert _by_image(dets) == _by_image(env["one_dets"])
    assert r0["oks"] == env["oks_in_dataset_order"] and len(r0["oks"]) == N_IMAGES


def test_two_processes_match_jax_mesh(env):
    """Rank 0's detections against the JAX package's evaluator on a
    2-device mesh at the same global batch."""
    assert len(env["jax_dets"]) == len(env["ranks"][0]["dets"])
    assert_detections_match(env["jax_dets"], env["ranks"][0]["dets"])


def test_cli_under_torchrun_two_gloo_processes(env):
    """The CLI under ``torch.distributed.run`` with two gloo processes:
    both join the group, one output directory with the three files (rank
    0's), its results equal to the one-process CLI's at the per-process
    batch size image by image, and its config equal too."""
    assert "initialized torch.distributed (gloo): process 1 / 2" in env["cli_log"]
    (out,) = (env["tmp"] / "cli_sharded" / "evaluation_results").iterdir()
    assert sorted(p.name for p in out.iterdir()) == ["coco_output.txt", "config.yaml",
                                                     "val2017_results.json"]
    sharded = json.loads((out / "val2017_results.json").read_text())
    work = env["tmp"] / "cli_one"
    work.mkdir()
    with contextlib.chdir(work):
        one_out = work / main([f"--config={env['cfg']}", f"--batch_size={BATCH // WORLD}"])
    one = json.loads((one_out / "val2017_results.json").read_text())
    assert sharded == sorted(one, key=lambda d: d["image_id"])
    assert sharded == env["ranks"][0]["dets"]
    assert (out / "config.yaml").read_text() == (one_out / "config.yaml").read_text()
    assert "Average Precision" in (out / "coco_output.txt").read_text()


def test_sharded_refusals(env, tmp_path):
    """A global batch the mesh does not divide raises JAX's message (the
    JAX evaluator's beside it); an image of another rank's shard, and an
    image without its index under a mesh, raise; ``--sharded=true`` with
    ``--batch_size<=1`` exits with JAX's message before anything is read."""
    mesh = Mesh(rank=1, world_size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError) as port_err:
        BatchedKeypointsEvaluator(env["im"], batch_size=3, mesh=mesh)
    with pytest.raises(ValueError) as jax_err:
        JaxBatchedKeypointsEvaluator(env["jax_im"], batch_size=3, mesh=jax_make_mesh(2))
    assert str(port_err.value) == str(jax_err.value) == "batch_size 3 not divisible by the 2-device mesh"
    ev = BatchedKeypointsEvaluator(env["im"], batch_size=4, mesh=mesh)
    assert list(ev.shard(5)) == [1, 3] and ev.local_batch_size == 2
    image = np.zeros((96, 96, 3), np.uint8)
    for index in (None, 2):
        with pytest.raises(ValueError, match="shard"):
            ev.add(image, 0, None, index=index)
    for bs in ("1", "0"):
        with pytest.raises(SystemExit, match="requires --batch_size>1"):
            main(["--config=unused.yaml", f"--batch_size={bs}", "--sharded=true"])


def test_sharded_without_torchrun_evaluates_as_one_process(env, tmp_path, monkeypatch):
    """``--sharded=true`` without torchrun's environment evaluates alone:
    no process group, the one-process batched run's detections, rank 0's
    files."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / main([f"--config={env['cfg']}", f"--batch_size={BATCH // WORLD}",
                           "--sharded=true"])
    assert not torch.distributed.is_initialized()
    dets = json.loads((out / "val2017_results.json").read_text())
    assert _by_image(dets) == _by_image(env["one_dets"])
    assert dets == evaluate_dataset_batched(env["im"], CocoKeypointsDataset(
        str(env["tmp"] / "coco"), "val2017"), BATCH // WORLD, progress=False)
