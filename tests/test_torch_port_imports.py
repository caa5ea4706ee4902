"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "human_pose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "human_pose_tpu", "tests")


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = {m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def _run(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_with_jax_blocked():
    """Every module of the port (and chip_smoke) imports with JAX, flax and
    the JAX package made unimportable, and without CUDA: the subpackages of
    the inference and eval paths, the CLIs and training (its engine and
    CLI) too, the classification CLIs, config and dataset, serving and
    export (their CLIs, the flag parser, model info), the model zoo (its
    nets, the SPPE decode, MPII and PCKh), data parallelism, the directory
    checkpoint backend and the reader of JAX trainer checkpoints (with
    orbax and msgpack unimportable too), the training and decomposition
    benchmarks."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'human_pose_tpu', 'orbax', 'msgpack'): sys.modules[m] = None\n"
        "import human_pose_tpu_torch, human_pose_tpu_torch.models, human_pose_tpu_torch.ops\n"
        "import human_pose_tpu_torch.utils, human_pose_tpu_torch.ops._build, chip_smoke\n"
        "import human_pose_tpu_torch.inference, human_pose_tpu_torch.data\n"
        "import human_pose_tpu_torch.metrics, human_pose_tpu_torch.loggers\n"
        "import human_pose_tpu_torch.configs, human_pose_tpu_torch.bin.eval_keypoints\n"
        "import human_pose_tpu_torch.bin.inference_keypoints, human_pose_tpu_torch.train\n"
        "import human_pose_tpu_torch.bin.train_keypoints, human_pose_tpu_torch.utils.profiling\n"
        "import human_pose_tpu_torch.bin.train_classification\n"
        "import human_pose_tpu_torch.bin.eval_classification\n"
        "import human_pose_tpu_torch.bin.inference_classification\n"
        "import human_pose_tpu_torch.configs.classification, human_pose_tpu_torch.data.imagenet\n"
        "import human_pose_tpu_torch.inference.serving, human_pose_tpu_torch.bin.serve\n"
        "import human_pose_tpu_torch.bin.bench_serve, human_pose_tpu_torch.bin.export\n"
        "import human_pose_tpu_torch.utils.export, human_pose_tpu_torch.utils.model_info\n"
        "import human_pose_tpu_torch.utils.argv\n"
        "import human_pose_tpu_torch.models.helpers, human_pose_tpu_torch.models.resnet\n"
        "import human_pose_tpu_torch.models.simple_baseline, human_pose_tpu_torch.models.hourglass\n"
        "import human_pose_tpu_torch.ops.sppe, human_pose_tpu_torch.data.mpii\n"
        "import human_pose_tpu_torch.metrics.pckh\n"
        "import human_pose_tpu_torch.parallel, human_pose_tpu_torch.parallel.distributed\n"
        "import human_pose_tpu_torch.train.checkpoint_orbax, human_pose_tpu_torch.utils.flax_msgpack\n"
        "import human_pose_tpu_torch.bin.bench_train, human_pose_tpu_torch.bin.bench_decompose\n"
        "print('ok')\n"
    )
    res = _run(code, ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_refuse_missing_card():
    """Without a card, building on the default device raises instead of
    running on the CPU; ``device="cpu"`` is the explicit way there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs a CUDA-less host")
    from human_pose_tpu_torch import resolve_device
    from human_pose_tpu_torch.models import HigherHRNet

    with pytest.raises(RuntimeError, match="cuda"):
        HigherHRNet(num_kpts=17, C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_classification_entry_points_refuse_missing_card(tmp_path, monkeypatch):
    """``ClassificationHRNet``, ``InferenceClassificationModel`` and the
    three classification CLIs on the repo's yaml (``accelerator: tpu``)
    need a card: each raises without one, the train CLI before it makes a
    run directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs a CUDA-less host")
    from human_pose_tpu_torch.bin import (
        eval_classification, inference_classification, train_classification,
    )
    from human_pose_tpu_torch.inference import InferenceClassificationModel
    from human_pose_tpu_torch.models import ClassificationHRNet

    tiny = dict(C=8, num_classes=3, num_blocks_per_stage=(1, 1, 1, 1), num_units=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ClassificationHRNet(**tiny)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceClassificationModel(ClassificationHRNet(**tiny, device="cpu"))
    monkeypatch.chdir(tmp_path)
    cfg = f"--config={ROOT / 'experiments' / 'classification' / 'hrnet_32.yaml'}"
    net = ["--net.params.C=8", "--net.params.num_blocks_per_stage=[1,1,1,1]", "--net.params.num_units=1"]
    with pytest.raises(RuntimeError, match="cuda"):
        train_classification.main([cfg, *net])
    assert not (tmp_path / "results").exists()
    with pytest.raises(RuntimeError, match="cuda"):
        eval_classification.main([cfg, *net, "--inference.ckpt_path=null"])
    with pytest.raises(RuntimeError, match="cuda"):
        inference_classification.main([cfg, *net, "--inference.ckpt_path=null", "--mode=custom",
                                       f"--dirpath={tmp_path}"])


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers take the plain version only for CPU tensors."""
    from human_pose_tpu_torch.ops import (
        fused_aggregate, fused_basic_block, match_by_tag_batched, match_by_tag_per_image,
        refine_argmax_batch, refine_argmax_phase_batch,
    )

    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="device"):
        refine_argmax_batch(meta(1, 2, 64), meta(1, 2, 1, 64), meta(1, 3, 1),
                            torch.empty((1,), dtype=torch.int32, device="meta"))
    for match in (match_by_tag_batched, match_by_tag_per_image):
        with pytest.raises(ValueError, match="device"):
            match(meta(1, 17, 4, 4), 0.1, 1.0, tuple(range(17)), 4)
    with pytest.raises(ValueError, match="device"):
        fused_aggregate(meta(1, 2, 4, 8), meta(1, 2, 8, 16))
    with pytest.raises(ValueError, match="device"):
        refine_argmax_phase_batch(meta(1, 2, 4, 4, 4, 8), meta(1, 2, 1, 4, 8), meta(1, 3, 1))
    with pytest.raises(ValueError, match="device"):
        fused_basic_block(meta(1, 8, 8, 8), meta(3, 3, 8, 8), meta(8), meta(3, 3, 8, 8), meta(8))


def test_chip_smoke_fails_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            (tmp_path / "chip_smoke.py").write_text(script.read_text())
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
