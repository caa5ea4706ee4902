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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "human_pose_tpu", "tests")


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
    the JAX package made unimportable, and without CUDA."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'human_pose_tpu'): sys.modules[m] = None\n"
        "import human_pose_tpu_torch, human_pose_tpu_torch.models, human_pose_tpu_torch.ops\n"
        "import human_pose_tpu_torch.utils, human_pose_tpu_torch.ops._build, chip_smoke\n"
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


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers take the plain version only for CPU tensors."""
    from human_pose_tpu_torch.ops import match_by_tag_batched, refine_argmax_batch

    with pytest.raises(ValueError, match="device"):
        refine_argmax_batch(
            torch.empty((1, 2, 64), device="meta"), torch.empty((1, 2, 1, 64), device="meta"),
            torch.empty((1, 3, 1), device="meta"), torch.empty((1,), dtype=torch.int32, device="meta"),
        )
    with pytest.raises(ValueError, match="device"):
        match_by_tag_batched(torch.empty((1, 17, 4, 4), device="meta"), 0.1, 1.0, tuple(range(17)), 4)


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
