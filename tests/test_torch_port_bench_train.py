"""The port's training benchmark (``human_pose_tpu_torch/bin/bench_train.py``)
vs the JAX package's ``bin/bench_train.py``, on the CPU.

JAX's ``main`` runs with its train step replaced by a stub that hands the
synthesized batch out through ``jax.debug.callback`` and returns the state
unchanged, and with a one-conv stand-in for its network (the batch does not
depend on the net; flax's eager init of even the shallow HigherHRNet takes
~18 s): no train step compiles, and JAX's own ``synth_batch`` runs inside
its jitted loop. The port's ``synth_batch`` for each captured iteration
must equal it bit for bit after the NCHW permute.

The port's loop is held against two manual calls of its own train step on
the shallow C=8 HigherHRNet (the printed loss is the loss after
``2 * iters`` steps, as JAX's).
"""

from __future__ import annotations

import json
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import human_pose_tpu.models as jax_models
import human_pose_tpu.train.steps as jax_steps
from human_pose_tpu.bin import bench_train as jax_bench
from human_pose_tpu_torch.bin import bench_train
from human_pose_tpu_torch.models import ClassificationHRNet, HigherHRNet, init_flax_default_
from human_pose_tpu_torch.train import TrainState, create_optimizer
from human_pose_tpu_torch.train.steps import keypoints_train_step
from tests.jax_reference import light_jax_reference  # noqa: F401

SHALLOW = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1, num_deconv_resid_blocks=1)


class _StandIn(fnn.Module):
    """One conv and one BatchNorm: ``params`` and ``batch_stats`` for JAX's
    ``TrainState.create``, in milliseconds."""

    num_kpts: int = 17
    C: int = 8
    remat: object = False
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.BatchNorm(use_running_average=not train)(fnn.Conv(4, (1, 1))(x))


def _jax_batches(monkeypatch, argv: list) -> list:
    """JAX's ``bench_train.main`` on ``argv`` with the stub step; the
    batches its loop synthesized, in order, as NumPy."""
    got = []

    def stub(state, batch, lr):
        jax.debug.callback(lambda b: got.append(jax.tree_util.tree_map(np.asarray, b)), batch)
        return state, {"loss": jnp.float32(0.0)}

    monkeypatch.setattr(jax_steps, "keypoints_train_step_body", stub)
    monkeypatch.setattr(jax_models, "HigherHRNet", _StandIn)
    monkeypatch.setattr(jax, "device_count", lambda: 1)  # no mesh: the batch is the same
    monkeypatch.setattr(sys, "argv", ["bench_train", *argv])
    jax_bench.main()
    return got


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("batch,size,iters", [(2, 64, 2), (36, 512, 1)], ids=["small", "full"])
def test_synth_batch_equals_jax(monkeypatch, batch, size, iters):
    """Every batch JAX's loop synthesized (two passes of ``iters``) equals
    the port's ``synth_batch`` of the same iteration, bit for bit, after
    the NCHW permute; at the full keypoints size the image ramp has 28.3 M
    elements, past float32's exact integers (2**24)."""
    got = _jax_batches(monkeypatch, [f"--batch={batch}", f"--size={size}", f"--iters={iters}"])
    assert len(got) == 2 * iters
    for n, b in enumerate(got):
        i = n % iters
        assert float(b["images"].flat[0]) == float(np.float32(i) * np.float32(1e-3))
        mine = bench_train.synth_batch(i, batch, size, "cpu")
        assert np.array_equal(_nhwc(mine["images"]), b["images"])
        for a, want in zip(mine["heatmaps"], b["heatmaps"]):
            assert np.array_equal(_nhwc(a), want)
        for a, want in zip(mine["masks"], b["masks"]):
            assert np.array_equal(a.numpy(), want)
        assert mine["joints"].dtype == torch.int32 and np.array_equal(mine["joints"].numpy(), b["joints"])
        assert mine["images"].is_contiguous()


def test_ramp_rows_are_slices_of_the_global_ramp():
    """A process's rows of the global batch (data parallelism) equal the
    same rows of the whole ramp; labels too."""
    whole = bench_train.synth_batch(3, 4, 32, "cpu")
    part = bench_train.synth_batch(3, 4, 32, "cpu", rows=(2, 4))
    assert torch.equal(part["images"], whole["images"][2:])
    assert all(torch.equal(a, b[2:]) for a, b in zip(part["heatmaps"], whole["heatmaps"]))
    assert tuple(part["joints"].shape) == (2, 30, 17, 3)
    assert torch.equal(bench_train.synth_labels(999, 4, "cpu", rows=(2, 4)), torch.tensor([1, 2]))


def _shallow_hrnet(**kw):
    return HigherHRNet(**{**kw, **SHALLOW})


def _manual_loss(remat=False) -> float:
    """Two manual keypoints steps of the port (bfloat16 state, Adam 1e-3)
    on iteration 0's batch from the seeded init: the loss of the second."""
    model = _shallow_hrnet(num_kpts=17, C=8, remat=remat, device="cpu")
    init_flax_default_(model, torch.Generator().manual_seed(0))
    state = TrainState.create(model, create_optimizer(model.parameters(), "Adam", lr=1e-3),
                              dtype=torch.bfloat16, device="cpu")
    for _ in range(2):
        _, metrics = keypoints_train_step(state, bench_train.synth_batch(0, 2, 64, "cpu"), 1e-3)
    return float(metrics["loss"])


def test_loop_loss_equals_two_manual_steps(monkeypatch, capsys):
    """``--iters=1``: the printed loss is the second step's on the same
    batch, bit for bit; ``--remat=0,4`` gives the same loss; JAX's keys and
    metric string, one device (no process group, no mesh)."""
    monkeypatch.setattr(bench_train, "HigherHRNet", _shallow_hrnet)
    monkeypatch.setattr(bench_train, "make_mesh", lambda: pytest.fail("a mesh at world size 1"))
    want = _manual_loss()
    base = ["--C=8", "--batch=2", "--size=64", "--iters=1", "--device=cpu"]
    rec = bench_train.main(base)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec
    assert set(rec) == {"metric", "value", "unit", "ms_per_step", "loss", "platform"}
    assert rec["metric"] == "train images/sec HigherHRNet-W8 @64 (bs 2, 1 devices)"
    assert rec["unit"] == "images/sec" and rec["platform"] == "cpu"
    assert rec["value"] > 0 and rec["ms_per_step"] > 0
    assert rec["loss"] == want and np.isfinite(want)
    assert bench_train.main([*base, "--remat=0,4"])["loss"] == want


def test_classification_cli_on_cpu(monkeypatch, capsys):
    """``--task=classification`` (SGD nesterov, labels ``(arange + i) %
    1000``) on a shallow C=8 net at 32^2: one finite record."""
    monkeypatch.setattr(bench_train, "ClassificationHRNet", lambda **kw: ClassificationHRNet(
        **{**kw, "C": 8, "num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1}))
    monkeypatch.setattr(bench_train, "create_state", _checked_state(bench_train.create_state))
    rec = bench_train.main(["--task=classification", "--batch=2", "--size=32", "--iters=2",
                            "--device=cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["metric"] == "train images/sec ClassificationHRNet-W32 @32 (bs 2, 1 devices)"
    assert all(np.isfinite(rec[k]) for k in ("value", "ms_per_step", "loss"))


def _checked_state(create_state):
    """``create_state``, checking the classification state it makes: the
    net, bfloat16, and SGD's momentum, weight decay and nesterov."""
    def create(task, width, remat, device, mesh=None):
        state = create_state(task, width, remat, device, mesh)
        assert isinstance(state.model, ClassificationHRNet) and state.dtype == torch.bfloat16
        group = state.optimizer.param_groups[0]
        assert (group["momentum"], group["weight_decay"], group["nesterov"]) == (0.9, 1e-4, True)
        return state
    return create


def test_flags_and_refusals():
    """Per-task defaults, the remat grammar, unknown flags and tasks
    refused, and the card required unless ``--device=cpu``."""
    assert bench_train.DEFAULTS == {"keypoints": (36, 512, 5, False),
                                    "classification": (80, 224, 10, False)}
    assert bench_train.parse_remat("TRUE") is True and bench_train.parse_remat("false") is False
    assert bench_train.parse_remat("0,4") == (0, 4) and bench_train.parse_remat("0") == (0,)
    with pytest.raises(SystemExit):
        bench_train.main(["--tsak=keypoints"])
    with pytest.raises(SystemExit):
        bench_train.main(["--task=detection", "--device=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench_train.main(["--C=8", "--batch=2", "--size=64", "--iters=1"])
