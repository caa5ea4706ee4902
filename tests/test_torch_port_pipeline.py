"""The port's pipeline-parallel inference against the JAX package's, on the
CPU (human_pose_tpu_torch/parallel/pipeline.py vs
human_pose_tpu/parallel/pipeline.py).

* ``partition_for`` and the unit names equal JAX's; ``_pipeline_microbatch``
  on JAX's cases and against JAX's function;
* the port's ``PipelinedModel`` at 3 and 4 segments (the CPU as every
  segment's device) against JAX's over 3 and 4 of the 8 virtual devices,
  the same random weights carried across by ``utils/weights.py``: outputs
  within 1e-4; and against the port's own monolithic forward within 1e-5;
* ``InferenceKeypointsModel(pipeline_devices=3)`` with and without flip
  against JAX's (tests/test_pipeline.py:84-127) on the trained C=8 fixture
  and the AP corpus (tests/test_torch_port_inference.py): joints within
  1e-4, person scores within 1e-5, ``forward_scale``'s average and tags
  within 1e-4; the batched evaluator's refusal; the CUDA refusal when fewer cards
  than segments are present (monkeypatched), with no fallback.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from human_pose_tpu.inference.models import InferenceKeypointsModel as JaxInferenceKeypointsModel
from human_pose_tpu.inference.models import _pipeline_microbatch as jax_pipeline_microbatch
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.parallel import pipeline as jax_pipeline
from human_pose_tpu_torch.inference import BatchedKeypointsEvaluator, InferenceKeypointsModel
from human_pose_tpu_torch.inference.models import _pipeline_microbatch
from human_pose_tpu_torch.inference.serving import BatchedKeypointsPredictor
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.parallel import pipeline
from human_pose_tpu_torch.parallel.pipeline import (
    DEFAULT_PARTITION, PipelinedModel, build_units, partition_for,
)
from human_pose_tpu_torch.utils import weights
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)
from tests.test_torch_port_inference import (  # noqa: F401  (fixtures)
    EVAL, N_DECISION_IMAGES, corpus, fixture_models,
)
from tests.test_spatial import TINY

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def nets():
    """JAX's TINY HigherHRNet (plain layout) from ``PRNGKey(0)`` and the
    port's net with the same weights."""
    model = JaxHigherHRNet(s2d=False, **TINY)
    variables = model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    net = HigherHRNet(**TINY, device="cpu").eval()
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in weights.variables_to_torch(variables).items()}, strict=False)
    return model, variables, net


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _outputs(out) -> list:
    hms, tags = out
    return [np.asarray(t) for t in (*hms, tags)]


def test_partition_and_units_match_jax(nets):
    model, _, net = nets
    for n in range(1, 7):
        assert partition_for(n) == jax_pipeline.partition_for(n)
    for n in (0, 7):
        with pytest.raises(ValueError, match="1-6"):
            partition_for(n)
    assert DEFAULT_PARTITION == jax_pipeline.DEFAULT_PARTITION
    names = [u.name for u in build_units(net)]
    assert names == [u.name for u in jax_pipeline.build_units(model)]
    assert names == ["stem", "stage1", "stage2", "stage3", "stage4", "head"]


def test_pipeline_microbatch_matches_jax():
    """JAX's cases (tests/test_pipeline.py:144-154), then every pair."""
    assert _pipeline_microbatch(8, 4) == 2
    assert _pipeline_microbatch(16, 3) == 4
    assert _pipeline_microbatch(6, 3) == 2
    assert _pipeline_microbatch(1, 4) == 1
    assert _pipeline_microbatch(3, 4) == 1
    assert _pipeline_microbatch(4, 1) == 4
    for total in range(1, 33):
        for segs in range(1, 7):
            assert _pipeline_microbatch(total, segs) == jax_pipeline_microbatch(total, segs)


@pytest.mark.parametrize("segments", [3, 4])
def test_pipelined_forward_matches_jax_and_monolithic(nets, segments):
    """Four images in microbatches of two: the port's segments on the CPU
    against JAX's on ``segments`` distinct virtual devices."""
    model, variables, net = nets
    images = np.random.RandomState(segments).rand(4, 64, 64, 3).astype(np.float32)
    part = partition_for(segments)
    jpipe = jax_pipeline.PipelinedModel(model, variables, partition=part,
                                        devices=jax.devices()[:segments])
    assert len({dev.id for _, _, dev in jpipe.segments}) == segments
    want = [a.transpose(0, 3, 1, 2) for a in _outputs(jpipe(images, microbatch_size=2))]
    pipe = PipelinedModel(net, part, [CPU] * segments)
    assert len(pipe.segments) == segments and pipe.devices == [CPU] * segments
    got = _outputs(pipe(_nchw(images), microbatch_size=2))
    with torch.no_grad():
        mono = _outputs(net(_nchw(images)))
    for g, w, m in zip(got, want, mono):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4)
        np.testing.assert_allclose(g, m, atol=1e-5)


def test_pipeline_refusals(nets):
    _, _, net = nets
    with pytest.raises(ValueError, match="unknown units"):
        PipelinedModel(net, (("stem", "nope"),), [CPU])
    with pytest.raises(ValueError, match="devices"):
        PipelinedModel(net, (("stem",), ("head",)), [CPU])
    pipe = PipelinedModel(net, partition_for(1), [CPU])
    with pytest.raises(ValueError, match="divisible"):
        pipe(torch.zeros(3, 3, 64, 64), microbatch_size=2)


@pytest.fixture(scope="module")
def trained(fixture_models):  # noqa: F811
    """The trained C=8 fixture net of tests/test_torch_port_inference.py in
    both packages (random weights give near-degenerate heatmaps whose
    decisions flip between frameworks, and between batch sizes of one
    framework's convolutions)."""
    return fixture_models


@pytest.mark.parametrize("use_flip", [False, True])
def test_pipelined_inference_model_matches_jax(trained, corpus, use_flip):  # noqa: F811
    """JAX's parity test (tests/test_pipeline.py:84-127) on the port, both
    packages pipelined over three segments: the AP corpus's first images
    through ``__call__``, a batch of two through ``forward_scale`` (the flip
    pass riding the walk), and the port's batched predictor end to end."""
    model, variables, net = trained
    _, raws = corpus
    kw = dict(EVAL, use_flip=use_flip)
    jax_im = JaxInferenceKeypointsModel(model, variables, pipeline_devices=3, **kw)
    port_im = InferenceKeypointsModel(net, pipeline_devices=3, device="cpu", **kw)
    assert len(port_im._pipe.segments) == 3
    for image in raws[:N_DECISION_IMAGES]:
        want, got = jax_im(image), port_im(image)
        assert len(got.kpts_coords) == len(want.kpts_coords) >= 2
        np.testing.assert_allclose(got.kpts_coords, want.kpts_coords, atol=1e-4)
        np.testing.assert_allclose(got.obj_scores, want.obj_scores, atol=1e-5)

    xb = np.concatenate([port_im.prepare_input(raw)[0] for raw in raws[:2]])
    hw = xb.shape[1:3]
    avg_w, tags_w = jax_im.forward_scale(jax.numpy.asarray(xb), hw)
    avg_g, tags_g = port_im.forward_scale(port_im.to_device(xb), hw)
    np.testing.assert_allclose(avg_g.numpy().transpose(0, 2, 3, 1), np.asarray(avg_w), atol=1e-4)
    assert len(tags_g) == len(tags_w) == (2 if use_flip else 1)
    for g, w in zip(tags_g, tags_w):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w), atol=1e-4)

    predictor = BatchedKeypointsPredictor(port_im)
    out = predictor.predict([predictor.prepare(raw) for raw in raws[:2]])
    assert len(out) == 2
    for answer in out:
        assert answer["num_people"] == len(answer["people"]) >= 2


def test_batched_eval_refuses_pipelined_model(nets):
    _, _, net = nets
    piped = InferenceKeypointsModel(net, input_size=64, pipeline_devices=2, device="cpu")
    with pytest.raises(ValueError, match="pipeline_devices"):
        BatchedKeypointsEvaluator(piped, batch_size=2)


def test_cuda_pipeline_refuses_missing_cards(monkeypatch):
    """On the card the segments go to cuda:0 ... cuda:N-1; with fewer cards
    the pipeline raises and never drops to fewer segments or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pipeline.cuda_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="needs 3 CUDA devices"):
        pipeline.cuda_devices(3)
    model = HigherHRNet(**TINY, device="cpu").eval()
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        PipelinedModel(model)
    monkeypatch.setattr(pipeline, "PipelinedModel", lambda *a, **k: pytest.fail("built"))
    im = InferenceKeypointsModel.__new__(InferenceKeypointsModel)
    with pytest.raises(RuntimeError, match="needs 3 CUDA devices"):
        monkeypatch.setattr("human_pose_tpu_torch.inference.models._model_device",
                            lambda model, device: torch.device("cuda", 0))
        InferenceKeypointsModel.__init__(im, model, pipeline_devices=3)
