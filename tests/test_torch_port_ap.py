"""The port's keypoints inference model vs the JAX package's with flip TTA
on, over the whole AP corpus (tests/ap_fixture.py: 10 images, 2 persons
each), on the trained C=8 fixture weights: decisions per image, then ROADMAP
module 8's AP check, each pipeline scored with its own package's COCO eval.
Fixtures and the decision statistics: tests/test_torch_port_inference.py."""

from __future__ import annotations

from human_pose_tpu.metrics.cocoeval import COCOKeypointsEval as JaxCOCOKeypointsEval
from human_pose_tpu_torch.metrics import COCOKeypointsEval
from tests.test_torch_port_inference import (  # noqa: F401  (fixtures)
    assert_decisions_match, corpus, fixture_models, light_jax_reference, pipeline_results,
)


def test_flip_decisions_match_jax(pipeline_results):  # noqa: F811
    pairs, (jax_im, port_im) = pipeline_results("flip")
    assert len(pairs) == 10
    assert_decisions_match("flip", pairs, jax_im, port_im)


def test_ap_matches_jax(corpus, pipeline_results):  # noqa: F811
    """|AP_port - AP_jax| <= 0.03, the band of tests/test_ap_parity.py, with
    >= 2 persons in every image through the port (det_thr 0.25, tag_thr
    0.4, input 64, 10 people)."""
    gt, _ = corpus
    pairs, _ = pipeline_results("flip")
    jax_dets, port_dets, persons = [], [], []
    for i, (want, got) in enumerate(pairs):
        jax_dets += want.to_coco_detections(image_id=i)
        dets = got.to_coco_detections(image_id=i)
        persons.append(len(dets))
        port_dets += dets
    ap_jax = JaxCOCOKeypointsEval(gt, jax_dets).evaluate()[0]
    ap_port = COCOKeypointsEval(gt, port_dets).evaluate()[0]
    assert all(n >= 2 for n in persons), persons
    assert ap_port > 0.6, ap_port
    assert abs(ap_port - ap_jax) <= 0.03, (ap_port, ap_jax)
