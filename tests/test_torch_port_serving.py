"""The port's serving (inference/serving.py, bin/serve.py, bin/bench_serve.py)
on the CPU, mirrored on tests/test_serving.py and held against the JAX
package's.

* tests/test_serving.py's fourteen cases on the port: a tiny C=8
  HigherHRNet and its classifier with seeded weights, ``device="cpu"``;
* the port's ``BatchedKeypointsPredictor`` against JAX's on the trained C=8
  fixture (tests/data/ap_fixture_weights.npz in both packages) and the AP
  corpus's images, one padded batch of three: the same person counts, a
  median joint difference under 0.5 px and sorted person scores within 0.05
  (tests/test_torch_port_inference.py's rules: the frameworks' convolutions
  and resizes sum in other orders); ``BatchedClassificationPredictor``
  against JAX's on the same random weights (top-5 labels equal,
  probabilities within 1e-5); ``decode_request_body`` accepting and
  refusing the same bodies as JAX's;
* the port only: the duck-checks, a padded batch against single requests,
  ``predict`` from a plain thread in bfloat16 (autocast on, nothing
  requiring grad), ``/healthz``'s platform, ``bin.serve`` as a process
  answering a POST and exiting 0 on SIGTERM, ``bin.bench_serve`` on the CPU.

JAX compiles once a configuration (module fixtures); the port runs on one
torch intra-op thread.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from human_pose_tpu.inference import InferenceClassificationModel as JaxClassificationModel
from human_pose_tpu.inference import InferenceKeypointsModel as JaxKeypointsModel
from human_pose_tpu.inference import serving as jax_serving
from human_pose_tpu.models import ClassificationHRNet as JaxClassificationHRNet
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu_torch.bin import bench_serve
from human_pose_tpu_torch.inference import (
    BatchedClassificationPredictor, BatchedKeypointsPredictor, DynamicBatcher,
    InferenceClassificationModel, InferenceKeypointsModel, decode_request_body, load_inference_weights,
    make_server,
)
from human_pose_tpu_torch.inference.serving import _Pending
from human_pose_tpu_torch.models import ClassificationHRNet, HigherHRNet, init_flax_default_
from human_pose_tpu_torch.utils import variables_from_state_dict
from tests.ap_fixture import (
    IN_SIZE, K, P_CAP, WEIGHTS_PATH, build_corpus, load_trained_variables, train_batch_and_views,
)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1)
EVAL = dict(det_thr=0.25, tag_thr=0.4, input_size=IN_SIZE, max_num_people=P_CAP)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs: the suite runs several workers on a few cores, where
    torch's default thread pool spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_net() -> HigherHRNet:
    net = HigherHRNet(num_kpts=17, C=8, num_deconv_resid_blocks=1, device="cpu", **TINY).eval()
    return init_flax_default_(net, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def predictor():
    im = InferenceKeypointsModel(_tiny_net(), input_size=128, max_num_people=5, device="cpu")
    return BatchedKeypointsPredictor(im)


def _image(seed, h=160, w=160):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(port: int, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _serve(batcher, **kw):
    server = make_server(batcher, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


# -- tests/test_serving.py's cases on the port ----------------------------------------------

def test_batched_predict_matches_single_path(predictor):
    raw = _image(0)
    payload = predictor.predict([predictor.prepare(raw)])[0]
    ref = predictor.m(raw)  # the full single-image pipeline

    assert payload["num_people"] == len(ref.kpts_coords)
    got = np.asarray([p["keypoints"] for p in payload["people"]], np.float32).reshape(-1, 17, 3)
    np.testing.assert_allclose(got[..., :2], ref.kpts_coords.reshape(-1, 17, 2), atol=0.05)
    # payload coords/scores are rounded to 2 decimals -> atol 5e-3
    np.testing.assert_allclose(got[..., 2], ref.kpts_scores.reshape(-1, 17), atol=5e-3)


def test_predictor_warmup_runs_po2_buckets(predictor):
    """warmup() must run every power-of-two batch bucket predict() can form
    (both CLIs rely on it so live requests never wait on cuDNN's plans)."""
    calls = []
    orig = predictor.predict
    try:
        predictor.predict = lambda reqs: calls.append(len(reqs)) or orig(reqs)
        predictor.warmup(_image(9), max_batch=3)
    finally:
        predictor.predict = orig
    assert calls == [1, 2, 4]  # max_batch=3 pads up to the 4-bucket


def test_batcher_coalesces_concurrent_requests(predictor):
    batcher = DynamicBatcher(predictor, max_batch=4, max_wait_ms=300.0)
    try:
        results = [None] * 3

        def run(i):
            results[i] = batcher.submit(_image(i))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None for r in results)
        # same shape -> same bucket -> one batch of 3 (the long max_wait
        # guarantees coalescing regardless of scheduling)
        assert {r["batch_size"] for r in results} == {3}
        stats = batcher.stats()
        assert stats["requests"] == 3 and stats["batches"] == 1
        assert stats["mean_batch_size"] == 3.0
    finally:
        batcher.close()


def test_decode_request_body_npy_and_image():
    import cv2

    arr = _image(7, 32, 24)
    np.testing.assert_array_equal(decode_request_body(_npy(arr)), arr)
    ok, enc = cv2.imencode(".png", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    assert ok
    np.testing.assert_array_equal(decode_request_body(enc.tobytes()), arr)
    with pytest.raises(ValueError, match="neither"):
        decode_request_body(b"garbage bytes")
    # shape is right but dtype isn't: must 400, not silently normalize a
    # float [0,1] array as 0-255 pixels and return garbage with a 200
    with pytest.raises(ValueError, match="uint8"):
        decode_request_body(_npy(arr.astype(np.float32) / 255.0))


def test_http_server_end_to_end(predictor):
    batcher = DynamicBatcher(predictor, max_batch=2, max_wait_ms=1.0)
    server, _ = _serve(batcher)
    port = server.server_address[1]
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
                return r.status, json.loads(r.read())

        status, health = get("/healthz")
        assert status == 200 and health == {"status": "ok", "platform": "cpu"}

        status, out = _post(port, _npy(_image(3)))
        assert status == 200
        assert "people" in out and out["batch_size"] >= 1 and "latency_ms" in out
        for person in out["people"]:
            assert len(person["keypoints"]) == 17

        status, stats = get("/stats")
        assert status == 200 and stats["requests"] >= 1

        # Prometheus exposition mirrors the same counters
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            text = r.read().decode()
        assert "# TYPE serving_requests_total counter" in text
        assert f"serving_requests_total {stats['requests']}" in text
        assert "serving_mean_batch_size" in text

        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, b"junk")
        assert exc.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_batcher_splits_mixed_shape_buckets(predictor):
    """Requests with different raw shapes coalesce into SEPARATE device
    batches (per shape bucket) within one drain window — both succeed."""
    batcher = DynamicBatcher(predictor, max_batch=4, max_wait_ms=300.0)
    try:
        results = {}

        def run(name, img):
            results[name] = batcher.submit(img)

        threads = [
            threading.Thread(target=run, args=("square", _image(0, 160, 160))),
            threading.Thread(target=run, args=("wide", _image(1, 120, 240))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert set(results) == {"square", "wide"}
        assert all("people" in r for r in results.values())
        stats = batcher.stats()
        assert stats["requests"] == 2
        # distinct shape buckets -> they cannot share a device batch
        assert all(r["batch_size"] == 1 for r in results.values())
    finally:
        batcher.close()


def test_server_error_maps_to_503(predictor):
    """Server-side failures are 503 (retryable), not 400 (caller error)."""
    batcher = DynamicBatcher(predictor, max_batch=2, max_wait_ms=1.0)
    server, _ = _serve(batcher)
    broken = lambda reqs: (_ for _ in ()).throw(RuntimeError("device gone"))  # noqa: E731
    orig = batcher.predictor.predict
    try:
        batcher.predictor.predict = broken
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server.server_address[1], _npy(_image(4)))
        assert exc.value.code == 503
        assert batcher.stats()["errors"] == 1
    finally:
        batcher.predictor.predict = orig
        server.shutdown()
        server.server_close()
        batcher.close()


def test_batcher_close_fails_fast(predictor):
    batcher = DynamicBatcher(predictor, max_batch=2, max_wait_ms=1.0)
    batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(_image(5))


@pytest.fixture(scope="module")
def cls_predictor():
    net = ClassificationHRNet(C=8, num_classes=10, device="cpu", **TINY).eval()
    init_flax_default_(net, torch.Generator().manual_seed(0))
    im = InferenceClassificationModel(net, labels=[f"c{i}" for i in range(10)], input_size=64,
                                      device="cpu")
    return BatchedClassificationPredictor(im, top_k=3)


def test_batched_classification_matches_single_path(cls_predictor):
    """The classification serving payload's top-k agrees with the single-image
    InferenceClassificationModel pipeline on the same input."""
    raw = _image(11)
    payload = cls_predictor.predict([cls_predictor.prepare(raw)])[0]
    ref = cls_predictor.m(raw)

    assert len(payload["top"]) == 3
    order = np.argsort(-ref.probs, kind="stable")[:3]
    assert [t["label"] for t in payload["top"]] == [f"c{i}" for i in order]
    np.testing.assert_allclose([t["prob"] for t in payload["top"]], ref.probs[order], atol=1e-5)
    assert payload["pred"] == f"c{order[0]}"


def test_classification_batching_pads_po2(cls_predictor):
    """3 coalesced requests run as one padded batch (pad rows sliced off) and
    each result matches its own single-request payload."""
    reqs = [cls_predictor.prepare(_image(20 + i)) for i in range(3)]
    batched = cls_predictor.predict(reqs)
    singles = [cls_predictor.predict([q])[0] for q in reqs]
    assert len(batched) == 3
    for b, s in zip(batched, singles):
        assert b["pred"] == s["pred"]
        np.testing.assert_allclose([t["prob"] for t in b["top"]], [t["prob"] for t in s["top"]],
                                   atol=1e-5)


def test_http_classification_end_to_end(cls_predictor):
    """serve --task=classification: the HTTP layer is task-agnostic; the
    classification batcher returns top-k payloads over POST /predict."""
    batcher = DynamicBatcher(cls_predictor, max_batch=2, max_wait_ms=1.0)
    server, _ = _serve(batcher)
    try:
        status, out = _post(server.server_address[1], _npy(_image(12)))
        assert status == 200
        assert len(out["top"]) == 3 and "pred" in out
        assert "latency_ms" in out and out["batch_size"] >= 1
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_pending_settle_first_writer_wins():
    """A completed result can never be masked by a racing shutdown error
    (close()/late submit re-check go through the same settle gate)."""
    p = _Pending(req=None)
    assert p.settle(result={"people": []})
    assert not p.settle(error=RuntimeError("batcher is closed"))
    assert p.error is None and p.result == {"people": []}

    q = _Pending(req=None)
    assert q.settle(error=RuntimeError("boom"))
    assert not q.settle(result={"people": []})
    assert q.result is None and str(q.error) == "boom"


def test_timed_out_request_is_shed_not_computed(predictor):
    """A submit that times out must not still burn a device batch when the
    worker gets to it — overload has to actually shed load."""
    batcher = DynamicBatcher(predictor, max_batch=2, max_wait_ms=1.0)
    gate = threading.Event()
    orig = batcher.predictor.predict
    computed = []

    def slow_predict(reqs):
        gate.wait(30)
        computed.append(len(reqs))
        return orig(reqs)

    try:
        batcher.predictor.predict = slow_predict
        # first request occupies the worker inside slow_predict
        t1 = threading.Thread(target=lambda: batcher.submit(_image(6)))
        t1.start()
        time.sleep(0.3)  # worker is now parked in slow_predict
        # second request times out while still queued -> must be shed
        with pytest.raises(TimeoutError):
            batcher.submit(_image(7), timeout=0.2)
        gate.set()
        t1.join(timeout=120)
        # give the worker one drain cycle to observe the cancelled entry
        deadline = time.time() + 5
        while batcher.stats()["shed"] < 1 and time.time() < deadline:
            time.sleep(0.05)
    finally:
        batcher.predictor.predict = orig
        batcher.close()
    assert batcher.stats()["shed"] == 1
    assert sum(computed) == 1  # only the live request hit the device


def test_http_body_size_limits(predictor):
    """Oversized bodies 413, bad/absent Content-Length 400 — read() must
    never buffer an attacker-chosen number of bytes."""
    import http.client

    batcher = DynamicBatcher(predictor, max_batch=2, max_wait_ms=1.0)
    server, _ = _serve(batcher, max_body_bytes=1024)
    port = server.server_address[1]
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, b"x" * 2048)
        assert exc.value.code == 413

        # hand-rolled request: no Content-Length at all
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.putrequest("POST", "/predict", skip_accept_encoding=True)
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


# -- the port against JAX --------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_raws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ap_corpus") / "coco"
    raws, _ = train_batch_and_views(root, build_corpus(root))
    return raws[:3]


def test_keypoints_predictor_matches_jax(corpus_raws):
    """One padded batch of three of the AP corpus's images through both
    packages' predictors on the trained fixture: the same person counts, a
    median joint difference under 0.5 px (raw-image coordinates), person
    scores within 0.05, the same batch keys."""
    jax_im = JaxKeypointsModel(JaxHigherHRNet(num_kpts=K, C=8, s2d=False), load_trained_variables(),
                               **EVAL)
    jax_pred = jax_serving.BatchedKeypointsPredictor(jax_im)
    net = HigherHRNet(num_kpts=K, C=8, device="cpu").eval()
    net.load_state_dict(load_inference_weights(WEIGHTS_PATH))
    port_pred = BatchedKeypointsPredictor(InferenceKeypointsModel(net, **EVAL, device="cpu"))

    jax_reqs = [jax_pred.prepare(r) for r in corpus_raws]
    port_reqs = [port_pred.prepare(r) for r in corpus_raws]
    assert [r.key for r in port_reqs] == [r.key for r in jax_reqs]
    for got_r, want_r in zip(port_reqs, jax_reqs):
        np.testing.assert_array_equal(got_r.x, want_r.x)
    want = jax_pred.predict(jax_reqs)
    got = port_pred.predict(port_reqs)
    assert len(got) == len(want) == len(corpus_raws)
    for g, w in zip(got, want):
        assert g["num_people"] == w["num_people"] >= 2
        gk = np.asarray([p["keypoints"] for p in g["people"]])
        wk = np.asarray([p["keypoints"] for p in w["people"]])
        assert np.median(np.abs(gk[..., :2] - wk[..., :2])) < 0.5
        diff = np.abs(np.sort([p["score"] for p in g["people"]])
                      - np.sort([p["score"] for p in w["people"]]))
        assert diff.max() < 0.05, diff


def test_classification_predictor_matches_jax():
    """The same seeded C=8 classifier weights in both packages (the port's
    draw, carried to flax's tree by ``variables_from_state_dict``), three
    requests in one padded batch: top-5 labels equal, probabilities within
    1e-5."""
    net = ClassificationHRNet(C=8, num_classes=10, device="cpu", **TINY).eval()
    init_flax_default_(net, torch.Generator().manual_seed(0))
    labels = [f"c{i}" for i in range(10)]
    jax_pred = jax_serving.BatchedClassificationPredictor(JaxClassificationModel(
        JaxClassificationHRNet(C=8, num_classes=10, **TINY), variables_from_state_dict(net.state_dict()),
        labels=labels, input_size=64))
    port_pred = BatchedClassificationPredictor(
        InferenceClassificationModel(net, labels=labels, input_size=64, device="cpu"))

    raws = [_image(30 + i, 90 + 10 * i, 120) for i in range(3)]
    want = jax_pred.predict([jax_pred.prepare(r) for r in raws])
    got = port_pred.predict([port_pred.prepare(r) for r in raws])
    for g, w in zip(got, want):
        assert [t["label"] for t in g["top"]] == [t["label"] for t in w["top"]]
        assert len(g["top"]) == 5 and g["pred"] == w["pred"]
        np.testing.assert_allclose([t["prob"] for t in g["top"]], [t["prob"] for t in w["top"]],
                                   atol=1e-5)


def _bodies() -> dict:
    import cv2

    arr = _image(40, 20, 30)
    bgr = cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
    return {
        "npy": _npy(arr),
        "png": cv2.imencode(".png", bgr)[1].tobytes(),
        "jpeg": cv2.imencode(".jpg", bgr)[1].tobytes(),
        "garbage": b"garbage bytes",
        "npy_float": _npy(arr.astype(np.float32) / 255.0),
        "npy_gray": _npy(arr[..., 0]),
        "npy_rgba": _npy(np.concatenate([arr, arr[..., :1]], axis=-1)),
        "npy_fortran": _npy(np.asfortranarray(arr)),
        "gray_png": cv2.imencode(".png", arr[..., 0])[1].tobytes(),
    }


@pytest.mark.parametrize("name", list(_bodies()))
def test_decode_request_body_matches_jax(name):
    """Every body decodes to the same array in both packages, or both
    refuse it with the same error."""
    body = _bodies()[name]

    def run(fn):
        try:
            return fn(body), None
        except Exception as e:  # the refusal is the result here
            return None, (type(e), str(e))

    (got, got_err), (want, want_err) = run(decode_request_body), run(jax_serving.decode_request_body)
    assert got_err == want_err
    if want is not None:
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


# -- the port only ---------------------------------------------------------------------------

def test_predictors_refuse_other_models():
    """The duck-checks name the port's attributes: a classification model
    is not a keypoints model, and the other way round."""
    class NotAModel:
        pass

    with pytest.raises(TypeError, match="forward_scale"):
        BatchedKeypointsPredictor(NotAModel())
    with pytest.raises(TypeError, match="transform"):
        BatchedClassificationPredictor(NotAModel())


def test_padded_batch_decides_as_single_requests(predictor):
    """Five requests (padded to eight with zero images): every payload
    equals its request's single payload at the level of decisions (eval
    BatchNorm is per sample; a batch of another size may sum the
    convolutions in another order)."""
    reqs = [predictor.prepare(_image(50 + i)) for i in range(5)]
    batched = predictor.predict(reqs)
    assert len(batched) == 5
    for b, q in zip(batched, reqs):
        s = predictor.predict([q])[0]
        assert b["num_people"] == s["num_people"]
        for pb, ps in zip(b["people"], s["people"]):
            np.testing.assert_allclose(pb["keypoints"], ps["keypoints"], atol=0.05)
            assert abs(pb["score"] - ps["score"]) <= 5e-3


def test_worker_thread_runs_bf16_autocast_without_grad():
    """``predict`` from a plain thread: the forward's convolutions run in
    bfloat16 (the model enters its autocast per call, on the worker's own
    thread) and no output requires grad (the calls are ``no_grad``), though
    the calling thread has grad mode on and no autocast."""
    im = InferenceKeypointsModel(_tiny_net(), input_size=64, max_num_people=5,
                                 dtype=torch.bfloat16, device="cpu")
    pred = BatchedKeypointsPredictor(im)
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((o.dtype, o.requires_grad)))
             for m in im.model.modules() if isinstance(m, torch.nn.Conv2d)]
    tensors = []
    orig_decode = im.decode_masked

    def decode(*a, **kw):
        out = orig_decode(*a, **kw)
        tensors.extend(out)
        return out

    im.decode_masked = decode
    out = {}
    try:
        assert torch.is_grad_enabled()
        t = threading.Thread(target=lambda: out.setdefault("p", pred.predict(
            [pred.prepare(_image(60, 64, 64))] * 3)))
        t.start()
        t.join(timeout=120)
    finally:
        for h in hooks:
            h.remove()
        del im.decode_masked
    assert len(out["p"]) == 3
    assert seen and all(dtype == torch.bfloat16 and not grad for dtype, grad in seen)
    assert tensors and not any(x.requires_grad for x in tensors)


def test_healthz_reads_the_served_device(predictor, cls_predictor):
    from human_pose_tpu_torch.inference.serving import served_platform

    for p in (predictor, cls_predictor):
        batcher = DynamicBatcher(p, max_batch=1)
        try:
            assert served_platform(batcher) == "cpu"
        finally:
            batcher.close()


def test_bench_serve_on_the_cpu(capsys):
    record = bench_serve.main(["--tiny", "--device=cpu", "--concurrency=2", "--requests=2",
                               "--input_size=64", "--max_batch=2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert record["requests"] == 4 and record["platform"] == "cpu"
    assert 0 < record["p50_ms"] <= record["p95_ms"] <= record["p99_ms"]
    assert record["throughput_rps"] > 0 and 1 <= record["mean_batch_size"] <= 2


def test_serve_cli_answers_then_exits_on_sigterm(tmp_path):
    """``bin.serve`` as its own process on the CPU (a tiny net through the
    config's overrides): warm-up, one POST answered, exit 0 on SIGTERM."""
    argv = [sys.executable, "-m", "human_pose_tpu_torch.bin.serve",
            f"--config={ROOT / 'experiments/keypoints/higher_hrnet_32.yaml'}",
            "--trainer.accelerator=cpu", "--inference.ckpt_path=null", "--inference.input_size=64",
            "--net.params.C=8", "--net.params.num_blocks_per_stage=[1,1,1,1]",
            "--net.params.num_units=1", "--net.params.num_deconv_resid_blocks=1",
            "--host=127.0.0.1", "--port=0", "--max_batch=2", "--warmup=64x96"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(argv, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "serving keypoints on 127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split()[0])
        assert port, "".join(lines)
        assert any("warmed up 64x96" in line for line in lines)
        status, out = _post(port, _npy(_image(70, 64, 96)))
        assert status == 200 and "num_people" in out and out["batch_size"] == 1
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, "".join(lines) + rest
        assert "SIGTERM: shutting down server" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
