"""Dynamic-batching inference serving (port of
human_pose_tpu/inference/serving.py).

The reference ships only offline inference CLIs
(reference src/keypoints/bin/inference.py); a deployment wants one
process owning the card and coalescing concurrent requests into batched
device calls: the forward is batch-hungry, and the batch dim is padded to a
power of two so cuDNN sees a few batch shapes per input bucket (the server
reuses the inference model's 64-aligned / ``pad_multiple`` bucketing).

Three layers, no external deps:

* ``BatchedKeypointsPredictor`` — host preprocess into a bucket key, one
  batched forward+decode per same-bucket group (scale-1, optional flip TTA
  via the wrapped ``InferenceKeypointsModel``: one launch each of the
  grouping and the dense refine kernels a group on the card), inverse-affine
  back to raw-image coordinates, JSON-ready payload per request.
* ``DynamicBatcher`` — a worker thread drains the request queue up to
  ``max_batch`` / ``max_wait_ms``, groups by bucket, dispatches, and wakes the
  blocked request threads; keeps latency/batch-size counters.
* ``make_server`` — a ``ThreadingHTTPServer`` with POST ``/predict``
  (JPEG/PNG via cv2 or a raw ``.npy`` HxWx3 RGB array), GET ``/healthz``,
  ``/stats`` and ``/metrics``.

Every device call runs on the worker thread. Grad mode and autocast are
thread-local in PyTorch, so the inference models enter them per call
(``forward_scale``, ``decode_masked`` and ``probs`` are ``no_grad``, the
forward enters its autocast): nothing is entered on the worker's behalf.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from ..data.affine import get_multi_scale_size, transform_coords_inverse
from ..loggers.pylogger import log


def _pad_batch(reqs) -> np.ndarray:
    """The requests' host inputs concatenated, the batch dim padded with
    zeros up to the next power of two (their results are sliced off)."""
    assert len({r.key for r in reqs}) == 1, "mixed buckets in one batch"
    batch = np.concatenate([r.x for r in reqs], axis=0)
    n = batch.shape[0]
    n_pad = 1 << (n - 1).bit_length()
    if n_pad > n:
        batch = np.concatenate([batch, np.zeros((n_pad - n, *batch.shape[1:]), batch.dtype)])
    return batch


def _warmup(predictor, image: np.ndarray, max_batch: int) -> None:
    """Run every batch bucket ``predict`` can form for this image's shape
    bucket: 1, 2, 4, ... up to ``max_batch`` rounded up to a power of two."""
    req = predictor.prepare(image)
    n = 1
    while n <= 1 << (max_batch - 1).bit_length():
        predictor.predict([req] * n)
        n *= 2


@dataclass
class PreparedRequest:
    """Host-preprocessed image + the inverse-affine transform back to raw
    coordinates. ``key`` is the shape bucket (padded input shape plus the
    valid region the decode unmasks)."""

    x: np.ndarray  # [1, H, W, 3] normalized (uint8 with compact inputs), padded to the bucket
    center: np.ndarray
    scale: np.ndarray
    valid_hw: tuple
    key: tuple


class BatchedKeypointsPredictor:
    """Batched scale-1 predict over same-bucket inputs, wrapping an
    ``InferenceKeypointsModel`` (inference/models.py) without duplicating its
    resize/flip/decode pipeline."""

    def __init__(self, infer_model):
        # duck-check up front: an SPPE inference model has a different decode
        # path and cannot be batch-served by this predictor
        for attr in ("forward_scale", "decode_masked", "prepare_input", "to_device"):
            if not hasattr(infer_model, attr):
                raise TypeError(
                    f"{type(infer_model).__name__} lacks {attr}; the serving "
                    "batcher supports the bottom-up InferenceKeypointsModel "
                    "(HigherHRNet) only"
                )
        self.m = infer_model

    def prepare(self, image: np.ndarray) -> PreparedRequest:
        x, center, scale = self.m.prepare_input(image)
        # valid region = the 64-aligned size before pad_multiple bucketing
        # (size computation only — no second warpAffine of the raw image)
        (vw, vh), _, _ = get_multi_scale_size(image, self.m.input_size, 1.0, 1.0)
        valid_hw = (vh, vw)
        key = (x.shape[1], x.shape[2], valid_hw)
        return PreparedRequest(x, center, scale, valid_hw, key)

    def warmup(self, image: np.ndarray, max_batch: int) -> None:
        """Run every batch bucket ``predict`` can form for this image's
        shape bucket (cuDNN's plans and the allocator settle before live
        requests)."""
        _warmup(self, image, max_batch)

    def predict(self, reqs: list[PreparedRequest]) -> list[dict]:
        """One batched device call for a same-``key`` group, the batch dim
        padded to a power of two (pad images are zeros; eval BatchNorm is
        per sample, so they do not change the real images' results, and
        their decoded junk is sliced off). Joints, scores and valid flags
        come to the host once a batch."""
        batch = _pad_batch(reqs)
        hw = batch.shape[1:3]
        avg, tags_list = self.m.forward_scale(self.m.to_device(batch), hw)
        joints, scores, valid, _ = self.m.decode_masked(
            avg, tags_list, hw, 1.0, valid_hw=reqs[0].valid_hw
        )
        joints, scores, valid = joints.cpu().numpy(), scores.cpu().numpy(), valid.cpu().numpy()
        out = []
        for i, r in enumerate(reqs):
            vh, vw = r.valid_hw
            ji = joints[i][valid[i]]
            coords = ji[..., :2]
            if len(coords):
                coords = transform_coords_inverse(coords, r.center, r.scale, (vw, vh))
            out.append(
                {
                    "people": [
                        {
                            "keypoints": np.concatenate(
                                [coords[p], ji[p, :, 2:3]], axis=-1
                            ).round(2).tolist(),
                            "score": float(scores[i][valid[i]][p]),
                        }
                        for p in range(len(ji))
                    ],
                    "num_people": int(len(ji)),
                }
            )
        return out


@dataclass
class PreparedClassRequest:
    """Host-preprocessed classification input (fixed-size center crop, so all
    requests share one shape bucket per ``input_size``)."""

    x: np.ndarray  # [1, S, S, 3] normalized (uint8 with compact inputs)
    key: tuple


class BatchedClassificationPredictor:
    """Batched classification predict wrapping ``InferenceClassificationModel``
    (inference/models.py) — the classification counterpart of
    ``BatchedKeypointsPredictor`` for ``DynamicBatcher``/``make_server``."""

    def __init__(self, infer_model, top_k: int = 5):
        for attr in ("transform", "probs", "labels", "to_device"):
            if not hasattr(infer_model, attr):
                raise TypeError(
                    f"{type(infer_model).__name__} lacks {attr}; expected an "
                    "InferenceClassificationModel"
                )
        self.m = infer_model
        self.top_k = top_k

    def prepare(self, image: np.ndarray) -> PreparedClassRequest:
        x = np.asarray(self.m.transform.inference(image))[None]
        return PreparedClassRequest(x, x.shape[1:3])

    def warmup(self, image: np.ndarray, max_batch: int) -> None:
        _warmup(self, image, max_batch)

    def predict(self, reqs: list[PreparedClassRequest]) -> list[dict]:
        probs = self.m.probs(self.m.to_device(_pad_batch(reqs))).cpu().numpy()
        out = []
        for i in range(len(reqs)):
            p = probs[i].astype(np.float64)
            top = np.argsort(-p, kind="stable")[: self.top_k]
            out.append(
                {
                    "top": [
                        {"label": self.m.labels[j], "prob": round(float(p[j]), 6)}
                        for j in top
                    ],
                    "pred": self.m.labels[int(top[0])],
                }
            )
        return out


@dataclass
class _Pending:
    req: PreparedRequest
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None
    t_enqueue: float = field(default_factory=time.perf_counter)
    # set when the submitter gave up (timeout): the worker drops the entry at
    # batch-forming time instead of burning a device slot on a request whose
    # client already got its 503
    cancelled: threading.Event = field(default_factory=threading.Event)
    _settle_lock: threading.Lock = field(default_factory=threading.Lock)

    def settle(self, result=None, error=None) -> bool:
        """First writer wins: worker success, worker error, and close()/late
        shutdown failure all funnel through here, so a completed result can
        never be overwritten by a racing 'batcher is closed' error."""
        with self._settle_lock:
            if self.done.is_set():
                return False
            self.result = result
            self.error = error
            self.done.set()
            return True


class DynamicBatcher:
    """Coalesce concurrent ``submit`` calls into batched ``predict`` calls.

    The worker drains up to ``max_batch`` requests or waits ``max_wait_ms``
    after the first, then runs one device call per shape bucket present.
    ``submit`` blocks the calling thread until its result is ready.
    """

    def __init__(
        self,
        predictor: BatchedKeypointsPredictor,
        max_batch: int = 16,
        max_wait_ms: float = 5.0,
    ):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.counters = {
            "requests": 0, "batches": 0, "errors": 0, "shed": 0,
            "latency_ms_sum": 0.0, "latency_ms_max": 0.0,
        }
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, image: np.ndarray, timeout: float = 600.0) -> dict:
        # generous enough for a cold bucket (cuDNN's plans, the kernels'
        # build at first use); use --warmup in bin/serve.py to avoid paying
        # it on a live request
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        p = _Pending(self.predictor.prepare(image))
        self._q.put(p)
        # re-check AFTER the put: close() may have drained the queue between
        # the check above and the put, in which case nothing will ever read
        # this entry — fail it now instead of sleeping out the full timeout
        # (settle() is a no-op if the worker finished it first)
        if self._stop.is_set():
            p.settle(error=RuntimeError("batcher is closed"))
        if not p.done.wait(timeout):
            p.cancelled.set()  # worker drops it instead of computing for nobody
            raise TimeoutError("inference request timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(group) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            by_key: dict[tuple, list[_Pending]] = {}
            n_shed = 0
            for p in group:
                if p.cancelled.is_set():  # submitter timed out: shed the load
                    n_shed += 1
                    continue
                by_key.setdefault(p.req.key, []).append(p)
            if n_shed:
                with self._lock:
                    self.counters["shed"] += n_shed
            for ps in by_key.values():
                try:
                    results = self.predictor.predict([p.req for p in ps])
                    now = time.perf_counter()
                    with self._lock:
                        self.counters["batches"] += 1
                        self.counters["requests"] += len(ps)
                    for p, r in zip(ps, results):
                        r["batch_size"] = len(ps)
                        lat = (now - p.t_enqueue) * 1e3
                        r["latency_ms"] = round(lat, 2)
                        with self._lock:
                            self.counters["latency_ms_sum"] += lat
                            self.counters["latency_ms_max"] = max(
                                self.counters["latency_ms_max"], lat
                            )
                        p.settle(result=r)
                except BaseException as e:  # propagate to the request thread
                    with self._lock:
                        self.counters["errors"] += len(ps)
                    for p in ps:
                        p.settle(error=e)

    def stats(self) -> dict:
        with self._lock:
            c = dict(self.counters)
        c["mean_batch_size"] = round(c["requests"] / max(c["batches"], 1), 2)
        c["mean_latency_ms"] = round(c["latency_ms_sum"] / max(c["requests"], 1), 2)
        return c

    def metrics_text(self) -> str:
        """Prometheus text exposition of the stats counters (GET /metrics).
        Counter/gauge naming follows prometheus conventions; scrapers get the
        same numbers /stats serves as JSON."""
        s = self.stats()
        spec = [
            ("serving_requests_total", "counter", "requests handled", s["requests"]),
            ("serving_batches_total", "counter", "device batches dispatched", s["batches"]),
            ("serving_errors_total", "counter", "failed requests", s["errors"]),
            ("serving_shed_total", "counter", "requests shed after caller timeout", s["shed"]),
            ("serving_latency_ms_sum", "counter", "summed request latency (ms)", s["latency_ms_sum"]),
            ("serving_latency_ms_max", "gauge", "max request latency (ms)", s["latency_ms_max"]),
            ("serving_mean_batch_size", "gauge", "requests per device batch", s["mean_batch_size"]),
        ]
        lines = []
        for name, kind, help_, val in spec:
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} {kind}", f"{name} {val}"]
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=2.0)
        # fail anything still queued so blocked submitters wake immediately
        # instead of sleeping out their full timeout
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.settle(error=RuntimeError("batcher closed while request was queued"))


def decode_request_body(body: bytes) -> np.ndarray:
    """JPEG/PNG (cv2, returned RGB) or a raw ``.npy`` HxWx3 uint8 RGB array."""
    if body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        import cv2

        bgr = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("request body is neither .npy nor a decodable image")
        arr = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected HxWx3 RGB, got {arr.shape}")
    if arr.dtype != np.uint8:
        # enforce the documented contract: a float [0,1] array would sail
        # through normalize as near-black pixels and return garbage with a 200
        raise ValueError(f"expected uint8 pixels, got dtype {arr.dtype}")
    return np.ascontiguousarray(arr)


def served_platform(batcher: DynamicBatcher) -> str:
    """``"gpu"`` when the served model is on a CUDA device (the name JAX
    gives a GPU's platform), else ``"cpu"``."""
    return "gpu" if batcher.predictor.m.device.type == "cuda" else "cpu"


def make_server(
    batcher: DynamicBatcher,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_body_bytes: int = 64 * 1024 * 1024,
):
    """Build (not run) the HTTP server; ``server.serve_forever()`` to run.

    ``max_body_bytes`` caps POST bodies (default 64 MiB ≈ a 4600x4600 uint8
    .npy frame): the body is read fully into memory, so an unchecked
    Content-Length would let one request OOM the process that owns the card."""
    platform = served_platform(batcher)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "platform": platform})
            elif self.path == "/stats":
                self._send(200, batcher.stats())
            elif self.path == "/metrics":
                body = batcher.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"no route {self.path}"})
                return
            # malformed input -> 400; server-side failures -> 503 (retryable)
            # so load balancers don't misread an overloaded/broken server as
            # a caller error
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, {"error": "invalid Content-Length"})
                return
            if n <= 0:  # negative would make read(-1) block until EOF
                self._send(400, {"error": "missing or invalid Content-Length"})
                return
            if n > max_body_bytes:
                self._send(413, {"error": f"body exceeds {max_body_bytes} bytes"})
                return
            try:
                image = decode_request_body(self.rfile.read(n))
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                self._send(200, batcher.submit(image))
            except Exception as e:
                self._send(503, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            log.info(f"serve: {self.address_string()} {fmt % args}")

    return ThreadingHTTPServer((host, port), Handler)
