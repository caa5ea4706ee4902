"""The port's decomposition benchmark (``human_pose_tpu_torch/bin/bench_decompose.py``)
vs the JAX package's ``bin/bench_decompose.py``, on the CPU.

The sparse maps: the port's ``sparse_heatmaps`` on the very draws JAX's
``_sparse_heatmaps`` makes (its three ``jax.random`` calls repeated on the
same key) equals JAX's maps. The decode stages: the port's decode (plain
versions of the kernels) on JAX's sparse maps and on NumPy-seeded noise
maps, against JAX's ``decode_batch`` on the same maps, at the tolerances of
``tests/test_torch_port_decode.py`` (same persons; coordinates and scores
within 1e-3). One shape (batch 2, quarter 16^2, half 32^2), so JAX's decode
compiles once.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.bin import bench_decompose as jax_bench
from human_pose_tpu.ops import decode_batch as jax_decode_batch
from human_pose_tpu_torch.bin import bench_decompose
from human_pose_tpu_torch.models import HigherHRNet
from tests.jax_reference import light_jax_reference  # noqa: F401

B, K, SIZE = 2, 17, 64
HQ, HH = SIZE // 4, SIZE // 2


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _jax_sparse(seed: int, size: int):
    """JAX's ``_sparse_heatmaps(PRNGKey(seed), B, size, K)`` (NHWC) and its
    three draws, repeated on the same key."""
    key = jax.random.PRNGKey(seed)
    hm, tags = jax_bench._sparse_heatmaps(key, B, size, K)
    rngs = jax.random.split(key, 3)
    cy = jax.random.uniform(rngs[0], (B, 4, K), minval=0.1 * size, maxval=0.9 * size)
    cx = jax.random.uniform(rngs[1], (B, 4, K), minval=0.1 * size, maxval=0.9 * size)
    z = jax.random.normal(rngs[2], (B, K, size, size))
    return (hm, tags), tuple(torch.from_numpy(np.array(a)) for a in (cy, cx, z))


@pytest.mark.parametrize("seed,size", [(1, HQ), (2, HH)])
def test_sparse_heatmaps_equal_jax(seed, size):
    """The maps from JAX's own centres and tags: heatmaps within 1e-6 (the
    two frameworks' ``exp`` differ by ulps), tags equal."""
    (hm, tags), (cy, cx, z) = _jax_sparse(seed, size)
    got_hm, got_tags = bench_decompose.sparse_heatmaps(cy, cx, z, size, size)
    assert got_hm.dtype == torch.float32 and tuple(got_hm.shape) == (B, K, size, size)
    np.testing.assert_allclose(got_hm.numpy(), _nchw(hm).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_tags.numpy(), _nchw(tags).numpy())
    assert float(got_hm.amax()) > 0.9


def _noise_maps():
    rng = np.random.RandomState(3)
    return (rng.rand(B, HQ, HQ, K).astype(np.float32), rng.rand(B, HH, HH, K).astype(np.float32),
            rng.randn(B, HQ, HQ, K).astype(np.float32))


def _decode_both(quarter, half, tags):
    """JAX's ``decode_batch`` and the port's ``decode_maps`` on the same
    NHWC maps, at the benchmark's arguments."""
    want = jax_decode_batch([jnp.asarray(quarter), jnp.asarray(half)], [jnp.asarray(tags)],
                            input_hw=(SIZE, SIZE), **bench_decompose.DECODE)
    got = bench_decompose.decode_maps(_nchw(quarter), _nchw(half), _nchw(tags), SIZE)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("maps", ["sparse", "noise"])
def test_decode_stage_equals_jax(maps):
    """``decode_sparse`` on JAX's sparse maps (keys 1 and 2, as its bench)
    and ``decode_noise`` on uniform heatmaps and unit-normal tags: the same
    persons, coordinates and scores within 1e-3. Noise puts all 30 of each
    joint's candidates above ``det_thr`` and fills all 30 person slots."""
    if maps == "sparse":
        quarter, tags = (np.asarray(a) for a in jax_bench._sparse_heatmaps(jax.random.PRNGKey(1), B, HQ, K))
        half = np.asarray(jax_bench._sparse_heatmaps(jax.random.PRNGKey(2), B, HH, K)[0])
    else:
        quarter, half, tags = _noise_maps()
    (jj, js, jv), (tj, ts, tv) = _decode_both(quarter, half, tags)
    np.testing.assert_array_equal(tv, jv)
    assert tv.all() if maps == "noise" else tv.sum() >= B
    np.testing.assert_allclose(tj[tv][..., :3], jj[jv][..., :3], atol=1e-3)
    np.testing.assert_allclose(ts[tv], js[jv], atol=1e-3)


def test_map_draws_and_jitter():
    """The port's own draws: seeded (the same maps twice), on the given
    device, noise in [0, 1) with tags of unit scale; the sparse stages at
    1/4 and 1/2 of the input; the maps' jitter is JAX's float32 product."""
    a = bench_decompose.bench_maps(B, SIZE, "cpu")
    b = bench_decompose.bench_maps(B, SIZE, "cpu")
    for stage in ("decode_sparse", "decode_noise"):
        assert all(torch.equal(x, y) for x, y in zip(a[stage], b[stage]))
        assert [tuple(x.shape) for x in a[stage]] == [(B, K, HQ, HQ), (B, K, HH, HH), (B, K, HQ, HQ)]
    q, h, t = a["decode_noise"]
    assert 0 <= float(q.min()) and float(h.max()) < 1 and 0.8 < float(t.std()) < 1.2
    assert bench_decompose.map_jitter(7) == float(np.float32(7) * np.float32(1e-6))


def test_cli_on_cpu(monkeypatch, capsys):
    """``--device=cpu`` at a tiny size (the shallow C=8 net in place of
    W32): four records in JAX's stage order with JAX's keys, finite."""
    monkeypatch.setattr(bench_decompose, "HigherHRNet", lambda **kw: HigherHRNet(
        **{**kw, "C": 8, "num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1,
           "num_deconv_resid_blocks": 1}))
    recs = bench_decompose.main(["--batch=1", "--iters=2", f"--size={SIZE}", "--device=cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == recs
    assert [r["stage"] for r in recs] == ["forward", "decode_sparse", "decode_noise", "e2e"]
    for r in recs:
        assert set(r) == {"stage", "ms_per_img", "img_per_s", "platform"} and r["platform"] == "cpu"
        assert np.isfinite(r["ms_per_img"]) and r["ms_per_img"] > 0
        assert abs(r["img_per_s"] * r["ms_per_img"] - 1e3) < 1e-6 * 1e3


def test_timed_raises_on_nan_and_refuses_missing_card():
    """A NaN in the accumulated sum raises, as JAX's ``_timed`` asserts;
    without a card the default device raises."""
    with pytest.raises(FloatingPointError):
        bench_decompose.timed(lambda i: torch.tensor(float("nan")), 2, torch.device("cpu"))
    with pytest.raises(SystemExit):
        bench_decompose.main(["--batchsize=2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench_decompose.main(["--batch=1", "--iters=1", "--size=64"])
