"""The port's slice end to end vs the JAX package: the trained C=8 fixture
HigherHRNet (tests/data/ap_fixture_weights.npz) + the full decode.

The image is painted like the AP fixture's (two persons in tinted bands,
joint-coloured discs) from a seed, goes through the uint8 input path of both
packages, the float32 forward and ``decode_batch``. The frameworks' convs and
resizes sum in different orders, so the check is at the level of decisions,
with run-invariant statistics as in tests/test_reference_e2e_parity.py:
median coordinate difference and sorted person-score bounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.ops import decode_batch as jax_decode_batch
from human_pose_tpu.ops.images import prep_images as jax_prep_images
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.ops import decode_batch, prep_images
from human_pose_tpu_torch.utils import load_flax_npz
from tests.ap_fixture import load_trained_variables
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)

SIZE = 64


def paint_images(seed: int, n: int = 2) -> np.ndarray:
    """uint8 NHWC images: per band a person tint and 17 coloured discs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    imgs = (rng.rand(n, SIZE, SIZE, 3) * 25).astype(np.float32)
    colors = rng.randint(60, 256, (9, 3))
    for i in range(n):
        for band, tint in enumerate(((20, 50, 20), (50, 20, 50))):
            y0 = band * SIZE // 2
            imgs[i, y0:y0 + SIZE // 2] += tint
            for k in range(17):
                cx = rng.randint(4, SIZE - 4)
                cy = y0 + rng.randint(4, SIZE // 2 - 4)
                disc = (xx - cx) ** 2 + (yy - cy) ** 2 <= 9
                imgs[i][disc] = colors[0 if k == 0 else 1 + (k - 1) // 2]
    return np.clip(imgs, 0, 255).astype(np.uint8)


def test_fixture_model_decode_matches_jax():
    images = paint_images(0)

    model = JaxHigherHRNet(num_kpts=17, C=8, s2d=False)
    variables = load_trained_variables()
    hms_j, tags_j = model.apply(variables, jax_prep_images(jnp.asarray(images)), train=False)
    jj, js, jv = jax_decode_batch(hms_j, [tags_j], input_hw=(SIZE, SIZE),
                                  max_num_people=30, det_thr=0.05, tag_thr=0.5)

    net = HigherHRNet(num_kpts=17, C=8, device="cpu").eval()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in load_flax_npz(
        "tests/data/ap_fixture_weights.npz").items()})
    x = prep_images(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    with torch.no_grad():
        hms_t, tags_t = net(x)
    tj, ts, tv = decode_batch(hms_t, [tags_t], (SIZE, SIZE), max_num_people=30,
                              det_thr=0.05, tag_thr=0.5)

    # 1. decode inputs: the forward agrees tightly (float32 on both sides)
    for a, b in zip([*hms_j, tags_j], [*hms_t, tags_t]):
        a = np.asarray(a).transpose(0, 3, 1, 2)
        assert np.abs(b.numpy() - a).max() / max(np.abs(a).max(), 1e-3) < 2e-4

    # 2. decisions: same person counts, the same joints almost everywhere
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    assert tv.sum() >= 2  # the trained net finds people
    for i in range(len(images)):
        pj, pt = np.asarray(jj)[i][jv[i]], tj[i].numpy()[tv[i]]
        assert np.median(np.abs(pt[..., :2] - pj[..., :2])) < 0.5
        score_diff = np.abs(np.sort(ts[i].numpy()[tv[i]]) - np.sort(np.asarray(js)[i][jv[i]]))
        assert score_diff.max() < 0.05, score_diff
