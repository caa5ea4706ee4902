"""The port's keypoints training input pipeline against the JAX package, on
the CPU: targets (the native splat and its plain NumPy loop), the training
affine and transforms, ``CocoKeypointsDataset.__getitem__`` (plain, compact
and mosaic), ``collate``, ``DataLoader`` batch streams (shuffled, sharded,
resumed; producer errors and early exit) and ``DevicePrefetcher`` on the
CPU.

Both packages read one synthesized COCO directory (``train2017`` and
``val2017``: small seeded jpgs, 1-4 persons, a crowd region and a
zero-keypoint object), pre-baked by the port. The same NumPy generator
calls and the same cv2 calls make every sample equal bit for bit; the
native splat is held to its plain version at 1e-6, as the JAX package's own
test holds its extension.
"""

from __future__ import annotations

import json
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from human_pose_tpu.data import CocoKeypointsDataset as JaxCocoKeypointsDataset
from human_pose_tpu.data import collate as jax_collate
from human_pose_tpu.data import native as jax_native
from human_pose_tpu.data import targets as jax_targets
from human_pose_tpu.data import transforms as jax_transforms
from human_pose_tpu.data.affine import get_aug_affine_matrix as jax_get_aug_affine_matrix
from human_pose_tpu.data.loader import DataLoader as JaxDataLoader
from human_pose_tpu_torch.data import (
    CocoKeypointsDataset, DataLoader, HeatmapGenerator, JointsGenerator, collate,
    get_aug_affine_matrix, prebake_annotations, transforms,
)
from human_pose_tpu_torch.train import DeviceBatch, DevicePrefetcher, host_batch_to_device

K = 17
OUT = 128
N_TRAIN, N_VAL = 8, 4
SIZES = ((96, 128), (160, 120), (128, 128), (112, 160))


def _rle(mask: np.ndarray) -> dict:
    """Uncompressed COCO RLE of a bool mask (column-major runs, zeros first)."""
    flat = mask.flatten(order="F").astype(np.uint8)
    counts, value, run = [], 0, 0
    for v in flat:
        if v != value:
            counts.append(run)
            value, run = v, 0
        run += 1
    counts.append(run)
    return {"counts": counts, "size": list(mask.shape)}


def make_coco_split(root, split: str, n: int, seed: int) -> None:
    """``n`` seeded jpgs of ``SIZES`` with 1-4 persons (about one keypoint
    in five not visible, some off the image after augmentation); image 0
    also has a crowd region (RLE) and image 1 a zero-keypoint object, so
    the masks are not all ones."""
    rs = np.random.RandomState(seed)
    (root / "images" / split).mkdir(parents=True)
    (root / "annotations").mkdir(exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        h, w = SIZES[i % len(SIZES)]
        img = cv2.resize(rs.randint(0, 256, (h // 8, w // 8, 3)).astype(np.uint8), (w, h))
        name = f"{i + 1:012d}.jpg"
        cv2.imwrite(str(root / "images" / split / name), img)
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        for _ in range(rs.randint(1, 5)):
            vis = rs.rand(K) > 0.2
            kpts = np.zeros((K, 3), np.int64)
            kpts[:, 0], kpts[:, 1] = rs.randint(2, w - 2, K), rs.randint(2, h - 2, K)
            kpts[:, 2] = np.where(vis, 2, 0)
            kpts[~vis, :2] = 0
            x0, y0 = int(rs.randint(0, w // 2)), int(rs.randint(0, h // 2))
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1,
                "keypoints": kpts.ravel().tolist(), "num_keypoints": int(vis.sum()), "iscrowd": 0,
                "area": float(w * h / 9), "bbox": [x0, y0, w // 3, h // 3],
                "segmentation": [[x0, y0, x0 + w // 3, y0, x0 + w // 3, y0 + h // 3, x0, y0 + h // 3]]})
        if i < 2:
            region = np.zeros((h, w), bool)
            region[h // 4: h // 2, w // 3: 3 * w // 4] = True
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1,
                "keypoints": [0] * (3 * K), "num_keypoints": 0, "iscrowd": 1 - i,
                "area": float(region.sum()), "bbox": [w // 3, h // 4, w // 2, h // 4],
                "segmentation": _rle(region) if i == 0 else
                [[w // 3, h // 4, 3 * w // 4, h // 4, 3 * w // 4, h // 2, w // 3, h // 2]]})
    (root / "annotations" / f"person_keypoints_{split}.json").write_text(
        json.dumps({"images": images, "annotations": annotations}))
    prebake_annotations(str(root), split)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_train")
    make_coco_split(root, "train2017", N_TRAIN, 0)
    make_coco_split(root, "val2017", N_VAL, 1)
    return root


def _datasets(root, split="train2017", compact=False, mosaic=0.0, train=True, out_size=OUT):
    """The port's and JAX's datasets over one directory with the same
    training (or inference) transform."""
    tk = dict(out_size=out_size, hm_resolutions=(0.25, 0.5), normalize=not compact)
    pt, jt = transforms.KeypointsTransform(**tk), jax_transforms.KeypointsTransform(**tk)
    common = dict(out_size=out_size, max_num_people=5, compact=compact, mosaic_probability=mosaic)
    return (CocoKeypointsDataset(str(root), split, pt.train if train else pt.inference, **common),
            JaxCocoKeypointsDataset(str(root), split, jt.train if train else jt.inference, **common))


def _assert_same(got, want, path="sample"):
    """Equal structure, dtypes and values, bit for bit."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}.{key}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


# -- targets ------------------------------------------------------------------

def _seeded_joints(seed: int, size: int, p: int = 6) -> np.ndarray:
    """int32 ``[p, K, 3]`` with coordinates 3 past every edge and vis in
    {0, 1, 2}: out-of-bounds and invisible joints included."""
    rs = np.random.RandomState(seed)
    return np.stack([rs.randint(-3, size + 3, (p, K)), rs.randint(-3, size + 3, (p, K)),
                     rs.randint(0, 3, (p, K))], -1).astype(np.int32)


@pytest.mark.parametrize("size,sigma", [(32, 2.0), (128, 2.0), (64, 1.0), (64, 3.0)])
def test_heatmap_generator_matches_jax(size, sigma, monkeypatch):
    """The native splat (what the dataset calls) against its plain NumPy
    loop and against JAX's native and NumPy paths: within 1e-6 (the JAX
    package's own tolerance; the largest difference seen is printed, 0 at
    every case here); the plain loop equals JAX's NumPy loop bit for bit."""
    assert jax_native.HAVE_NATIVE, "the JAX package's extension is built in this checkout"
    gen, ref = HeatmapGenerator(K, size, sigma), jax_targets.HeatmapGenerator(K, size, sigma)
    for seed in range(3):
        joints = _seeded_joints(seed, size)
        native, plain = gen(joints), gen.plain(joints)
        jax_native_out = ref(joints)
        monkeypatch.setattr(jax_targets, "HAVE_NATIVE", False)
        jax_plain = ref(joints)
        monkeypatch.setattr(jax_targets, "HAVE_NATIVE", True)
        assert native.shape == (size, size, K) and native.dtype == np.float32
        diff = max(float(np.abs(native - plain).max()), float(np.abs(native - jax_native_out).max()))
        print(f"splat size {size} sigma {sigma} seed {seed}: largest difference {diff}")
        assert diff <= 1e-6
        _assert_same(plain, jax_plain)
    assert gen.native_calls == 3
    # no persons: zeros from both paths
    empty = np.zeros((0, K, 3), np.int32)
    _assert_same(gen(empty), ref(empty))


def test_native_splat_refusals():
    from human_pose_tpu_torch.data.native import splat_heatmaps_native

    for joints, size, sigma in ((np.zeros((2, K), np.int32), 8, 2.0),
                                (np.zeros((1, K, 3), np.int32), 0, 2.0),
                                (np.zeros((1, K, 3), np.int32), 8, 0.0)):
        with pytest.raises(ValueError):
            splat_heatmaps_native(joints, size, sigma)


def test_joints_generator_matches_jax():
    """Float joints off the map, with vis 0, truncated to integers, empty
    persons dropped and more persons than the cap: equal arrays."""
    rs = np.random.RandomState(5)
    gen, ref = JointsGenerator(32, 4), jax_targets.JointsGenerator(32, 4)
    for p in (0, 3, 9):
        joints = np.stack([rs.uniform(-4, 36, (p, K)), rs.uniform(-4, 36, (p, K)),
                           rs.randint(0, 3, (p, K))], -1)
        joints[: p // 3, :, 2] = 0
        _assert_same(gen(joints), ref(joints))


# -- affine and transforms ---------------------------------------------------------

@pytest.mark.parametrize("rot", [0.0, 17.5, -30.0])
def test_aug_affine_matrix_matches_jax(rot):
    for center, scale, res in (((64.0, 48.5), 0.8, (128, 128)), ((10, 200), 2.3, (32, 64))):
        _assert_same(get_aug_affine_matrix(center, scale, res, rot),
                     jax_get_aug_affine_matrix(center, scale, res, rot))


def _transform_inputs(seed: int):
    rs = np.random.RandomState(seed)
    image = cv2.resize(rs.randint(0, 256, (12, 16, 3)).astype(np.uint8), (160, 120))
    mask = rs.rand(120, 160) > 0.1
    joints = np.stack([rs.uniform(0, 160, (3, K)), rs.uniform(0, 120, (3, K)),
                       rs.randint(0, 3, (3, K))], -1)
    return image, [mask.astype(np.float32) for _ in range(2)], [joints.copy() for _ in range(2)]


TRANSFORMS = {
    "affine": lambda m: m.RandomAffineTransform(OUT, [32, 64], 30, 0.7, 1.6, "short", 40),
    "affine_long": lambda m: m.RandomAffineTransform(OUT, [32, 64], 0, 1, 1, "long", 0),
    "flip": lambda m: m.RandomHorizontalFlip(m.COCO_FLIP_INDEX, [32, 64], 0.5),
    "normalize": lambda m: m.NormalizeKeypoints(),
    "train": lambda m: m.KeypointsTransform(OUT).train,
    "train_uint8": lambda m: m.KeypointsTransform(OUT, normalize=False).train,
    "inference": lambda m: m.KeypointsTransform(OUT).inference,
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    """Each transform on the same inputs with generators of one seed: the
    image, masks and joints equal bit for bit, and both generators end in
    the same state (the same draws, in the same order)."""
    for seed in range(4):
        rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = TRANSFORMS[name](transforms)(*_transform_inputs(seed), rng)
        want = TRANSFORMS[name](jax_transforms)(*_transform_inputs(seed), jax_rng)
        _assert_same(got, want, name)
        assert rng.random() == jax_rng.random()


def test_transform_refusals():
    with pytest.raises(ValueError, match="scale_type"):
        transforms.RandomAffineTransform(OUT, [32], scale_type="middle")


# -- the dataset and collate ----------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "compact", "mosaic", "val"])
def test_getitem_matches_jax(coco_root, case):
    """Every training sample (the val split's inference transform for
    ``val``) with the loader's per-sample generator: image, heatmaps at both
    scales, masks and joints equal bit for bit, dtypes included (compact:
    uint8, float16, bool). The crowd regions leave masks that are not all
    ones."""
    kw = {"plain": {}, "compact": {"compact": True}, "mosaic": {"mosaic": 1.0},
          "val": {"split": "val2017", "train": False}}[case]
    ds, ref = _datasets(coco_root, **kw)
    assert len(ds) == len(ref) == (N_VAL if case == "val" else N_TRAIN)
    masked = 0
    for idx in range(len(ds)):
        got = ds.__getitem__(idx, np.random.default_rng((7, 0, idx)))
        want = ref.__getitem__(idx, np.random.default_rng((7, 0, idx)))
        _assert_same(got, want, f"{case}[{idx}]")
        masked += int((np.asarray(got[2][0]) == 0).sum())
        if case == "compact":
            assert got[0].dtype == np.uint8 and got[1][0].dtype == np.float16 and got[2][0].dtype == bool
    assert masked > 0
    assert all(g.native_calls == len(ds) for g in ds.hm_generators)


def test_compact_dataset_refuses_normalized_image(coco_root):
    """A compact dataset whose transform normalizes (a float image) raises,
    as JAX's: the device step normalizes integer images only."""
    tk = transforms.KeypointsTransform(OUT)
    ds = CocoKeypointsDataset(str(coco_root), "train2017", tk.train, out_size=OUT, compact=True)
    with pytest.raises(ValueError, match="uint8"):
        ds.__getitem__(0, np.random.default_rng(0))


@pytest.mark.parametrize("compact", [False, True])
def test_collate_matches_jax(coco_root, compact):
    ds, _ = _datasets(coco_root, compact=compact)
    samples = [ds.__getitem__(i, np.random.default_rng(i)) for i in range(3)]
    got = collate(samples)
    _assert_same(got, jax_collate(samples))
    assert got["images"].shape == (3, OUT, OUT, 3) and got["heatmaps"][1].shape == (3, 64, 64, K)
    assert got["masks"][0].shape == (3, 32, 32) and got["joints"].shape == (3, 5, K, 3)


# -- the loader ---------------------------------------------------------------------

def _stream(dl, epochs=(0, 1)) -> list:
    out = []
    for epoch in epochs:
        dl.set_epoch(epoch)
        out.extend(list(dl))
    return out


LOADER_CASES = {
    "shuffled": dict(batch_size=3, shuffle=True),
    "ordered_ragged": dict(batch_size=3, shuffle=False, drop_last=False),
    "shard0": dict(batch_size=2, shuffle=True, process_index=0, process_count=2),
    "shard1": dict(batch_size=2, shuffle=True, process_index=1, process_count=2, drop_last=False),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_stream_matches_jax(coco_root, case):
    """Two epochs of batches from threaded workers: equal to JAX's loader's
    over the same dataset, batch for batch, bit for bit."""
    ds, ref = _datasets(coco_root)
    kw = dict(collate_fn=collate, num_workers=3, seed=11, **LOADER_CASES[case])
    dl = DataLoader(ds, **kw)
    jdl = JaxDataLoader(ref, **{**kw, "collate_fn": jax_collate})
    assert len(dl) == len(jdl) > 0
    _assert_same(_stream(dl), _stream(jdl), case)


def test_loader_resumes_from_state_dict(coco_root):
    """A fresh loader restored from another's ``state_dict`` at epoch 1
    replays epoch 1 of the first, and JAX's loader restored from the same
    state gives the same batches."""
    ds, ref = _datasets(coco_root)
    kw = dict(batch_size=4, collate_fn=collate, num_workers=2, seed=3)
    src = DataLoader(ds, **kw)
    epoch1 = _stream(src, (1,))
    assert src.state_dict() == {"epoch": 1, "seed": 3}
    resumed = DataLoader(ds, **{**kw, "seed": 0})
    resumed.load_state_dict(src.state_dict())
    jax_resumed = JaxDataLoader(ref, **{**kw, "collate_fn": jax_collate, "seed": 0})
    jax_resumed.load_state_dict(src.state_dict())
    _assert_same(list(resumed), epoch1)
    _assert_same(list(jax_resumed), epoch1)


class _Numbers:
    """A dataset of small arrays; ``fail_at`` raises in ``__getitem__``."""

    def __init__(self, n=8, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError("corrupt sample")
        return np.full((2,), i, np.float32)


def test_loader_reraises_producer_error():
    dl = DataLoader(_Numbers(8, fail_at=3), batch_size=2, collate_fn=np.stack, shuffle=False,
                    num_workers=2)
    with pytest.raises(ValueError, match="corrupt sample"):
        list(dl)


def test_loader_early_exit_does_not_hang():
    """Leaving the loop early stops the producer parked on a full queue:
    its thread and pool end within seconds."""
    baseline = threading.active_count()
    it = iter(DataLoader(_Numbers(64), batch_size=2, collate_fn=np.stack, shuffle=False,
                         num_workers=2, prefetch=1))
    next(it)
    time.sleep(0.3)
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= baseline


# -- the device prefetch on the CPU ------------------------------------------------

class _ListLoader:
    def __init__(self, batches):
        self.batches, self.epochs = batches, []

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("buffer", [1, 2, 10])
def test_prefetcher_order_count_and_buffer(coco_root, buffer):
    """Every batch once, in order, as a ``DeviceBatch`` in the steps' layout
    (images and heatmaps NCHW, the same values); batch ``i + buffer`` is
    sent before batch ``i`` is yielded; ``set_epoch`` reaches the loader."""
    ds, _ = _datasets(coco_root, compact=True)
    batches = list(DataLoader(ds, batch_size=2, collate_fn=collate, shuffle=False))
    sent = []

    def transfer(batch):
        sent.append(len(sent))
        return host_batch_to_device(batch, torch.device("cpu"))

    loader = _ListLoader(batches)
    pf = DevicePrefetcher(loader, transfer, buffer=buffer, device="cpu")
    assert len(pf) == len(batches) == 4
    pf.set_epoch(2)
    assert loader.epochs == [2]
    it = iter(pf)
    first = next(it)
    assert len(sent) == min(buffer + 1, len(batches))
    got = [first, *it]
    assert len(got) == len(batches) and len(sent) == len(batches)
    for g, b in zip(got, batches):
        assert isinstance(g, DeviceBatch)
        assert torch.equal(g["images"], torch.from_numpy(b["images"]).permute(0, 3, 1, 2))
        assert g["images"].is_contiguous() and g["images"].dtype == torch.uint8
        for s in range(2):
            assert torch.equal(g["heatmaps"][s], torch.from_numpy(b["heatmaps"][s]).permute(0, 3, 1, 2))
            assert torch.equal(g["masks"][s], torch.from_numpy(b["masks"][s]))
        assert torch.equal(g["joints"], torch.from_numpy(b["joints"]))
    with pytest.raises(ValueError, match="buffer"):
        DevicePrefetcher(loader, transfer, buffer=0)
