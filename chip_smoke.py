"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's main path — HigherHRNet-W32 at 512x512, batch 24, bf16
forward with float32 outputs, then the associative-embedding decode at the
published eval point (det_thr 0.05, tag_thr 0.5, 30 people) — on seeded
random weights and seeded synthetic scenes. Phases, any failure exits
non-zero:

1. device: card name and power limit, TF32 switches
2. build: both CUDA kernels from ``human_pose_tpu_torch/csrc`` (parallel nvcc)
3. kernel parity at main-path shapes, CUDA kernel vs its plain version, both
   on the card
4. main path (forward + decode) and the dense-scene decode, each with the
   launch counters zeroed just before and exactly one launch per kernel
   required; output checks, card-vs-CPU decode
5. timing: forward, decode and img/s (CUDA events and host wall clock), a
   per-kernel profiler breakdown of one forward+decode with the device's
   idle share, each kernel vs its plain version and its bound

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a card the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH, SIZE, K, M = 24, 512, 17, 30
DET_THR, TAG_THR = 0.05, 0.5
N_PERSONS = 35  # > M: the person cap truncates
SEED = 0

# H100 SXM data-sheet peaks (dense): HBM bytes/s and fp32 CUDA-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

# file:line of the TPU kernel each CUDA kernel replaces, and its function
REPLACES = {
    "match_by_tag": ("human_pose_tpu/ops/pallas_match.py:461",
                     "match_by_tag_pallas_batched (_match_kernel_batched :273)"),
    "refine_argmax": ("human_pose_tpu/ops/pallas_decode.py:127",
                      "refine_argmax_batch (_refine_kernel :36)"),
}
SOURCES = {
    "match_by_tag": "human_pose_tpu_torch/csrc/match_by_tag.cu",
    "refine_argmax": "human_pose_tpu_torch/csrc/refine_argmax.cu",
}


def log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def make_scene(rng: np.random.Generator, n: int, h: int, w: int, e: int,
               n_persons: int = N_PERSONS, sigma: float = 2.0):
    """Dense multi-person heatmaps ``[n, K, h, w]`` and tag maps
    ``[n, K, e, h, w]``: low noise everywhere, one Gaussian peak per present
    joint of every person, and each person's own well-separated tag on a 5x5
    patch around its peaks (per-pixel jitter: network tags are never
    bit-identical across pixels)."""
    kpts = rng.random((n, K, h, w), dtype=np.float32) * np.float32(0.02)
    tags = rng.standard_normal((n, K, e, h, w), dtype=np.float32) * np.float32(0.05)
    r = int(3 * sigma)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    blob = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2)).astype(np.float32)
    for i in range(n):
        for p in range(n_persons):
            tag_val = (np.float32(3.0 * p - 50.0) + np.arange(e, dtype=np.float32)
                       * np.float32(7.0)).astype(np.float32)
            for k in range(K):
                if rng.random() < 0.15:
                    continue
                cx, cy = int(rng.integers(r, w - r)), int(rng.integers(r, h - r))
                amp = np.float32(0.5 + 0.5 * rng.random())
                win = kpts[i, k, cy - r:cy + r + 1, cx - r:cx + r + 1]
                np.maximum(win, blob * amp, out=win)
                patch = tag_val[:, None, None] + rng.standard_normal((e, 5, 5), dtype=np.float32) * np.float32(0.01)
                tags[i, k, :, cy - 2:cy + 3, cx - 2:cx + 3] = patch
    return kpts, tags


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, iters: int, warmup: int = 1, reps: int = 3) -> float:
    """ms of one ``fn()`` on the current stream, timed with CUDA events: the
    median over ``reps`` windows of the mean of ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def host_ms(fn, iters: int = 1) -> float:
    """Median host wall ms of ``iters`` calls of ``fn()``."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def warm_up(fn, seconds: float) -> int:
    """Call ``fn()`` (ending in a device sync) until ``seconds`` have
    passed, so clocks, the allocator and cuDNN's plans have settled before
    anything is timed. Returns the number of calls."""
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        n += 1
    return n


# device-kernel name fragment -> group, first match wins
KERNEL_GROUPS = (
    ("nchwToNhwc", "conv layout transposes"), ("nhwcToNchw", "conv layout transposes"),
    ("match_kernel", "grouping kernel"), ("refine", "refine kernel"),
    ("batch_norm", "batch norm"), ("max_pool", "NMS max-pool"),
    ("xmma", "convolutions"), ("cutlass", "convolutions"), ("conv", "convolutions"),
    ("gemm", "convolutions"), ("copy", "copies / casts"), ("add", "adds"),
    ("clamp", "ReLU"), ("upsample", "resizes"), ("sort", "sorts / top-k"),
)


def profile_breakdown(fn, top: int = 12):
    """Run ``fn`` once under ``torch.profiler`` and break its device time
    down by kernel only (operator rows would count their kernels again).
    Logs the kernels with the most device time and the time per group of
    ``KERNEL_GROUPS``; the groups sum to the device's busy time. Returns
    ``(busy_ms, {group: ms})``, or ``(None, {})`` if no device time was seen."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    per_kernel: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = per_kernel.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    if busy_ms <= 0:
        return None, {}
    for kname, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  profile kernel: {ms:9.3f} ms  x{n:<5d} {kname[:100]}")
    groups: dict[str, float] = {}
    for kname, (ms, _) in per_kernel.items():
        group = next((g for frag, g in KERNEL_GROUPS if frag in kname), "other")
        groups[group] = groups.get(group, 0.0) + ms
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    log("profile groups (sum = busy): " + ", ".join(f"{g} {ms:.3f}" for g, ms in groups.items()))
    return busy_ms, groups


def record_kernel_inputs(fn) -> dict:
    """Run ``fn`` once with the decode's two kernel entry points wrapped so
    that the positional arguments of their last call are kept: the exact
    inputs the path gives each kernel. Restores the entry points after."""
    from human_pose_tpu_torch.ops import grouping

    seen = {}
    names = {"match_by_tag": "match_by_tag_batched", "refine_argmax": "refine_argmax_batch"}
    originals = {key: getattr(grouping, attr) for key, attr in names.items()}

    def recorder(key):
        def call(*args):
            seen[key] = args
            return originals[key](*args)
        return call

    try:
        for key, attr in names.items():
            setattr(grouping, attr, recorder(key))
        fn()
    finally:
        for key, attr in names.items():
            setattr(grouping, attr, originals[key])
    return seen


def refine_inputs(rng, kpts, tags, device):
    """Refine-kernel inputs at main-path shapes from a scene: maps flattened,
    per-person mean tags near the scene's tags, mixed per-image counts."""
    import torch

    b, k, e, h, w = tags.shape
    hm = torch.from_numpy(kpts.reshape(b, k, h * w)).to(device)
    tg = torch.from_numpy(tags.reshape(b, k, e, h * w)).to(device)
    prev = (np.float32(3.0) * rng.integers(0, N_PERSONS, (b, M, 1)) - np.float32(50.0)
            + np.arange(e, dtype=np.float32) * np.float32(7.0)
            + rng.standard_normal((b, M, e), dtype=np.float32) * np.float32(0.3)).astype(np.float32)
    counts = rng.integers(0, M + 1, b).astype(np.int32)
    counts[:3] = (M, 0, 1)[: len(counts)]
    return hm, tg, torch.from_numpy(prev).to(device), torch.from_numpy(counts).to(device)


def match_inputs(kpts, tags, device):
    """Match-kernel inputs: the port's own top-k on the scene, permuted to
    the joint order (exactly what ``group_from_candidates`` feeds it)."""
    import torch

    from human_pose_tpu_torch.ops.grouping import _candidates, joints_order_for, top_k

    order = joints_order_for(K)
    t_k, c_k, s_k = top_k(torch.from_numpy(kpts).to(device), torch.from_numpy(tags).to(device), M)
    return _candidates(t_k, c_k, s_k)[:, list(order)].contiguous(), order


def refine_bound(hm, tags, prev, counts):
    """(bound_ms, bound_by) of the refine argmax for these inputs: maps read
    once, outputs written once; ~5 fp32 operations per (pixel, active
    person) for E=1, 3E+4 for E>1 (sub, square, add per dim; sqrt, round,
    sub, compare)."""
    b, k, e, hw = tags.shape
    p = prev.shape[1]
    nbytes = 4 * (hm.numel() + tags.numel() + prev.numel() + counts.numel() + b * k * p)
    active = int(counts.clamp(0, p).sum())
    ops = k * hw * active * (5 if e == 1 else 3 * e + 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def match_bound(cand, num_persons):
    """(bound_ms, bound_by) of the grouping: candidates read once, joints and
    counts written once; operations counted as the least these inputs need,
    one Hungarian relaxation pass (4 fp32 operations per column) for every
    row above det_thr. The kernel is latency-bound (a dependent chain of
    block-wide argmins), so this bound is far below any reachable time."""
    b, k, m, f = cand.shape
    nbytes = 4 * (cand.numel() + k + b * num_persons * k * f + b)
    ops = int((cand[..., 2] > DET_THR).sum()) * max(m, num_persons) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def phase_parity(dev, rng):
    """CUDA kernels vs their plain versions at main-path shapes. Returns the
    largest |kernel - plain| per kernel and the scenes it made."""
    import torch

    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    errs = {"refine_argmax": 0.0, "match_by_tag": 0.0}
    scenes = {}
    for e in (1, 2):
        log(f"scene bs{BATCH} {SIZE}^2 E={e}, {N_PERSONS} persons ...")
        kpts, tags = make_scene(rng, BATCH, SIZE, SIZE, e)
        scenes[e] = (kpts, tags)

        hm, tg, prev, counts = refine_inputs(rng, kpts, tags, dev)
        got = cuda_decode.refine_argmax_batch(hm, tg, prev, counts)
        want = cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts)
        torch.cuda.synchronize()
        mask = torch.arange(M, device=dev)[None, None, :] < counts[:, None, None].long()
        bad = int(((got != want) & mask).sum())
        errs["refine_argmax"] = max(errs["refine_argmax"],
                                    float(((got - want).abs() * mask).max()))
        log(f"refine E={e}: {int(mask.sum()) * K} (b,k,p) slots, {bad} mismatches on p < counts")
        if bad:
            raise AssertionError(f"refine kernel disagrees with plain on {bad} slots (E={e})")

        cand, order = match_inputs(kpts, tags, dev)
        j_got, c_got = cuda_match.match_by_tag_batched(cand, DET_THR, TAG_THR, order, M)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        j_want, c_want = cuda_match.match_by_tag_batched_plain(cand, DET_THR, TAG_THR, order, M)
        torch.cuda.synchronize()
        log(f"match E={e}: plain (on the card) took {time.perf_counter() - t0:.1f}s; "
            f"counts {c_got.tolist()}")
        n_valid = int((cand[..., 2] > DET_THR).sum())
        if not torch.equal(c_got, c_want):
            raise AssertionError(f"match counts differ (E={e}): {c_got.tolist()} vs {c_want.tolist()}")
        err = float((j_got - j_want).abs().max())
        errs["match_by_tag"] = max(errs["match_by_tag"], err)
        if not torch.equal(j_got, j_want):
            raise AssertionError(f"match joints differ (E={e}): max |diff| {err}")
        if int(c_got.min()) < M or n_valid < BATCH * K * M * 0.9:
            raise AssertionError(f"scene not dense enough: counts {c_got.tolist()}, {n_valid} valid rows")

    # constant-map tie case: every position ties, the first (0) must win
    hw = 64 * 64
    hm = torch.ones((2, K, hw), device=dev)
    tg = torch.zeros((2, K, 1, hw), device=dev)
    prev = torch.zeros((2, M, 1), device=dev)
    counts = torch.tensor([M, 5], dtype=torch.int32, device=dev)
    got = cuda_decode.refine_argmax_batch(hm, tg, prev, counts)
    if int(got.abs().max()) != 0:
        raise AssertionError("refine tie case: first maximum not chosen")
    log("parity: refine exact on p < counts (E=1,2, tie case); match joints/count exact (E=1,2)")
    return errs, scenes


def dense_stage_inputs(kpts, tags, dev):
    """Model-output-shaped decode inputs from a full-resolution scene: two
    heatmap stages and one tag map at 512^2, so the bilinear resizes are
    exact identities and card and CPU decode see bit-identical maps."""
    import torch

    hm = torch.from_numpy(kpts).to(dev)
    stages = [hm, hm * 0.5 + 0.01]
    return stages, [torch.from_numpy(tags[:, :, 0]).to(dev)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    import human_pose_tpu_torch
    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import _build, cuda_decode, cuda_match, decode_batch

    # the kernels must build from this checkout's sources, not an installed copy
    here = Path(__file__).resolve().parent
    if Path(human_pose_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: human_pose_tpu_torch imported from {human_pose_tpu_torch.__file__}, "
              f"not from {here}", file=sys.stderr)
        return 2

    # 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f}s wall, per kernel {secs}")
    for kname, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {kname}: {line.strip()}")

    # 3. kernel parity
    errs, scenes = phase_parity(dev, rng)

    # 4. main path
    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    model.eval()
    images = torch.from_numpy(rng.standard_normal((BATCH, 3, SIZE, SIZE), dtype=np.float32)).to(dev)
    stages_d, tags_d = dense_stage_inputs(*scenes[1], dev)

    def forward(x):
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            return model(x)

    def infer(x):
        """The main path: forward, then decode. Returns (hms, tags, decoded)."""
        hms, tags = forward(x)
        return hms, tags, decode_batch(hms, [tags], (SIZE, SIZE), max_num_people=M,
                                       det_thr=DET_THR, tag_thr=TAG_THR)

    def decode_dense():
        return decode_batch(stages_d, tags_d, (SIZE, SIZE), max_num_people=M,
                            det_thr=DET_THR, tag_thr=TAG_THR)

    def counted(fn, what):
        """Run ``fn`` with both launch counters zeroed just before; require
        exactly one launch of each kernel. Returns (fn's result, counts)."""
        cuda_match.match_by_tag_batched.launches = 0
        cuda_decode.refine_argmax_batch.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {"match_by_tag": cuda_match.match_by_tag_batched.launches,
                  "refine_argmax": cuda_decode.refine_argmax_batch.launches}
        log(f"{what} launches: {counts}")
        if any(n != 1 for n in counts.values()):
            raise AssertionError(f"{what}: each kernel must launch exactly once, got {counts}")
        return out, counts

    (hms, tags, (joints, scores, valid)), launches = counted(
        lambda: infer(images), "main path (forward + decode)")
    (dj, ds, dv), launches_dense = counted(decode_dense, "dense-scene decode")

    shapes = [tuple(h.shape) for h in hms] + [tuple(tags.shape)]
    want_shapes = [(BATCH, K, SIZE // 4, SIZE // 4), (BATCH, K, SIZE // 2, SIZE // 2),
                   (BATCH, K, SIZE // 4, SIZE // 4)]
    if shapes != want_shapes or any(h.dtype != torch.float32 for h in [*hms, tags]):
        raise AssertionError(f"forward outputs {shapes} (want {want_shapes}, float32)")
    for name_, t in (("heatmaps", torch.cat([h.flatten() for h in hms])), ("tags", tags),
                     ("joints", joints), ("scores", scores), ("dense joints", dj)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name_}")
    if tuple(joints.shape) != (BATCH, M, K, 4) or tuple(valid.shape) != (BATCH, M):
        raise AssertionError(f"decode shapes {tuple(joints.shape)} {tuple(valid.shape)}")
    log(f"forward+decode: valid persons per image {valid.sum(1).tolist()}; "
        f"dense scene: {dv.sum(1).tolist()}")

    # card fp32 forward vs the same weights on the CPU, one 64^2 image
    x_small = images[:1, :, :64, :64]
    with torch.no_grad():
        h_card, t_card = model(x_small)
        model_cpu = HigherHRNet(num_kpts=K, C=32, device="cpu").eval()
        model_cpu.load_state_dict(model.state_dict())
        h_cpu, t_cpu = model_cpu(x_small.cpu())
    for a, bb in zip([*h_card, t_card], [*h_cpu, t_cpu]):
        rel = float((a.cpu() - bb).abs().max() / bb.abs().max().clamp(min=1e-3))
        if rel > 1e-3:
            raise AssertionError(f"card fp32 forward vs CPU: max rel err {rel}")
    log("forward: card fp32 == CPU fp32 on a 64^2 image (max rel err <= 1e-3)")

    # card decode vs the port's CPU path (plain kernels) on 2 dense images
    cj, cs, cv = decode_batch([s[:2].cpu() for s in stages_d], [t[:2].cpu() for t in tags_d],
                              (SIZE, SIZE), max_num_people=M, det_thr=DET_THR, tag_thr=TAG_THR)
    for i in range(2):
        gv, hv = dv[i].cpu(), cv[i]
        if int(gv.sum()) != int(hv.sum()):
            raise AssertionError(f"image {i}: card {int(gv.sum())} persons vs CPU {int(hv.sum())}")
        err = float((dj[i].cpu()[gv][..., :3] - cj[i][hv][..., :3]).abs().max())
        if err > 1e-3:
            raise AssertionError(f"image {i}: card vs CPU decode coords/scores differ by {err}")
    log(f"decode: card == CPU path on 2 dense images ({cv.sum(1).tolist()} persons, "
        "coords within 1e-3)")

    # 5. timing
    synced_infer = lambda: (infer(images), torch.cuda.synchronize())  # noqa: E731
    log(f"warm-up: {warm_up(synced_infer, 3.0)} forward+decode calls")
    fwd_ms = cuda_ms(lambda: forward(images), iters=10, warmup=2)
    dec_ms = cuda_ms(lambda: decode_batch(hms, [tags], (SIZE, SIZE), max_num_people=M,
                                          det_thr=DET_THR, tag_thr=TAG_THR), iters=5, warmup=1)
    dense_ms = cuda_ms(decode_dense, iters=5, warmup=1)
    wall_ms = host_ms(synced_infer, iters=10)
    log(f"timing bs{BATCH}: forward {fwd_ms:.3f} ms, decode {dec_ms:.3f} ms "
        f"(dense scene {dense_ms:.3f} ms), forward+decode {wall_ms:.3f} ms host wall "
        f"-> {BATCH / wall_ms * 1e3:.2f} img/s  [{smi}]")
    busy_ms, busy_groups = profile_breakdown(lambda: infer(images))
    if busy_ms is None:
        log("profile: the profiler recorded no device time; idle share not measured")
    else:
        log(f"profile of one forward+decode: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
            f"wall (idle share {max(0.0, 1 - busy_ms / wall_ms):.3f})")

    # each kernel on the exact inputs the main path gave it
    main_in = record_kernel_inputs(lambda: infer(images))
    dense_in = record_kernel_inputs(decode_dense)
    kernels = []
    hm, tg, prev, counts = main_in["refine_argmax"]
    k_ms = cuda_ms(lambda: cuda_decode.refine_argmax_batch(hm, tg, prev, counts), iters=20)
    dense_k_ms = cuda_ms(lambda: cuda_decode.refine_argmax_batch(*dense_in["refine_argmax"]), iters=20)
    p_ms = cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts), iters=2)
    b_ms, b_by = refine_bound(hm, tg, prev, counts)
    kernels.append({"name": "refine_argmax", "route": "cuda", "source": SOURCES["refine_argmax"],
                    "replaces": REPLACES["refine_argmax"][0], "launches": launches["refine_argmax"],
                    "launches_dense_scene": launches_dense["refine_argmax"],
                    "parity": "exact idx on p < counts", "max_abs_err": errs["refine_argmax"],
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "ms_dense_scene": dense_k_ms,
                    "shape": f"B{BATCH} K{K} HW{SIZE * SIZE} E{tg.shape[2]} P{M}",
                    "active_persons": int(counts.sum())})
    cand, _, _, order, persons = main_in["match_by_tag"]
    k_ms = cuda_ms(lambda: cuda_match.match_by_tag_batched(cand, DET_THR, TAG_THR, order, persons),
                   iters=20)
    dense_k_ms = cuda_ms(lambda: cuda_match.match_by_tag_batched(*dense_in["match_by_tag"]), iters=20)
    p_ms = host_ms(lambda: (cuda_match.match_by_tag_batched_plain(cand, DET_THR, TAG_THR, order, persons),
                            torch.cuda.synchronize()))
    b_ms, b_by = match_bound(cand, persons)
    kernels.append({"name": "match_by_tag", "route": "cuda", "source": SOURCES["match_by_tag"],
                    "replaces": REPLACES["match_by_tag"][0], "launches": launches["match_by_tag"],
                    "launches_dense_scene": launches_dense["match_by_tag"],
                    "parity": "exact joints and count", "max_abs_err": errs["match_by_tag"],
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "ms_dense_scene": dense_k_ms,
                    "shape": f"B{BATCH} K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
                    "valid_rows": int((cand[..., 2] > DET_THR).sum())})
    print("kernels: " + "; ".join(
        f"{r['name']} replaces={r['replaces']} {REPLACES[r['name']][1]} launches={r['launches']} "
        f"(dense scene {r['launches_dense_scene']}) parity={r['parity']} "
        f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) plain_ms={r['plain_ms']:.2f}"
        for r in kernels), flush=True)
    print(json.dumps({"e2e": {"batch": BATCH, "size": SIZE, "forward_ms": fwd_ms,
                              "decode_ms": dec_ms, "decode_dense_ms": dense_ms,
                              "forward_decode_wall_ms": wall_ms,
                              "img_per_s": BATCH / wall_ms * 1e3, "device_busy_ms": busy_ms,
                              "device_busy_groups_ms": busy_groups, "card": smi}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
