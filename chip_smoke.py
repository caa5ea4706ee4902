"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --refine-only        # the dense refine alone, see the end
    python3 chip_smoke.py --phase-refine-only  # the phase refine alone, see the end
    python3 chip_smoke.py --aggregate-only     # the fused aggregate alone, see the end
    python3 chip_smoke.py --block-only         # the fused BasicBlock alone, see the end
    python3 chip_smoke.py --infer-only         # the inference model's phase alone, see the end
    python3 chip_smoke.py --eval-only          # the COCO evaluation phase alone, see the end
    python3 chip_smoke.py --train-only         # the training phase alone, see the end
    python3 chip_smoke.py --train-data-only    # the training input pipeline alone, see the end

Drives the port's main path — HigherHRNet-W32 at 512x512, batch 24, bf16
forward with float32 outputs, then the associative-embedding decode at the
published eval point (det_thr 0.05, tag_thr 0.5, 30 people) — and the fused
decode front end (``decode_batch_fused``) on seeded random weights and
seeded synthetic scenes. Phases, any failure exits non-zero:

1. device: card name and power limit, TF32 switches
2. build: all five CUDA libraries from ``human_pose_tpu_torch/csrc`` (one
   nvcc per source, in parallel), with ptxas registers and spills of every
   kernel, the count of HGMMA (tensor-core) instructions in each instance of
   the fused BasicBlock (TF32 operands in every float32 one) and of FRND
   (round-to-integer, conversion unit) instructions in each kernel of the
   dense and the phase refine's
3. kernel parity at main-path shapes, CUDA kernel vs its plain version, both
   on the card: the dense refine (E=1, E=2, ties within and across its row
   splits, a ragged row length with mixed counts) and the grouping; the
   fused aggregate (the stage scene; tiny, ragged and wide maps, every strip
   height of a small map, maxima across a strip and a warp boundary), the
   phase refine (E=1, E=2 on the stage scene; E=1..4, P=1..64 through the
   person chunks, ragged maps, ties within a group and across row splits,
   tags past 2**20 and distances past 2**64, planes past 200 KB, a constant
   map) and the fused BasicBlock at the four W32 branch shapes (float32,
   bfloat16)
4. main path (forward + decode) and the dense-scene decode, each with the
   launch counters zeroed just before and exactly one launch per kernel
   required; output checks, card-vs-CPU decode
5. the fused path: ``decode_batch_fused`` on the forward's outputs and on a
   dense synthetic scene at the stage resolutions, counted the same way
   (one launch each of the fused aggregate, the grouping and the phase
   refine, none of the dense refine); card == CPU, fused == dense on the
   scene, the agreement on the forward's outputs printed; the per-image
   grouping entry on the scene's candidates; the W32 model's BasicBlocks
   folded and run through the fused block in float32 and in bfloat16
6. the inference model (``InferenceKeypointsModel``) on the W32 weights for
   a 480x640 raw image: (a) one scale, (b) flip, (c) scales 0.5, 1, 2 with
   flip, (d) flip with compact uint8 inputs bucketed to multiples of 128;
   each with the counters zeroed and exactly one launch of the dense refine
   and of the grouping required, card decode == CPU decode of the card's
   own aggregated maps, (a)'s float32 forward == CPU (rel 1e-3), (d)'s pad
   region free of joints, ms an image in float32 and bfloat16, the E=2
   kernels' own times; the repaired downsampling resize card == CPU; the
   whole ``__call__`` (cv2's warp on the host) in (c) with its COCO
   detections
7. timing: forward, decode and img/s (CUDA events and host wall clock), a
   per-kernel profiler breakdown of one forward+decode with the device's
   idle share and of one fused and one dense decode alone, fused vs dense
   decode, each kernel vs its plain version, its bound and, where one
   exists, a library call
8. COCO evaluation (``eval_phase``): a synthesized val directory of 32
   seeded jpgs in COCO's four commonest raw sizes, W32 from
   ``experiments/keypoints/higher_hrnet_32.yaml`` through the port's config,
   flip on: the batched evaluator at batch 8 and 16 with the counters zeroed
   and one launch of the dense refine and of the grouping required a
   dispatched batch; one batch's decode with a valid size an image == each
   image's decode alone, bit for bit; the batch-8 float32 forward == per
   image (rel 1e-3); ``bin.eval_keypoints.main`` serial and batched writes
   its three files; img/s serial and batched in float32 and bfloat16, the
   batched path's device busy and idle share, its host syncs by line
9. training (``train_phase``): one float32 Adam step (TF32 off) of a
   reduced HigherHRNet (C=8) on the card and on the CPU from the same
   weights and batch, held within stated tolerances (losses, gradients,
   BatchNorm statistics, parameters); W32 from the keypoints yaml at its
   published point (Adam lr 1e-3, batch 36, 512x512, 30 persons, a batch
   made on the card, uint8 images) in float32 and bfloat16: ms a step, img/s,
   peak memory, device busy and idle share of one step, every loss finite;
   the accumulated step at 2 microbatches; no kernel launched
10. the training input pipeline (``train_data_phase``): a synthesized COCO
   ``train2017`` (72 images, two batches of 36) and ``val2017`` directory
   with crowd regions; the native heatmap splat (a host C++ library built
   at first use) against its plain NumPy loop; the host loader's samples a
   second at the yaml's point (batch 36, 512^2, heatmaps 128^2 and 256^2,
   sigma 2, 30 persons) with 4 and 8 workers, normal and compact, and the
   host ms a sample of each stage; W32 from the yaml through
   ``create_datamodule`` and ``create_module``, float32 and bfloat16,
   trained from loader batches through ``DevicePrefetcher`` (pinned
   staging, a side stream) across epoch boundaries beside phase 9's batch
   made on the card: ms a step, img/s, waits, peak memory, busy and idle
   share; ``validation_step`` and ``make_results`` with one launch each of
   the dense refine and the grouping; the reduced net's step on one loader
   batch card vs CPU

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a card the script exits non-zero
and prints no result.

``--refine-only`` is the short loop for work on the dense refine kernel: it
builds the refine and the grouping, runs the refine's parity cases, drives
the main path and the dense scene once to take the refine's inputs, and
times the kernel on them (and over a sweep of row splits); its last line is
one JSON object of those times with the card's name and power limit. It
prints no ``ok`` line.

``--phase-refine-only`` is the same loop for the phase refine: it builds the
phase refine, the fused aggregate and the grouping, runs the phase refine's
parity cases, takes its inputs from the fused decode of the forward's outputs
and of the stage scene, times the kernel on both and over a sweep of row
splits, times the fused and the dense decode on both inputs, reads FRND
counts from the SASS and the SM clock under load, and prints one JSON object
last (no ``ok`` line).

``--aggregate-only`` is the same loop for the fused aggregate: it builds the
decode's kernels, runs the aggregate's parity cases, takes its inputs from the
fused decode of the forward's outputs and of the stage scene, times the
kernel on both and over a sweep of strip heights, times the write floor
(``fill_`` of two tensors of the outputs' size) and the fused and the dense
decode on both inputs, reads the SM clock under load, and prints one JSON
object last (no ``ok`` line).

``--block-only`` is the same loop for the fused BasicBlock: it builds its
library, counts the HGMMA of each instance, runs the block's parity at the
four W32 branch shapes in both dtypes, and times the kernel on weights packed
once and with packing, cuDNN's conv pair (float32 also with TF32 on), the
bound and the 3xTF32 floor, with each instance's tile, grid and blocks an
SM; it prints one JSON object last (no ``ok`` line).

``--infer-only`` builds the dense refine and the grouping and runs phase 6
alone on the W32 model; it prints the phase's record as one JSON object
last (no ``ok`` line). ``--eval-only`` does the same for phase 8,
``--train-only`` for phase 9 (which builds no kernel) and
``--train-data-only`` for phase 10 (which builds the dense refine and the
grouping for its validation).
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH, SIZE, K, M = 24, 512, 17, 30
DET_THR, TAG_THR = 0.05, 0.5
N_PERSONS = 35  # > M: the person cap truncates
SEED = 0

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12
# HigherHRNet-W32's parameter count (the published model)
W32_PARAMS = 28_645_331
# HRNet-W32 branch shapes of a 512x512 input: (channels, height = width)
W32_BRANCHES = ((32, 128), (64, 64), (128, 32), (256, 16))

# file:line of the TPU kernel each CUDA kernel replaces, and its function
REPLACES = {
    "match_by_tag": ("human_pose_tpu/ops/pallas_match.py:461",
                     "match_by_tag_pallas_batched (_match_kernel_batched :273)"),
    "refine_argmax": ("human_pose_tpu/ops/pallas_decode.py:127",
                      "refine_argmax_batch (_refine_kernel :36)"),
    "match_by_tag_per_image": ("human_pose_tpu/ops/pallas_match.py:526",
                               "match_by_tag_pallas (_match_kernel :48)"),
    "fused_aggregate": ("human_pose_tpu/ops/pallas_aggregate.py:181",
                        "fused_aggregate (_aggregate_kernel :136)"),
    "refine_argmax_phase": ("human_pose_tpu/ops/pallas_aggregate.py:289",
                            "refine_argmax_phase_batch (_refine_phase_kernel :231)"),
    "fused_basic_block": ("human_pose_tpu/ops/pallas_conv.py:97", "fused_basic_block (_kernel :39)"),
}
SOURCES = {
    "match_by_tag": "human_pose_tpu_torch/csrc/match_by_tag.cu",
    "refine_argmax": "human_pose_tpu_torch/csrc/refine_argmax.cu",
    "match_by_tag_per_image": "human_pose_tpu_torch/csrc/match_by_tag.cu",
    "fused_aggregate": "human_pose_tpu_torch/csrc/fused_aggregate.cu",
    "refine_argmax_phase": "human_pose_tpu_torch/csrc/refine_argmax_phase.cu",
    "fused_basic_block": "human_pose_tpu_torch/csrc/fused_basic_block.cu",
}


# the inference model's configurations (phase 6): a 480x640 raw image at
# input size 512, W32 at the published eval point; (d) compact uint8 inputs
# bucketed to multiples of 128
INFER_RAW_HW = (480, 640)
INFER_CONFIGS = {
    "a": {"scales": (1.0,)},
    "b": {"scales": (1.0,), "use_flip": True},
    "c": {"scales": (0.5, 1.0, 2.0), "use_flip": True},
    "d": {"scales": (1.0,), "use_flip": True, "compact_inputs": True, "pad_multiple": 128},
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


def log_build(build) -> None:
    """ptxas' registers, spills, warnings and errors of each kernel built by
    this process, one line per kernel (template instances told apart)."""
    import re

    for lib, text in build.build_logs.items():
        entry = lib
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = kernel_name(m.group(1)) or lib
            elif "Performance Loss" in line:  # printed before the kernel's own lines
                named = re.search(r"function '([^']+)'", line)
                what = kernel_name(named.group(1)) if named else entry
                log(f"  {lib}/{what}: {line.strip().split(' in the function')[0][:160]}")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {lib}/{entry}: {line.strip()[:160]}")


def kernel_name(mangled: str) -> str | None:
    """``name<N>`` of a mangled ``..._kernel`` symbol: the last of the
    length-prefixed identifiers after ``_Z`` / ``_ZN`` (namespaces first),
    with its first integer template argument."""
    import re

    start = mangled.find("_Z")
    if start < 0:
        return None
    pos = start + (3 if mangled.startswith("_ZN", start) else 2)
    ident = None
    while (m := re.match(r"\d+", mangled[pos:])):
        ident = mangled[pos + m.end():pos + m.end() + int(m.group())]
        pos += m.end() + len(ident)
    if ident is None or not ident.endswith("kernel"):
        return None
    arg = re.match(r"ILi(\d+)E", mangled[pos:])
    return f"{ident}<{arg.group(1)}>" if arg else ident


def dump_sass(build, name: str) -> str | None:
    """The SASS of library ``name`` (None when the toolkit has no cuobjdump)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("cuobjdump not found: SASS not inspected")
        return None
    return subprocess.run([tool, "--dump-sass", str(build._lib_path(name))], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_by_kernel(sass: str, opcodes) -> dict:
    """``{kernel: {opcode: count, "all": instructions}}`` of a SASS dump, one
    entry per kernel function (template instances told apart)."""
    import re

    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = out.setdefault(kernel_name(m.group(1)) or m.group(1),
                                   {"all": 0, **{op: 0 for op in opcodes}})
        elif entry is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            entry["all"] += 1
            for op in opcodes:
                entry[op] += bool(re.search(rf"\b{op}\b", line))
    return out


TF32_HGMMA = r"HGMMA\.\S*TF32"  # a wgmma with TF32 operands, e.g. HGMMA.64x32x8.F32.TF32


def block_hgmma(build) -> dict | None:
    """Per instance of the fused BasicBlock's library, its HGMMA (``wgmma``)
    instructions and those with TF32 operands. Raises when an instance has
    no HGMMA, or a float32 one (``tf32_block_kernel``) none with TF32
    operands: its products would not run on the tensor cores. None when the
    toolkit has no cuobjdump."""
    sass = dump_sass(build, "fused_basic_block")
    if sass is None:
        return None
    counts = {kname: {"hgmma": c["HGMMA"], "hgmma_tf32": c[TF32_HGMMA]}
              for kname, c in sass_by_kernel(sass, ("HGMMA", TF32_HGMMA)).items()
              if kname.startswith(("bf16_block_kernel", "tf32_block_kernel"))}
    log(f"fused_basic_block SASS, HGMMA (TF32) per instance: {counts}")
    bad = [k for k, c in counts.items() if c["hgmma"] == 0 or (k.startswith("tf32") and c["hgmma_tf32"] == 0)]
    if len(counts) < 10 or bad:
        raise AssertionError(f"fused_basic_block: instances without tensor-core (TF32) products: {bad} "
                             f"of {sorted(counts)}")
    return counts


def log_refine_sass(build, lib: str = "refine_argmax") -> dict:
    """Log, per kernel of a refine library, its instructions and how many of
    them are FRND (what ``rintf`` compiles to), FADD, FMNMX, shared-memory
    loads and branches. Returns the counts."""
    sass = dump_sass(build, lib)
    if sass is None:
        return {}
    counts = sass_by_kernel(sass, ("FRND", "FADD", "FMNMX", "LDS", "BRA"))
    for kname, c in counts.items():
        log(f"  {lib}/{kname} SASS: {c['all']} instructions, FRND {c['FRND']}, "
            f"FADD {c['FADD']}, FMNMX {c['FMNMX']}, LDS {c['LDS']}, BRA {c['BRA']}")
    return counts


def hot_loop(sass: str, kernel: str, persons: int, adds_per_person: int) -> dict | None:
    """Instruction counts of a refine scan kernel's hot loop for ``persons``
    persons, from a SASS dump: the branch-free block of the fast instance
    (no FRND, ``adds_per_person * persons`` FADD within 5%) and the smallest
    loop around it (a backward branch), less the span from its first to its
    last FRND block (the rintf instance, IEEE sqrtf's fix-up blocks
    included). None when the dump does not show them."""
    import re

    insts, labels, cur = [], {}, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_name(m.group(1)) == kernel
            continue
        if not cur:
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2)))
        elif (m := re.match(r"\s*(\.L_x_\d+):", line)):
            labels[m.group(1)] = len(insts)  # index of the next instruction

    def target(text):  # index of a branch's target instruction
        m = re.search(r"BRA\s+`?\(?(\.L_x_\d+)", text)
        if m:
            return labels.get(m.group(1))
        m = re.search(r"BRA\s+(0x[0-9a-f]+)", text)
        addr = int(m.group(1), 16) if m else None
        return next((i for i, (a, _) in enumerate(insts) if a == addr), None)

    cuts = sorted({0, len(insts), *labels.values(),
                   *(i + 1 for i, (_, t) in enumerate(insts) if re.search(r"\b(BRA|EXIT)\b", t))})
    blocks = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]

    def count(a, b, op):
        return sum(bool(re.search(rf"\b{op}\b", t)) for _, t in insts[a:b])

    want = adds_per_person * persons
    fast = [(a, b) for a, b in blocks if count(a, b, "FRND") == 0 and abs(count(a, b, "FADD") - want) <= 0.05 * want]
    if not fast:
        return None
    fa, fb = fast[0]
    loops = [(t, i) for i, (_, text) in enumerate(insts) if "BRA" in text
             and (t := target(text)) is not None and t <= fa and i >= fb - 1]
    if not loops:
        return None
    la, lb = min(loops, key=lambda r: r[1] - r[0])
    frnd = [(a, b) for a, b in blocks if la <= a and b <= lb + 1 and count(a, b, "FRND") > 0]
    slow = max(b for _, b in frnd) - min(a for a, _ in frnd) if frnd else 0
    pairs = 4 * persons
    return {"fast_block": fb - fa, "fast_block_per_pair": (fb - fa) / pairs,
            "loop_without_rintf": lb + 1 - la - slow, "loop_per_pair": (lb + 1 - la - slow) / pairs,
            **{op: count(fa, fb, op) for op in ("FADD", "FMNMX", "FSETP", "FSEL", "SEL", "LDS")}}


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
    ("match_kernel", "grouping kernel"), ("aggregate_kernel", "fused aggregate kernel"),
    ("refine_phase", "phase refine kernel"), ("refine", "refine kernel"),
    ("basic_block", "fused BasicBlock kernel"),
    ("batch_norm", "batch norm"), ("max_pool", "NMS max-pool"),
    ("xmma", "convolutions"), ("cutlass", "convolutions"), ("conv", "convolutions"),
    ("wgrad", "convolutions"), ("dgrad", "convolutions"), ("fft", "convolutions"),
    ("multi_tensor_apply", "optimizer"), ("reduce_kernel", "reductions"),
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


def clocks_under_load(fn, calls: int) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, read while
    ``calls`` queued calls of ``fn`` (about a second of work) run."""
    import torch

    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def decode_times(inputs, fused, dense) -> dict:
    """Fused vs dense decode on each ``{what: args}`` of ``inputs``: ms
    between CUDA events (the host's syncs and launches included), in turns
    (fused, dense, dense, fused), and the device's busy ms and its groups
    from the profiler."""
    out = {}
    for what, a in inputs.items():
        times = {"fused": [], "dense": []}
        for name_ in ("fused", "dense", "dense", "fused"):
            fn = fused if name_ == "fused" else dense
            times[name_].append(cuda_ms(lambda: fn(*a), iters=5, reps=5))
        fused_busy, fused_groups = profile_breakdown(lambda: fused(*a))
        out[what] = {**times, "fused_busy": fused_busy, "fused_busy_groups": fused_groups,
                     "dense_busy": profile_breakdown(lambda: dense(*a))[0]}
    return out


# kernel name -> (module of the decode that calls its entry point, attribute)
ENTRY_POINTS = {
    "match_by_tag": ("grouping", "match_by_tag_batched"),
    "refine_argmax": ("grouping", "refine_argmax_batch"),
    "fused_aggregate": ("decode", "fused_aggregate"),
    "refine_argmax_phase": ("grouping", "refine_argmax_phase_batch"),
}


def record_kernel_inputs(fn) -> dict:
    """Run ``fn`` once with the decode's kernel entry points wrapped so that
    the positional arguments of their last call are kept: the exact inputs
    the path gives each kernel. Restores the entry points after."""
    from human_pose_tpu_torch.ops import decode, grouping

    modules = {"decode": decode, "grouping": grouping}
    seen = {}
    originals = {key: getattr(modules[mod], attr) for key, (mod, attr) in ENTRY_POINTS.items()}

    def recorder(key):
        def call(*args, **kwargs):
            seen[key] = args
            return originals[key](*args, **kwargs)
        return call

    try:
        for key, (mod, attr) in ENTRY_POINTS.items():
            setattr(modules[mod], attr, recorder(key))
        fn()
    finally:
        for key, (mod, attr) in ENTRY_POINTS.items():
            setattr(modules[mod], attr, originals[key])
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


def bound(nbytes: float, ops: float, peak_ops_s: float = PEAK_FP32_S):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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
    return bound(nbytes, ops)


def match_bound(cand, num_persons):
    """(bound_ms, bound_by) of the grouping: candidates read once, joints and
    counts written once; operations counted as the least these inputs need,
    one Hungarian relaxation pass (4 fp32 operations per column) for every
    row above det_thr. The kernel is latency-bound (a dependent chain of
    warp-wide argmins), so this bound is far below any reachable time."""
    b, k, m, f = cand.shape
    nbytes = 4 * (cand.numel() + k + b * num_persons * k * f + b)
    ops = int((cand[..., 2] > DET_THR).sum()) * max(m, num_persons) * 4
    return bound(nbytes, ops)


def aggregate_bound(q, h2):
    """(bound_ms, bound_by) of the fused aggregate: the two stages read once,
    two full-resolution phase maps and the row maxima written once; ~19 fp32
    operations per full-resolution pixel (two lerps of 3; the
    half-resolution lerps and average, 8 per half-resolution pixel = 2; a
    4+4 max NMS, its compare and select = 10; the row maximum 1)."""
    b, k, h4, w4 = q.shape
    full = b * k * 16 * h4 * w4
    return bound(4 * (q.numel() + h2.numel() + 2 * full + b * k * 4 * h4), 19 * full)


def refine_phase_bound(avg, tags, prev):
    """(bound_ms, bound_by) of the phase refine: maps read once, idx and val
    written once; 3E+4 fp32 operations per (pixel, person), every person
    (sub, square, add per dim; sqrt, round, sub, compare)."""
    b, k = avg.shape[:2]
    e, p = tags.shape[2], prev.shape[1]
    nbytes = 4 * (avg.numel() + tags.numel() + prev.numel() + 2 * b * k * p)
    return bound(nbytes, (avg.numel() // (b * k)) * b * k * p * (3 * e + 4))


def tf32_floor(x) -> float:
    """ms of the 3xTF32 design's products alone: three TF32 products a term
    at the tensor cores' TF32 peak (the float32 block's floor on the card)."""
    b, h, w, c = x.shape
    return 3 * 2 * 2 * 9 * c * c * h * w * b / PEAK_TF32_S * 1e3


def conv_bound(x):
    """(bound_ms, bound_by) of a BasicBlock: x read once, the output written
    once, both weight sets read once in the operands' type (bf16 for bf16
    x), the float32 biases once; 2 * 9 * C * C FLOP per pixel and conv, at
    the peak of the input's type (bf16 on tensor cores)."""
    b, h, w, c = x.shape
    nbytes = 2 * x.numel() * x.element_size() + x.element_size() * 2 * 9 * c * c + 4 * 2 * c
    peak = PEAK_FP32_S if x.dtype.itemsize == 4 else PEAK_BF16_S
    return bound(nbytes, 2 * 2 * 9 * c * c * h * w * b, peak)


def refine_scene_parity(dev, rng, kpts, tags) -> float:
    """The dense refine vs its plain version on a scene at main-path shapes
    with mixed counts, both on the card: exact on every p < counts. Returns
    the largest |kernel - plain|."""
    import torch

    from human_pose_tpu_torch.ops import cuda_decode

    e = tags.shape[2]
    hm, tg, prev, counts = refine_inputs(rng, kpts, tags, dev)
    got = cuda_decode.refine_argmax_batch(hm, tg, prev, counts)
    want = cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts)
    torch.cuda.synchronize()
    mask = torch.arange(M, device=dev)[None, None, :] < counts[:, None, None].long()
    bad = int(((got != want) & mask).sum())
    log(f"refine E={e}: {int(mask.sum()) * K} (b,k,p) slots, {bad} mismatches on p < counts")
    if bad:
        raise AssertionError(f"refine kernel disagrees with plain on {bad} slots (E={e})")
    return float(((got - want).abs() * mask).max())


def refine_edge_parity(dev) -> None:
    """The dense refine's edge cases on the card: a constant map (every
    position ties, the first must win), two equal maxima in different row
    splits (the lower index must win), and a ragged row length (no multiple
    of 4, rows off 16-byte boundaries) with counts 0..P at P = 32, the last
    equal to the plain version."""
    import torch

    from human_pose_tpu_torch.ops import cuda_decode

    rng = np.random.default_rng(SEED + 2)  # its own stream: the other phases' data stay as they were
    hw = 128 * 128
    hm = torch.ones((2, K, hw), device=dev)
    tg = torch.zeros((2, K, 1, hw), device=dev)
    prev = torch.zeros((2, M, 1), device=dev)
    counts = torch.tensor([M, 5], dtype=torch.int32, device=dev)
    if int(cuda_decode.refine_argmax_batch(hm, tg, prev, counts).abs().max()) != 0:
        raise AssertionError("refine tie case: first maximum not chosen")
    hm = torch.from_numpy(rng.random((2, K, hw), dtype=np.float32)).to(dev)
    first, second = 4095, 3 * hw // 4 + 1  # in the first and the last of 4 splits
    hm[..., first] = 2.0
    hm[..., second] = 2.0
    for splits in (None, 4, 3):
        got = cuda_decode.refine_argmax_batch(hm, tg, prev, counts, splits)
        if not (bool((got[0] == first).all()) and bool((got[1, :, :5] == first).all())):
            raise AssertionError(f"refine tie across splits ({splits}): the lower index did not win")
    b, k, hw, p = 6, 5, 96 * 160 + 3, 32
    hm = torch.from_numpy(rng.random((b, k, hw), dtype=np.float32)).to(dev)
    tg = torch.from_numpy(rng.standard_normal((b, k, 2, hw), dtype=np.float32) * 2).to(dev)
    prev = torch.from_numpy(rng.standard_normal((b, p, 2), dtype=np.float32) * 2).to(dev)
    counts = torch.tensor([0, 1, 8, 9, 30, 32], dtype=torch.int32, device=dev)
    got = cuda_decode.refine_argmax_batch(hm, tg, prev, counts)
    if not torch.equal(got, cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts)):
        raise AssertionError("refine ragged-HW, mixed-counts case differs from plain")
    log("parity: refine ties (constant map; equal maxima in two splits), ragged HW "
        f"{hw} with counts {counts.tolist()} exact")


def phase_parity(dev, rng):
    """CUDA kernels vs their plain versions at main-path shapes. Returns the
    largest |kernel - plain| per kernel and the scenes it made."""
    import torch

    from human_pose_tpu_torch.ops import cuda_match

    errs = {"refine_argmax": 0.0, "match_by_tag": 0.0}
    scenes = {}
    for e in (1, 2):
        log(f"scene bs{BATCH} {SIZE}^2 E={e}, {N_PERSONS} persons ...")
        kpts, tags = make_scene(rng, BATCH, SIZE, SIZE, e)
        scenes[e] = (kpts, tags)
        errs["refine_argmax"] = max(errs["refine_argmax"], refine_scene_parity(dev, rng, kpts, tags))

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

    refine_edge_parity(dev)
    log("parity: refine exact on p < counts (E=1,2, edge cases); match joints/count exact (E=1,2)")
    return errs, scenes


def dyadic(a: np.ndarray, bits: int) -> np.ndarray:
    """``a`` rounded to a 2**-bits grid. Each lerp of a 2x or 4x
    ``align_corners=False`` upsample adds a few bits, so on such maps every
    formulation of the resize is exact in float32 and the dense and fused
    front ends see bit-identical maps."""
    return (np.round(a * 2.0 ** bits) / 2.0 ** bits).astype(np.float32)


def make_stage_scene(rng: np.random.Generator, n: int, h4: int, w4: int,
                     n_persons: int = N_PERSONS):
    """A dense scene at the model's output resolutions: quarter ``[n, K, h4,
    w4]`` and half ``[n, K, 2h4, 2w4]`` heatmaps (low noise, one Gaussian per
    present joint, centred off the pixel grid so that the upsampled peak is
    unique) and quarter-resolution tags ``[n, K, 1, h4, w4]`` (each person's
    own tag on a 3x3 patch, jittered per pixel), on dyadic grids (heatmaps
    2**-12, tags 2**-10)."""
    q = rng.random((n, K, h4, w4), dtype=np.float32) * np.float32(0.02)
    h2 = rng.random((n, K, 2 * h4, 2 * w4), dtype=np.float32) * np.float32(0.02)
    tags = rng.standard_normal((n, K, 1, h4, w4), dtype=np.float32) * np.float32(0.05)
    r4, r2 = 3, 6  # window radii: sigma 1 at 1/4, sigma 2 at 1/2
    y4, x4 = np.mgrid[-r4:r4 + 1, -r4:r4 + 1]
    y2, x2 = np.mgrid[-r2:r2 + 1, -r2:r2 + 1]
    for i in range(n):
        for p in range(n_persons):
            for k in range(K):
                if rng.random() < 0.15:
                    continue
                cy, cx = int(rng.integers(r4, h4 - r4)), int(rng.integers(r4, w4 - r4))
                oy, ox = rng.uniform(-0.4, 0.4, 2)
                amp = 0.5 + 0.5 * rng.random()
                win = q[i, k, cy - r4:cy + r4 + 1, cx - r4:cx + r4 + 1]
                np.maximum(win, amp * np.exp(-((y4 - oy) ** 2 + (x4 - ox) ** 2) / 2), out=win)
                # the same centre in half-resolution pixels: 2c + 0.5
                win = h2[i, k, 2 * cy - r2:2 * cy + r2 + 1, 2 * cx - r2:2 * cx + r2 + 1]
                np.maximum(win, amp * np.exp(-((y2 - 2 * oy - 0.5) ** 2 + (x2 - 2 * ox - 0.5) ** 2) / 8),
                           out=win)
                tags[i, k, 0, cy - 1:cy + 2, cx - 1:cx + 2] = (
                    np.float32(3.0 * p - 50.0) + rng.standard_normal((3, 3)) * 0.01)
    return dyadic(q, 12), dyadic(h2, 12), dyadic(tags, 10)


def fused_parity(dev, rng, q, h2, tags_lo):
    """The fused aggregate and the phase refine vs their plain versions at
    main-path shapes (the stage scene), both on the card: aggregate maps
    bit-equal and cmax equal; refine idx and val exact at E=1 and E=2 and on
    a tie case. Returns the largest |kernel - plain| of each."""
    import torch

    from human_pose_tpu_torch.ops import cuda_aggregate as ca

    got, want = ca.fused_aggregate(q, h2), ca.fused_aggregate_plain(q, h2)
    torch.cuda.synchronize()
    for name, g, w in zip(("avg", "sup", "cmax"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"fused aggregate {name} differs from plain: "
                                 f"max |diff| {float((g - w).abs().max())}")
    avg = got[0]
    errs = {"fused_aggregate": 0.0, "refine_argmax_phase": 0.0}
    for e in (1, 2):
        tl = tags_lo if e == 1 else torch.cat([tags_lo, tags_lo * 0.5 + 1.0], dim=2).contiguous()
        base = np.float32(3.0) * rng.integers(0, N_PERSONS, (BATCH, M, 1)) - np.float32(50.0)
        prev = (np.concatenate([base, base * 0.5 + 1.0], axis=2)[..., :e]
                + rng.standard_normal((BATCH, M, e)) * 0.3).astype(np.float32)
        prev = torch.from_numpy(prev).to(dev)
        gi, gv = ca.refine_argmax_phase_batch(avg, tl, prev)
        wi, wv = ca.refine_argmax_phase_batch_plain(avg, tl, prev)
        torch.cuda.synchronize()
        bad = int((gi != wi).sum()) + int((gv != wv).sum())
        errs["refine_argmax_phase"] = max(errs["refine_argmax_phase"],
                                          float((gi - wi).abs().max()), float((gv - wv).abs().max()))
        log(f"phase refine E={e}: {gi.numel()} (b,k,p) slots, {bad} idx/val mismatches")
        if bad:
            raise AssertionError(f"phase refine kernel disagrees with plain on {bad} values (E={e})")
    aggregate_edge_parity(dev)
    phase_edge_parity(dev)
    log("parity: fused aggregate bit-equal (edge cases too); phase refine exact (E=1,2, edge cases)")
    return errs


# (B, K, H4, W4) of the aggregate's edge cases: tiny and ragged maps, a row
# of several warps, and one wider than a block (column tiles)
AGG_EDGE_SHAPES = ((1, 1, 1, 1), (1, 2, 1, 3), (1, 1, 5, 1), (3, 5, 13, 20), (1, 2, 37, 9),
                   (2, 3, 16, 128), (1, 1, 8, 1024))


def aggregate_inputs(rng, b, k, h4, w4, dev):
    """Signed random stages with a 5.0 plateau in the first map, above every
    other value (the NMS keeps every equal maximum)."""
    import torch

    q = rng.standard_normal((b, k, h4, w4), dtype=np.float32)
    h2 = rng.standard_normal((b, k, 2 * h4, 2 * w4), dtype=np.float32)
    q[0, 0, :max(1, h4 // 2), :max(1, w4 // 2)] = 5.0
    h2[0, 0, :h4, :w4] = 5.0
    return torch.from_numpy(q).to(dev), torch.from_numpy(h2).to(dev)


def boundary_maps(rng, dev):
    """Three 16x64 maps (64 quarter columns: two warps) whose maxima sit on
    full-resolution row 16 (a strip boundary at rows = 1, 2, 4) and column
    128 (the first column of the second warp): a 5.0 plateau on rows 15-16,
    columns 127-128; two equal peaks diagonal across that corner; one peak
    exactly at (16, 128)."""
    import torch

    q = rng.random((1, 3, 16, 64), dtype=np.float32) * np.float32(0.5)
    h2 = rng.random((1, 3, 32, 128), dtype=np.float32) * np.float32(0.5)
    q[0, 0, 3:5, 31:33] = 5.0
    h2[0, 0, 6:10, 62:66] = 5.0
    q[0, 1:] = 0.0
    h2[0, 1:] = 0.0
    h2[0, 1, 7, 63] = h2[0, 1, 8, 64] = 8.0
    h2[0, 2, 7, 63] = h2[0, 2, 7, 64] = h2[0, 2, 8, 63] = 4.0
    h2[0, 2, 8, 64] = 8.0
    return torch.from_numpy(q).to(dev), torch.from_numpy(h2).to(dev)


def aggregate_edge_parity(dev) -> None:
    """The fused aggregate's edge cases on the card, avg, sup and cmax each
    equal (``torch.equal``) to the plain version, one launch a call: the
    shapes of ``AGG_EDGE_SHAPES``; every strip height of an 11x45 map; maxima
    across a strip and a warp boundary (``boundary_maps``)."""
    import torch

    from human_pose_tpu_torch.ops import cuda_aggregate as ca
    from human_pose_tpu_torch.ops.phase import phase_to_dense

    rng = np.random.default_rng(SEED + 4)  # its own stream: the other phases' data stay as they were

    def check(what, q, h2, rows=None):
        before = ca.fused_aggregate.launches
        got = ca.fused_aggregate(q, h2, rows)
        want = ca.fused_aggregate_plain(q, h2)
        torch.cuda.synchronize()
        if ca.fused_aggregate.launches != before + 1:
            raise AssertionError(f"fused aggregate {what}: {ca.fused_aggregate.launches - before} launches")
        for name_, g, w in zip(("avg", "sup", "cmax"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"fused aggregate {what} (rows {rows}): {name_} differs from plain, "
                                     f"max |diff| {float((g - w).abs().max())}")
        return got

    for shape in AGG_EDGE_SHAPES:
        check(f"{shape}", *aggregate_inputs(rng, *shape, dev))
    q, h2 = aggregate_inputs(rng, 1, 2, 11, 45, dev)
    for rows in range(1, 12):
        check("11x45", q, h2, rows)
    q, h2 = boundary_maps(rng, dev)
    for rows in (None, 1, 2, 4):
        sup = phase_to_dense(check("boundary maxima", q, h2, rows)[1])[0]
        tops = [sorted({(int(y), int(x)) for y, x in (m == m.max()).nonzero().tolist()}) for m in sup]
        if tops != [[(15, 127), (15, 128), (16, 127), (16, 128)], [(15, 127), (16, 128)], [(16, 128)]]:
            raise AssertionError(f"fused aggregate boundary maxima (rows {rows}): kept {tops}")
    log(f"parity: fused aggregate edge cases equal to plain ({len(AGG_EDGE_SHAPES)} shapes, "
        "rows 1..11 of an 11x45 map, maxima across a strip and a warp boundary)")


def phase_edge_parity(dev) -> None:
    """The phase refine's edge cases on the card, each idx and val equal to
    the plain version: E=1..4; P=1..32 and 40, 64 through the person chunks;
    ragged maps and row splits; equal maxima within one 4-pixel group and in
    two row splits (the lower index must win); tags past 2**20 (the rintf
    instance) and, at E=1, distances past 2**64 (infinite in the sqrt(d*d)
    form); E*H4*W4*4 past 200 KB; a constant map (every position ties)."""
    import torch

    from human_pose_tpu_torch.ops import cuda_aggregate as ca

    rng = np.random.default_rng(SEED + 3)  # its own stream: the other phases' data stay as they were

    def check(what, avg, tl, prev, splits=None):
        gi, gv = ca.refine_argmax_phase_batch(avg, tl, prev, splits)
        wi, wv = ca.refine_argmax_phase_batch_plain(avg, tl, prev)
        torch.cuda.synchronize()
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            raise AssertionError(f"phase refine differs from plain: {what} (splits {splits})")
        return gi

    def inputs(b, h4, w4, e, p, scale=2.0):
        return (torch.from_numpy(rng.random((b, 3, 4, 4, h4, w4), dtype=np.float32)).to(dev),
                torch.from_numpy(rng.standard_normal((b, 3, e, h4, w4), dtype=np.float32) * scale).to(dev),
                torch.from_numpy(rng.standard_normal((b, p, e), dtype=np.float32) * scale).to(dev))

    for e in (1, 2, 3, 4):
        for splits in (None, 1, 5):
            check(f"E={e} 24x40 P=30", *inputs(2, 24, 40, e, 30), splits)
    for p in (1, 2, 29, 31, 32, 40, 64):
        check(f"P={p}", *inputs(2, 16, 24, 1, p))
    for h4, w4 in ((13, 37), (5, 1), (9, 300)):
        for splits in (None, 1, 7):
            check(f"ragged {h4}x{w4}", *inputs(2, h4, w4, 1, 7), splits)
    avg, tl, prev = inputs(1, 16, 16, 1, 3)
    tl.zero_(), prev.zero_()  # the difference is the heatmap itself
    for (y0, x0), (y1, x1) in (((5, 1), (5, 2)), ((15, 40), (16, 3)), ((2, 6), (63, 63))):
        a = avg.clone()
        a[:, :, y0 % 4, x0 % 4, y0 // 4, x0 // 4] = 2.0
        a[:, :, y1 % 4, x1 % 4, y1 // 4, x1 // 4] = 2.0
        for splits in (1, 4):
            if not bool((check(f"tie {(y0, x0)} {(y1, x1)}", a, tl, prev, splits) == y0 * 64 + x0).all()):
                raise AssertionError(f"phase refine tie {(y0, x0)} vs {(y1, x1)}: the lower index did not win")
    avg, tl, prev = inputs(2, 16, 24, 1, 30)
    tl[0, 0, 0, 3:6, 4:9] = 3e6  # groups past 2**20
    tl[0, 1, 0] = 2e19  # every |d| >= 2**64: all differences -inf, the first pixel wins
    if int(check("tags past 2**20 and 2**64", avg, tl, prev)[0, 1].max()) != 0:
        raise AssertionError("phase refine: infinite distances did not give the first pixel")
    check("person tags past 2**20", avg, tl, prev * 1e6, 3)
    check("E=4 128x128 (past 200 KB a plane set)", *inputs(1, 128, 128, 4, 30))
    idx, val = ca.refine_argmax_phase_batch(torch.ones((2, K, 4, 4, 32, 32), device=dev),
                                            torch.zeros((2, K, 1, 32, 32), device=dev),
                                            torch.zeros((2, M, 1), device=dev))
    if int(idx.abs().max()) != 0 or not bool((val == 1).all()):
        raise AssertionError("phase refine tie case: first maximum not chosen")
    log("parity: phase refine edge cases exact")


def block_weights(gen, c: int, dev):
    """Seeded HWIO weights scaled 1/sqrt(9C) and small biases."""
    import torch

    w = [torch.randn((3, 3, c, c), generator=gen) / (9 * c) ** 0.5, torch.randn((c,), generator=gen) * 0.1,
         torch.randn((3, 3, c, c), generator=gen) / (9 * c) ** 0.5, torch.randn((c,), generator=gen) * 0.1]
    return [t.to(dev) for t in w]


def basic_block_parity(dev, gen):
    """The fused BasicBlock vs its plain version at the four W32 branch
    shapes, batch 24, both on the card: float32 within 1e-4 (TF32 off);
    bfloat16 (bf16 weights, both versions) within 2**-6 of the output's
    largest magnitude (4 bf16 ulps: the kernel and cuDNN sum in different
    orders, so an intermediate value at a bf16 rounding boundary can round
    either way, and the output is rounded again). Returns one record per
    (shape, dtype) with its inputs."""
    import torch

    from human_pose_tpu_torch.ops import cuda_conv

    rows = []
    for c, hw in W32_BRANCHES:
        x = torch.rand((BATCH, hw, hw, c), generator=gen).to(dev)  # post-ReLU activations
        weights = block_weights(gen, c, dev)
        for dtype in (torch.float32, torch.bfloat16):
            xi = x.to(dtype)
            got = cuda_conv.fused_basic_block(xi, *weights).float()
            want = cuda_conv.fused_basic_block_plain(xi, *weights).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * float(want.abs().max())
            log(f"fused block C={c} {hw}^2 {str(dtype)[6:]}: max |kernel - plain| {err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                raise AssertionError(f"fused block C={c} {hw}^2 {dtype}: {err} > {tol}")
            rows.append({"c": c, "hw": hw, "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol,
                         "inputs": (xi, *weights)})
    return rows


def cudnn_pair(x, w1, b1, w2, b2):
    """One call of cuDNN computing the block on these inputs: two conv calls
    with bias (channels_last, x's type), the add and the ReLU."""
    import torch
    import torch.nn.functional as F

    lib_w = [t.to(x.dtype) for t in (w1.permute(3, 2, 0, 1), b1, w2.permute(3, 2, 0, 1), b2)]
    lib_w[0] = lib_w[0].contiguous(memory_format=torch.channels_last)
    lib_w[2] = lib_w[2].contiguous(memory_format=torch.channels_last)
    x_cl = x.permute(0, 3, 1, 2)  # the NHWC tensor as a channels_last NCHW view

    def library():
        y = torch.relu(F.conv2d(x_cl, lib_w[0], lib_w[1], padding=1))
        return torch.relu(F.conv2d(y, lib_w[2], lib_w[3], padding=1) + x_cl)
    return library


def block_times(rows, smi: str) -> list:
    """Each record of ``basic_block_parity`` timed (CUDA events, median of
    three windows): the kernel on weights packed once (``ms``) and with
    packing (the ``fused_basic_block`` call), the plain version, cuDNN's
    pair, the bound and, for float32, the 3xTF32 floor; with the instance's
    tile, grid and waves over the card's SMs."""
    import torch

    from human_pose_tpu_torch.ops import cuda_conv

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for r in rows:
        x, w1, b1, w2, b2 = r["inputs"]
        packed = cuda_conv.pack_block_weights(w1, b1, w2, b2, dtype=x.dtype)
        b, h, w, c = x.shape
        tile = cuda_conv.kernel_tile(c, x.dtype)
        grid = [-(-w // tile["tw"]), -(-h // tile["th"]), b]
        b_ms, b_by = conv_bound(x)
        rec = {key: r[key] for key in ("c", "hw", "dtype", "max_abs_err", "tol")}
        rec.update({
            "ms": cuda_ms(lambda: cuda_conv.fused_basic_block_packed(x, *packed), iters=10),
            "ms_with_packing": cuda_ms(lambda: cuda_conv.fused_basic_block(*r["inputs"]), iters=10),
            "plain_ms": cuda_ms(lambda: cuda_conv.fused_basic_block_plain(*r["inputs"]), iters=5),
            "library_ms": cuda_ms(cudnn_pair(*r["inputs"]), iters=10), "bound_ms": b_ms, "bound_by": b_by,
            "tile": tile, "grid": grid,
            "waves": grid[0] * grid[1] * grid[2] / (sm_count * max(tile["blocks_per_sm"], 1))})
        if x.dtype == torch.float32:
            rec["floor_ms"] = tf32_floor(x)
        out.append(rec)
        log(f"fused block C={c} {r['hw']}^2 {r['dtype']}: {rec['ms']:.4f} ms (with weight packing "
            f"{rec['ms_with_packing']:.4f}), plain {rec['plain_ms']:.3f}, cuDNN pair {rec['library_ms']:.4f}, "
            f"bound {b_ms:.4f} ({b_by}), 3xTF32 floor {rec.get('floor_ms', float('nan')):.4f}; tile "
            f"{tile['th']}x{tile['tw']} KCH {tile['kch']} stages {tile['stages']}, "
            f"{tile['blocks_per_sm']} blocks/SM, grid {grid}  [{smi}]")
    return out


def w32_blocks(model, gen):
    """``(block, input size)`` for copies of the first BasicBlock of every
    branch of the first HR block of stages 2-4 of ``model`` (9 blocks,
    C=32..256), with seeded BN statistics so the fold is not near the
    identity."""
    import copy

    import torch

    blocks = []
    for stage in model.backbone.stages[1:]:
        for branch, units in enumerate(stage.blocks[0].scales_blocks):
            blk = copy.deepcopy(units[0]).eval()
            with torch.no_grad():
                for bn in (blk.bn1, blk.bn2):
                    c = bn.num_features
                    bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
                    bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
                    bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                    bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
            blocks.append((blk, (SIZE // 4) >> branch))
    return blocks


def dense_stage_inputs(kpts, tags, dev):
    """Model-output-shaped decode inputs from a full-resolution scene: two
    heatmap stages and one tag map at 512^2, so the bilinear resizes are
    exact identities and card and CPU decode see bit-identical maps."""
    import torch

    hm = torch.from_numpy(kpts).to(dev)
    stages = [hm, hm * 0.5 + 0.01]
    return stages, [torch.from_numpy(tags[:, :, 0]).to(dev)]


def make_counted(counters: dict):
    """``counted(fn, what, want)``: run ``fn`` with every launch counter of
    ``counters`` zeroed just before; require exactly the launches of
    ``want`` (and none of any other kernel); ``want`` may be a function of
    fn's result. Returns (fn's result, counts)."""
    import torch

    def counted(fn, what, want):
        for wrapper in counters.values():
            wrapper.launches = 0
        out = fn()
        torch.cuda.synchronize()
        want = want(out) if callable(want) else want
        counts = {key: wrapper.launches for key, wrapper in counters.items()}
        log(f"{what} launches: {counts}")
        if counts != {key: want.get(key, 0) for key in counters}:
            raise AssertionError(f"{what}: launches {counts}, want {want} and no others")
        return out, counts
    return counted


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name; each counts its
    launches in ``.launches``."""
    from human_pose_tpu_torch.ops import cuda_aggregate, cuda_conv, cuda_decode, cuda_match

    return {
        "match_by_tag": cuda_match.match_by_tag_batched,
        "refine_argmax": cuda_decode.refine_argmax_batch,
        "match_by_tag_per_image": cuda_match.match_by_tag_per_image,
        "fused_aggregate": cuda_aggregate.fused_aggregate,
        "refine_argmax_phase": cuda_aggregate.refine_argmax_phase_batch,
        "fused_basic_block": cuda_conv.fused_basic_block,
    }


def infer_inputs(rng, cfg: dict, dev):
    """Seeded uint8 device inputs ``{scale: [1, 3, h, w]}`` at the sizes
    ``prepare_input`` gives a 480x640 raw image (``get_multi_scale_size``;
    the pixels random, not cv2's warp), padded with ``PAD_PIXEL_U8`` to
    ``pad_multiple``; the decode size and the valid size."""
    import torch

    from human_pose_tpu_torch.constants import PAD_PIXEL_U8
    from human_pose_tpu_torch.data import get_multi_scale_size

    raw = np.zeros((*INFER_RAW_HW, 3), np.uint8)
    scales, m = cfg["scales"], cfg.get("pad_multiple", 64)
    xs, valid_hw = {}, None
    for s in scales:
        (w, h), _, _ = get_multi_scale_size(raw, SIZE, s, min(scales))
        x = np.empty((1, -(-h // m) * m, -(-w // m) * m, 3), np.uint8)
        x[:] = np.asarray(PAD_PIXEL_U8, np.uint8)
        x[:, :h, :w] = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        xs[s] = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev)
        if s == 1.0:
            valid_hw = (h, w)
    return xs, tuple(xs[1.0].shape[2:]), valid_hw


def infer_device_part(im, xs: dict, hw, valid_hw):
    """The device part of ``InferenceKeypointsModel.__call__``:
    ``forward_scale`` per scale, largest first, summed, tags from scale 1,
    then ``_decode_aggregated``. Returns (avg_sum, tags_list, decoded)."""
    avg_sum = tags_list = None
    for s in sorted(xs, reverse=True):
        avg, tags_s = im.forward_scale(xs[s], hw)
        avg_sum = avg if avg_sum is None else avg_sum + avg
        if s == 1.0:
            tags_list = tags_s
    return avg_sum, tags_list, im._decode_aggregated(avg_sum, tags_list, hw, float(len(xs)), valid_hw)


def inference_phase(dev, model, rng, counted, smi: str) -> dict:
    """Phase 6: the port's ``InferenceKeypointsModel`` on the W32 ``model``
    in configurations (a)-(d), each with exactly one launch of the dense
    refine and of the grouping, its card decode == the CPU decode of the
    card's own aggregated maps, (a)'s float32 forward == the CPU's (rel
    1e-3), (d)'s pad region free of joints, and ms an image in float32 and
    bfloat16; the E=2 kernels' own times; the repaired resize on the card ==
    the CPU; ``__call__`` on a seeded raw image in (c) with its COCO
    detections. Returns the phase's record."""
    import torch

    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match, resize_bilinear

    model_cpu = copy.deepcopy(model).cpu()
    want = {"match_by_tag": 1, "refine_argmax": 1}
    out = {"card": smi, "raw_hw": INFER_RAW_HW, "configs": {}}
    e2_inputs = {}
    for key, cfg in INFER_CONFIGS.items():
        xs, hw, valid_hw = infer_inputs(rng, cfg, dev)
        kw = dict(det_thr=DET_THR, tag_thr=TAG_THR, max_num_people=M, input_size=SIZE, **cfg)
        im = InferenceKeypointsModel(model, device=dev, **kw)
        im_cpu = InferenceKeypointsModel(model_cpu, device="cpu", **kw)
        e = 2 if cfg.get("use_flip") else 1
        what = f"inference ({key}) scales {cfg['scales']} E={e} decode {hw} valid {valid_hw}"
        (avg_sum, tags_list, (joints, scores, valid, avg, tags)), launches = counted(
            lambda: infer_device_part(im, xs, hw, valid_hw), what, want)
        if tuple(joints.shape) != (1, M, K, 3 + e) or tuple(tags.shape) != (1, K, *hw, e):
            raise AssertionError(f"{what}: joints {tuple(joints.shape)}, tags {tuple(tags.shape)}")
        if not all(bool(torch.isfinite(t).all()) for t in (joints, scores, avg_sum, *tags_list)):
            raise AssertionError(f"{what}: non-finite outputs")
        # card decode vs the CPU path (plain kernels) on the card's own maps
        cj, cs, cv, _, _ = im_cpu._decode_aggregated(
            avg_sum.cpu(), [t.cpu() for t in tags_list], hw, float(len(xs)), valid_hw)
        diff = (joints[0].cpu()[cv[0]][..., :3] - cj[0][cv[0]][..., :3]).abs()  # [persons, K, 3]
        field_err = [float(diff[..., f].max()) if diff.numel() else 0.0 for f in range(3)]
        err = max(field_err)
        if not torch.equal(valid.cpu(), cv) or err > 1e-3:
            raise AssertionError(f"{what}: card vs CPU decode: persons {int(valid.sum())} vs "
                                 f"{int(cv.sum())}, joints differ by {err}")
        rec = {"scales": cfg["scales"], "e": e, "decode_hw": hw, "valid_hw": valid_hw,
               "input_hw": {str(s): tuple(x.shape[2:]) for s, x in xs.items()},
               "launches": launches, "persons": int(valid.sum()), "card_vs_cpu_decode_err": err,
               "card_vs_cpu_decode_err_xys": field_err,
               "joints_differing": int((diff > 0).any(-1).sum()),
               "largest_score": float(cj[0][cv[0]][..., 2].abs().max()) if bool(cv.any()) else 0.0}
        log(f"{what}: {rec['persons']} persons; card == CPU decode (joints within {err:.3g}; "
            f"x, y, score {field_err}; {rec['joints_differing']} joints differ; largest score "
            f"{rec['largest_score']:.6g})")
        if key == "a":
            # the float32 forward (aggregated, resized) on the card vs the CPU
            with torch.no_grad():
                a_cpu, t_cpu = im_cpu.forward_scale(xs[1.0].cpu(), hw)
            rel = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-3))
                      for a, b in ((avg_sum, a_cpu), (tags_list[0], t_cpu[0])))
            if rel > 1e-3:
                raise AssertionError(f"{what}: card fp32 forward vs CPU: max rel err {rel}")
            rec["forward_rel_err"] = rel
            log(f"{what}: card fp32 forward == CPU (max rel err {rel:.3g} <= 1e-3)")
        if key == "d":
            vh, vw = valid_hw
            jv = joints[0][valid[0]]
            outside = int(((jv[..., 0] >= vw) | (jv[..., 1] >= vh)).sum())
            if outside or not bool((avg[..., vh:, :] == -1e4).all() and (avg[..., vw:] == -1e4).all()):
                raise AssertionError(f"{what}: {outside} joints of valid persons in the pad region")
            rec["joints_in_pad_region"] = outside
            log(f"{what}: no joint of a valid person in the pad region (x >= {vw} or y >= {vh})")
        if e == 2:
            e2_inputs[key] = record_kernel_inputs(lambda: infer_device_part(im, xs, hw, valid_hw))
        for dtype in (torch.float32, torch.bfloat16):
            im_t = im if dtype == torch.float32 else InferenceKeypointsModel(
                model, device=dev, dtype=dtype, **kw)
            fn = lambda: infer_device_part(im_t, xs, hw, valid_hw)  # noqa: E731
            warm_up(lambda: (fn(), torch.cuda.synchronize()), 3.0)
            name_ = str(dtype).split(".")[-1]
            rec[f"ms_{name_}"] = cuda_ms(fn, iters=3, warmup=0, reps=3)
            if key in ("b", "c"):
                busy, groups = profile_breakdown(fn)
                rec[f"busy_ms_{name_}"], rec[f"busy_groups_ms_{name_}"] = busy, groups
        log(f"{what}: {rec['ms_float32']:.3f} ms an image float32, {rec['ms_bfloat16']:.3f} "
            f"bfloat16 (CUDA events, median of 3 windows)  [{smi}]")
        if key in ("b", "c"):
            log(f"{what}: device busy {rec['busy_ms_float32']} ms float32, "
                f"{rec['busy_ms_bfloat16']} ms bfloat16 (profiler, one call)")
        out["configs"][key] = rec

    # the E=2 kernels on the flip path's inputs
    kernels = {}
    for key, seen in e2_inputs.items():
        hm, tg, prev, counts = seen["refine_argmax"]
        cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
        if not torch.equal(cuda_decode.refine_argmax_batch(hm, tg, prev, counts),
                           cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts)):
            raise AssertionError(f"inference ({key}): refine differs from plain at E=2")
        kernels[key] = {
            "refine_shape": f"B1 K{K} HW{hm.shape[2]} E{tg.shape[2]} P{prev.shape[1]}",
            "refine_active_persons": int(counts.sum()),
            "refine_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch(hm, tg, prev, counts), iters=20),
            "refine_plain_ms": cuda_ms(
                lambda: cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts), iters=2),
            "refine_bound_ms": refine_bound(hm, tg, prev, counts)[0],
            "match_shape": f"B1 K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
            "match_valid_rows": int((cand[..., 2] > DET_THR).sum()),
            "match_ms": cuda_ms(lambda: cuda_match.match_by_tag_batched(
                cand, det_thr, tag_thr, order, persons), iters=20),
            "match_bound_ms": match_bound(cand, persons)[0]}
        log(f"inference ({key}) E=2 kernels: " + ", ".join(f"{k_} {v}" for k_, v in kernels[key].items()))
    out["e2_kernels"] = kernels

    # the repaired resize: a downsample (what a scale-4 pass would give) on
    # the card vs the CPU
    x = torch.from_numpy(rng.standard_normal((1, K, 1024, 1536), dtype=np.float32))
    err = float((resize_bilinear(x.to(dev), 512, 768).cpu() - resize_bilinear(x, 512, 768)).abs().max())
    if err > 1e-6:
        raise AssertionError(f"resize 1024x1536 -> 512x768: card vs CPU {err}")
    out["resize_down_card_vs_cpu"] = err
    log(f"resize_bilinear 1024x1536 -> 512x768 (antialiased): card == CPU within {err:.3g}")

    # the whole __call__ (cv2's warp on the host) in (c), and its detections
    im = InferenceKeypointsModel(model, device=dev, det_thr=DET_THR, tag_thr=TAG_THR,
                                 max_num_people=M, input_size=SIZE, **INFER_CONFIGS["c"])
    raw = rng.integers(0, 256, (*INFER_RAW_HW, 3), dtype=np.uint8)
    result, _ = counted(lambda: im(raw), "inference (c) __call__ on a 480x640 raw image", want)
    dets = result.to_coco_detections(image_id=0)
    vh, vw = result.model_input_image.shape[:2]
    if not (len(dets) == len(result.kpts_coords) and all(len(d["keypoints"]) == 3 * K for d in dets)
            and np.isfinite(result.kpts_coords).all() and result.kpts_tags.shape[-1] == 2
            and result.kpts_heatmaps.shape == (vh, vw, K)
            and result.tags_heatmaps.shape == (vh, vw, K)):
        raise AssertionError("inference (c) __call__: result or detections malformed")
    warm_up(lambda: im(raw), 3.0)
    out["call_c"] = {"persons": len(dets), "model_input_hw": im.model_input_shape,
                     "host_wall_ms": host_ms(lambda: im(raw), iters=5)}
    log(f"inference (c) __call__: {len(dets)} COCO detections, model input {im.model_input_shape}, "
        f"{out['call_c']['host_wall_ms']:.3f} ms host wall an image (cv2 warp, copies, sync)  [{smi}]")
    return out


# phase 8, COCO evaluation: a synthesized val directory in COCO's commonest
# raw sizes (h, w), 2-5 persons an image, W32 from the repo's yaml
EVAL_YAML = "experiments/keypoints/higher_hrnet_32.yaml"
EVAL_N_IMAGES = 32
EVAL_RAW_HW = ((480, 640), (640, 480), (427, 640), (640, 427))
EVAL_BATCH_SIZES = (8, 16)
EVAL_OUT_FILES = ["coco_output.txt", "config.yaml", "val2017_results.json"]


def make_eval_corpus(root: Path, rng, split: str = "val2017", n_images: int = EVAL_N_IMAGES,
                     persons: tuple = (2, 6), crowd_every: int = 0) -> dict:
    """A COCO ``split`` directory under ``root``: ``n_images`` seeded jpgs
    of the sizes ``EVAL_RAW_HW`` (a smooth random background, ``persons``
    [low, high) persons of 17 keypoints drawn as discs, about one keypoint
    in eight not visible), ``person_keypoints_<split>.json``, pre-baked
    with the port's ``prebake_annotations``. With ``crowd_every`` every
    such image also gets a crowd region (``iscrowd`` 1, a rectangle over
    its middle), so the training masks are not all ones. Returns the counts
    of images, of persons, of crowd regions and of images of each raw
    size."""
    import cv2

    from human_pose_tpu_torch.data import prebake_annotations

    (root / "images" / split).mkdir(parents=True)
    (root / "annotations").mkdir(exist_ok=True)
    images, annotations, sizes, crowds = [], [], {}, 0
    for i in range(n_images):
        h, w = EVAL_RAW_HW[int(rng.integers(len(EVAL_RAW_HW)))]
        sizes[f"{h}x{w}"] = sizes.get(f"{h}x{w}", 0) + 1
        small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
        image_id = i + 1
        if crowd_every and i % crowd_every == 0:
            x0, y0, x1, y1 = w // 4, h // 3, 3 * w // 4, 2 * h // 3
            crowds += 1
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id, "category_id": 1,
                "keypoints": [0] * (3 * K), "num_keypoints": 0, "iscrowd": 1,
                "area": float((x1 - x0) * (y1 - y0)), "bbox": [x0, y0, x1 - x0, y1 - y0],
                "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]]})
        for _ in range(int(rng.integers(*persons))):
            s = int(rng.integers(min(h, w) // 10, min(h, w) // 4))
            cx, cy = int(rng.integers(s, w - s)), int(rng.integers(s, h - s))
            xy = np.stack([cx + rng.integers(-s, s + 1, K), cy + rng.integers(-s, s + 1, K)], 1)
            vis = rng.random(K) > 0.125
            kpts = np.zeros((K, 3), np.int64)
            kpts[vis, :2], kpts[vis, 2] = xy[vis], 2
            for x, y in xy[vis]:
                cv2.circle(img, (int(x), int(y)), 5, tuple(int(c) for c in rng.integers(0, 256, 3)), -1)
            x0, y0 = xy[vis].min(0)
            x1, y1 = xy[vis].max(0)
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id, "category_id": 1,
                "keypoints": kpts.ravel().tolist(), "num_keypoints": int(vis.sum()), "iscrowd": 0,
                "area": float((x1 - x0 + 1) * (y1 - y0 + 1)),
                "bbox": [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)],
                "segmentation": [[int(x0), int(y0), int(x1), int(y0), int(x1), int(y1), int(x0), int(y1)]]})
        name = f"{image_id:012d}.jpg"
        cv2.imwrite(str(root / "images" / split / name), img)
        images.append({"id": image_id, "file_name": name, "height": h, "width": w})
    (root / "annotations" / f"person_keypoints_{split}.json").write_text(
        json.dumps({"images": images, "annotations": annotations}))
    prebake_annotations(str(root), split)
    out = {"images": n_images, "persons": len(annotations) - crowds, "raw_hw": sizes}
    return {**out, "crowd_regions": crowds} if crowd_every else out


def eval_phase(dev, counted, smi: str) -> dict:
    """Phase 8: COCO evaluation through the port's entry points on a
    synthesized val directory (``make_eval_corpus``), HigherHRNet-W32 at its
    full width from ``EVAL_YAML`` (seeded random weights: ``ckpt_path``
    null), flip on, input 512. Checks, any failure raises: (1) the batched
    evaluator at batch 8 and 16 launches the dense refine and the grouping
    once a dispatched batch; (2) the batched decode of one batch's maps with
    a different valid size an image equals each image's decode alone, bit
    for bit; (3) the batch-N float32 forward equals the per-image forward
    within rel 1e-3; (4) ``bin.eval_keypoints.main``, serial and with
    ``--batch_size=8``, writes its three files with the AP table. Measures
    img/s of the serial and the batched evaluator (batch 8, 16; float32,
    bfloat16), the batched path's device busy and idle share (profiler),
    the host syncs inside it (``torch.cuda.set_sync_debug_mode``), the
    host's jpeg read and ``prepare_input`` an image, and the two kernels'
    times on its inputs. Returns the phase's record."""
    import collections
    import contextlib
    import tempfile
    import warnings

    import torch

    from human_pose_tpu_torch.bin import eval_keypoints
    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.data import CocoKeypointsDataset
    from human_pose_tpu_torch.inference import (
        BatchedKeypointsEvaluator, evaluate_dataset_batched, image_id_from_path,
    )
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match
    from human_pose_tpu_torch.utils import load_yaml, save_yaml

    rng = np.random.default_rng(SEED + 8)
    out = {"card": smi, "batch_sizes": EVAL_BATCH_SIZES}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out["corpus"] = make_eval_corpus(tmp / "coco", rng)
        cfg_dict = load_yaml(Path(__file__).resolve().parent / EVAL_YAML)
        cfg_dict["dataloader"]["val_ds"]["root"] = str(tmp / "coco")
        cfg_dict["inference"].update(ckpt_path=None, use_flip=True, input_size=SIZE)
        yaml_path = tmp / "eval.yaml"
        save_yaml(cfg_dict, yaml_path)
        # the yaml's accelerator "tpu" means a bfloat16 forward (the JAX rule);
        # any other accelerator but "cpu" is float32 on the card
        models = {}
        for dtype, argv in (("float32", ["--trainer.accelerator=gpu"]), ("bfloat16", [])):
            cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(str(yaml_path), argv))
            models[dtype] = cfg.create_inference_model()
            if str(models[dtype].dtype) != f"torch.{dtype}" or models[dtype].device != dev:
                raise AssertionError(f"eval: {dtype} model is {models[dtype].dtype} on "
                                     f"{models[dtype].device}")
        im = models["float32"]
        n_params = sum(p.numel() for p in im.model.parameters())
        if n_params != W32_PARAMS:
            raise AssertionError(f"eval: W32 from {EVAL_YAML} has {n_params} parameters")
        ds = CocoKeypointsDataset(str(tmp / "coco"), "val2017")
        data = [(ds.load_image(i), image_id_from_path(ds.images_filepaths[i], i), ds.load_annot(i))
                for i in range(len(ds))]
        log(f"eval corpus: {out['corpus']}; W32 {n_params} parameters, flip, input {SIZE}")

        def run(model, bs):
            """The batched evaluator on the images in memory: (it, detections)."""
            ev = BatchedKeypointsEvaluator(model, batch_size=bs)
            for img, image_id, annot in data:
                ev.add(img, image_id, annot)
            return ev, ev.finish()[0]

        # (1) one dense refine and one grouping a dispatched batch
        out["launches"], out["batches"] = {}, {}
        for bs in EVAL_BATCH_SIZES:
            (ev, dets), launches = counted(
                lambda: run(im, bs), f"eval batched bs{bs} float32",
                lambda r: {"match_by_tag": r[0].n_batches, "refine_argmax": r[0].n_batches})
            out["launches"][bs], out["batches"][bs] = launches, ev.n_batches
            out["buckets"] = sorted(ev.buckets)
            if not dets or not all(np.isfinite(d["keypoints"]).all() for d in dets):
                raise AssertionError(f"eval bs{bs}: {len(dets)} detections, or non-finite ones")
            log(f"eval batched bs{bs}: {ev.n_batches} batches over {len(ev.buckets)} buckets "
                f"{out['buckets']}, {len(dets)} detections; one launch of each kernel a batch")

        # (2) per-image decode and (3) the batch-N forward, on the largest bucket
        probe = BatchedKeypointsEvaluator(im, batch_size=8)
        by_key = collections.defaultdict(list)
        for img, _, _ in data:
            by_key[probe._bucket_key(img.shape[:2])].append(img)
        imgs = max(by_key.values(), key=len)[:8]
        xs = np.stack([im.prepare_input(img)[0][0] for img in imgs])
        hw = xs.shape[1:3]
        valid_hw = [(hw[0] - hw[0] // 8 * (i % 3), hw[1] - hw[1] // 8 * (i // 3))
                    for i in range(len(imgs))]
        x = im.to_device(xs)
        avg, tags = im.forward_scale(x, hw)
        batched, _ = counted(
            lambda: im.decode_masked(avg, tags, hw, 1.0,
                                     torch.tensor(valid_hw, dtype=torch.int32, device=dev)),
            f"eval: decode of one batch ({len(imgs)} at {hw}, E=2) with a valid size an image",
            {"match_by_tag": 1, "refine_argmax": 1})
        fwd_rel = fwd_abs = 0.0
        for i, vhw in enumerate(valid_hw):
            alone = im.decode_masked(avg[i:i + 1], [t[i:i + 1] for t in tags], hw, 1.0, vhw)
            if not all(torch.equal(got[i:i + 1], want) for got, want in zip(batched, alone)):
                raise AssertionError(f"eval: image {i} (valid {vhw}) decodes differently in the batch")
            a1, t1 = im.forward_scale(x[i:i + 1], hw)
            for got, want in ((avg[i:i + 1], a1), *((t[i:i + 1], u) for t, u in zip(tags, t1))):
                diff = float((got - want).abs().max())
                fwd_abs = max(fwd_abs, diff)
                fwd_rel = max(fwd_rel, diff / max(float(want.abs().max()), 1e-3))
        if fwd_rel > 1e-3:
            raise AssertionError(f"eval: batch-{len(imgs)} float32 forward vs per image: rel {fwd_rel}")
        out["decode_per_image_exact"] = {"batch": len(imgs), "decode_hw": hw, "valid_hw": valid_hw,
                                         "persons": batched[2].sum(1).tolist()}
        out["forward_batch_vs_single"] = {"max_rel_err": fwd_rel, "max_abs_err": fwd_abs}
        log(f"eval: batched decode == per-image decode bit for bit ({len(imgs)} images at {hw}, "
            f"valid sizes {valid_hw}); batch-{len(imgs)} fp32 forward == per image within rel "
            f"{fwd_rel:.3g} (largest difference {fwd_abs:.3g})")

        # the kernels on the batched path's inputs (its last batch at bs 8)
        seen = record_kernel_inputs(lambda: run(im, 8))
        hm, tg, prev, cnt = seen["refine_argmax"]
        cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
        out["kernels"] = {
            "refine_shape": f"B{hm.shape[0]} K{K} HW{hm.shape[2]} E{tg.shape[2]} P{prev.shape[1]}",
            "refine_active_persons": int(cnt.sum()),
            "refine_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch(hm, tg, prev, cnt), iters=20),
            "refine_bound_ms": refine_bound(hm, tg, prev, cnt)[0],
            "match_shape": f"B{cand.shape[0]} K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
            "match_ms": cuda_ms(lambda: cuda_match.match_by_tag_batched(
                cand, det_thr, tag_thr, order, persons), iters=20),
            "match_bound_ms": match_bound(cand, persons)[0]}
        log("eval kernels (bs8 inputs): " + ", ".join(f"{k_} {v}" for k_, v in out["kernels"].items()))

        # where the batched path waits on the host
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(im, 8)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                    if "synchroniz" in str(w.message))
        out["host_syncs_bs8"] = dict(syncs.most_common())
        log(f"eval bs8: host syncs by source line (set_sync_debug_mode): {out['host_syncs_bs8']}")

        # the host's own work an image: the jpeg read, prepare_input (cv2's
        # warp, normalize), the result object and its OKS and COCO export
        t_read = host_ms(lambda: [ds.load_image(i) for i in range(len(ds))]) / len(ds)
        t_prep = host_ms(lambda: [im.prepare_input(img) for img, _, _ in data]) / len(data)
        out["host_ms_an_image"] = {"load_image": t_read, "prepare_input": t_prep}
        log(f"eval host ms an image: load_image (jpeg) {t_read:.2f}, prepare_input (cv2 warp, "
            f"normalize) {t_prep:.2f}  [{smi}]")

        # img/s: serial and batched, float32 and bfloat16, host wall with the
        # images read from disk, after one untimed run each
        out["img_per_s"], out["busy_ms"], out["wall_ms"] = {}, {}, {}
        n = len(ds)
        for dtype, model in models.items():
            eval_keypoints.evaluate_dataset(model, ds, limit=4)
            torch.cuda.synchronize()
            out["img_per_s"][f"serial_{dtype}"] = n / host_ms(
                lambda: (eval_keypoints.evaluate_dataset(model, ds), torch.cuda.synchronize())) * 1e3
            for bs in EVAL_BATCH_SIZES:
                evaluate_dataset_batched(model, ds, bs, progress=False)
                out["img_per_s"][f"batched_bs{bs}_{dtype}"] = n / host_ms(
                    lambda: evaluate_dataset_batched(model, ds, bs, progress=False), iters=2) * 1e3
            wall = host_ms(lambda: run(model, 8), iters=2)
            busy, groups = profile_breakdown(lambda: run(model, 8))
            out["wall_ms"][dtype], out["busy_ms"][dtype] = wall, busy
            out[f"busy_groups_ms_{dtype}"] = groups
            log(f"eval {dtype}: img/s serial {out['img_per_s'][f'serial_{dtype}']:.2f}, batched "
                + ", ".join(f"bs{bs} {out['img_per_s'][f'batched_bs{bs}_{dtype}']:.2f}"
                            for bs in EVAL_BATCH_SIZES)
                + f"; batched bs8 from memory: {wall:.1f} ms wall, device busy {busy} ms (idle share "
                f"{'not measured' if busy is None else f'{max(0.0, 1 - busy / wall):.3f}'})  [{smi}]")

        # (4) the CLI, serial and batched, in working directories of its own
        cudnn = torch.backends.cudnn
        saved = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
        out["cli"] = {}
        try:
            for mode, extra in (("serial", []), ("batched", ["--batch_size=8"])):
                work = tmp / f"cli_{mode}"
                work.mkdir()
                t0 = time.perf_counter()
                with contextlib.chdir(work):
                    out_dir = work / eval_keypoints.main([f"--config={yaml_path}", *extra])
                secs = time.perf_counter() - t0
                files = sorted(p.name for p in out_dir.iterdir())
                summary = (out_dir / "coco_output.txt").read_text()
                dets = json.loads((out_dir / "val2017_results.json").read_text())
                if files != EVAL_OUT_FILES or "Average Precision" not in summary or not dets:
                    raise AssertionError(f"eval CLI {mode}: files {files}, {len(dets)} detections")
                out["cli"][mode] = {"seconds": secs, "files": files, "detections": len(dets),
                                    "ap_line": summary.splitlines()[0]}
                log(f"eval CLI {mode}: {files}, {len(dets)} detections, {secs:.1f}s with the model's "
                    f"build; {summary.splitlines()[0]}")
        finally:
            cudnn.benchmark, cudnn.deterministic, cudnn.enabled = saved
    return out


def eval_only(dev, smi: str) -> int:
    """Phase 8 alone: build the dense refine and the grouping, then the COCO
    evaluation phase. Prints the phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build, cuda_decode, cuda_match

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted({"match_by_tag": cuda_match.match_by_tag_batched,
                            "refine_argmax": cuda_decode.refine_argmax_batch})
    print(json.dumps({"eval": eval_phase(dev, counted, smi)}), flush=True)
    return 0


# the training phase (phase 9): a reduced net for the card-vs-CPU step, then
# W32 from the keypoints yaml at its published point (Adam, lr 1e-3, batch
# 36, 512^2, 30 persons), its batch made on the card
TRAIN_YAML = EVAL_YAML
TRAIN_REDUCED = {"num_kpts": K, "C": 8, "num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1,
                 "num_deconv_resid_blocks": 1}
TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SIZE = 4, 128
TRAIN_STEPS = 5


def train_batch(n: int, size: int, persons: int, gen, device) -> dict:
    """A seeded keypoints batch made on ``device`` (``gen`` is a generator
    there): uint8 images, heatmaps at 1/4 and 1/2 resolution, masks of ones,
    joints of ``persons`` x K on the 1/4 grid, about half visible (as
    tests/test_train_steps.py's ``make_kpts_batch``)."""
    import torch

    kw = {"generator": gen, "device": device}
    h4, h2 = size // 4, size // 2
    joints = torch.stack([torch.randint(0, h4, (n, persons, K), **kw),
                          torch.randint(0, h4, (n, persons, K), **kw),
                          (torch.rand((n, persons, K), **kw) > 0.5).long()], -1).to(torch.int32)
    return {"images": torch.randint(0, 256, (n, 3, size, size), dtype=torch.uint8, **kw),
            "heatmaps": [torch.rand((n, K, h4, h4), **kw), torch.rand((n, K, h2, h2), **kw)],
            "masks": [torch.ones((n, h4, h4), device=device), torch.ones((n, h2, h2), device=device)],
            "joints": joints}


def train_step_card_vs_cpu(dev, lr: float = 1e-3, batch: dict | None = None,
                           what: str = "a seeded batch", cudnn: bool = True,
                           check_grads: bool = True) -> dict:
    """One float32 Adam step (TF32 off) of the reduced net (``TRAIN_REDUCED``,
    batch 4 at 128^2) on the card and on the CPU, from the same
    ``init_keypoints_weights_`` weights and the same batch (``batch``, NCHW
    CPU tensors, or a seeded one made on the CPU). cuDNN's
    backward sums in its own order, so the checks are tolerances: each loss
    term within rel 1e-4; each parameter's gradient within ||card - ref|| /
    ||ref|| <= 1e-3 of ``ref``, the same gradients evaluated in float64 on
    the CPU (a float64 copy of the net: BatchNorm moments in float64 too).
    The CPU's own float32 gradients are not the reference: on phase 9's
    seeded batch they miss float64 by 1.9e-4 where the card's stay within
    1.1e-5 (an H100), and on phase 10's loader batch cuDNN's miss it by
    2.3e-3 of the whole gradient where the CPU's stay within 4.7e-6; both
    gaps are returned. ``cudnn`` False runs the card's step with cuDNN off
    (PyTorch's own convolutions); ``check_grads`` False reports the
    gradients' gap without holding it. Each BatchNorm running statistic
    within 1e-3 of its tensor's
    largest value; the parameters after the step within 2e-5 + 1e-6 where
    both gradients have one sign and |g| >= 1e-6 (Adam's first update is lr
    * g / (|g| + 1e-8), so there the two updates differ by at most lr * 1e-8
    * 2 / 1e-6), and within 2 * lr + 1e-6 elsewhere. Raises on a miss;
    returns the largest errors."""
    import copy

    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_keypoints_weights_
    from human_pose_tpu_torch.ops import prep_images
    from human_pose_tpu_torch.train import (
        TrainState, ae_keypoints_loss, create_optimizer, keypoints_train_step,
    )

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 9)
    model = init_keypoints_weights_(HigherHRNet(**TRAIN_REDUCED, device=cpu), gen)
    if batch is None:
        batch = train_batch(TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SIZE, 30, gen, cpu)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    def one_step(where):
        net = copy.deepcopy(model).to(where)
        state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", lr), device=where)
        enabled = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        try:
            _, metrics = keypoints_train_step(state, batch, lr)
        finally:
            torch.backends.cudnn.enabled = enabled
        return net, {k: float(v) for k, v in metrics.items()}

    def reference_grads():
        net = copy.deepcopy(model).double().train()
        hms, tags = net(prep_images(batch["images"]).double())
        total, _ = ae_keypoints_loss(hms, tags, batch["heatmaps"], batch["masks"], batch["joints"])
        total.backward()
        return {name: p.grad for name, p in net.named_parameters()}

    (net_c, m_c), (net_g, m_g) = one_step(cpu), one_step(dev)
    ref = reference_grads()
    out = {"loss_rel": max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c), "metrics_card": m_g}
    grad_rel, cpu_rel, vs_cpu, sd_c, sd_g = {}, {}, {}, net_c.state_dict(), net_g.state_dict()
    p_sure = p_any = 0.0
    ambiguous = total = 0
    for (name, pc), (_, pg) in zip(net_c.named_parameters(), net_g.named_parameters()):
        gc, gg, gr = pc.grad, pg.grad.cpu(), ref[name]
        scale = gr.norm().clamp(min=1e-30)
        grad_rel[name] = float((gg.double() - gr).norm() / scale)
        cpu_rel[name] = float((gc.double() - gr).norm() / scale)
        vs_cpu[name] = float((gg - gc).norm() / gc.norm().clamp(min=1e-30))
        diff = (sd_g[name].cpu() - sd_c[name]).abs()
        sure = (gc.abs() >= 1e-6) & (gg.abs() >= 1e-6) & (torch.sign(gc) == torch.sign(gg))
        p_sure = max(p_sure, float(diff[sure].max()) if bool(sure.any()) else 0.0)
        p_any = max(p_any, float(diff.max()))
        ambiguous += int((~sure).sum())
        total += sure.numel()
    stats = {k: float((sd_g[k].cpu() - sd_c[k]).abs().max() / sd_c[k].abs().max().clamp(min=1e-30))
             for k in sd_c if ".running_" in k}
    moved = sum(not torch.equal(sd_c[k], start[k]) for k in stats)
    card_flat = torch.cat([pg.grad.cpu().double().flatten() for pg in net_g.parameters()])
    ref_flat = torch.cat([g.flatten() for g in ref.values()])
    out.update(grad_rel_max=max(grad_rel.values()),
               grad_rel_worst=max(grad_rel, key=grad_rel.get),
               grad_rel_global=float((card_flat - ref_flat).norm() / ref_flat.norm()),
               cpu_grad_rel_max=max(cpu_rel.values()), cpu_grad_rel_worst=max(cpu_rel, key=cpu_rel.get),
               grad_rel_vs_cpu_max=max(vs_cpu.values()),
               bn_stats_rel_max=max(stats.values()), bn_stats_moved=f"{moved} of {len(stats)}",
               params_sure_abs_max=p_sure, params_abs_max=p_any,
               params_sign_ambiguous=f"{ambiguous} of {total}")
    n, size = batch["images"].shape[0], batch["images"].shape[-1]
    out["cudnn"] = cudnn
    log(f"train step card vs CPU ({n} x {size}^2, {what}, C=8 reduced, float32, TF32 off, cuDNN "
        f"{'on' if cudnn else 'off'}): " + ", ".join(f"{k} {v}" for k, v in out.items()))
    grads_ok = out["grad_rel_max"] <= 1e-3 or not check_grads
    if not (out["loss_rel"] <= 1e-4 and grads_ok and out["bn_stats_rel_max"] <= 1e-3
            and moved == len(stats) and p_sure <= 2e-5 + 1e-6 and p_any <= 2 * lr + 1e-6):
        raise AssertionError(f"train step card vs CPU: {out}")
    return out


def train_phase(dev, counted, smi: str) -> dict:
    """Phase 9: the port's keypoints training step on the card. (1) the
    reduced step card vs CPU (``train_step_card_vs_cpu``); (2) HigherHRNet-W32
    from ``TRAIN_YAML`` with ``init_keypoints_weights_``, the yaml's optimizer
    and scheduler (Adam, lr 1e-3, MultiStepLR) at its batch size and input
    size, on a batch made on the card, in float32 (TF32 off) and in bfloat16
    autocast: after one step (cuDNN autotunes) and a 3 s warm-up,
    ``TRAIN_STEPS`` steps timed by host wall to a device sync (median,
    spread, img/s), the peak memory, the device busy time and idle share of
    one step (profiler), every step's losses finite; ``accumulated_keypoints_train_step(2)`` once on the same batch.
    All of it with every kernel's launch counter zeroed before and required
    at 0 after: no kernel of the port lies on the training path."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.models import init_keypoints_weights_
    from human_pose_tpu_torch.train import (
        TrainState, accumulated_keypoints_train_step, create_lr_scheduler, create_optimizer,
        keypoints_train_step,
    )

    out = {"card": smi}

    def run():
        out["card_vs_cpu"] = train_step_card_vs_cpu(dev)
        cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
            str(Path(__file__).resolve().parent / TRAIN_YAML), []))
        opt_cfg, sched_cfg = cfg.module.optimizers["optim"], cfg.module.lr_schedulers["optim"]
        opt_params = dict(opt_cfg["params"])
        base_lr = opt_params.pop("lr")
        n, size = cfg.dataloader.batch_size, cfg.dataloader.train_ds.out_size
        persons = cfg.dataloader.train_ds.max_num_people
        model = init_keypoints_weights_(cfg.create_net(device=dev), torch.Generator().manual_seed(SEED))
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != W32_PARAMS:
            raise AssertionError(f"train: W32 from {TRAIN_YAML} has {n_params} parameters")
        init = {k: v.clone() for k, v in model.state_dict().items()}
        batch = train_batch(n, size, persons, torch.Generator(device=dev).manual_seed(SEED), dev)
        out.update(batch=n, size=size, persons=persons, optimizer=opt_cfg["name"], lr=base_lr,
                   scheduler=sched_cfg["name"], params=n_params,
                   visible_joints=int((batch["joints"][..., 2] > 0).sum()))
        log(f"train: W32 ({n_params} parameters) from {TRAIN_YAML}, {opt_cfg['name']} lr {base_lr}, "
            f"{sched_cfg['name']}, batch {n} at {size}^2 made on the card, {persons} persons an image")
        cudnn = torch.backends.cudnn
        saved = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
        cfg.apply_cudnn()
        try:
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                model.load_state_dict(init)
                sched = create_lr_scheduler(base_lr, sched_cfg["name"], sched_cfg["interval"],
                                            **sched_cfg["params"])
                state = TrainState.create(
                    model, create_optimizer(model.parameters(), opt_cfg["name"], base_lr, **opt_params),
                    dtype=dtype, device=dev)
                losses = []

                def step():
                    losses.append(keypoints_train_step(state, batch, sched.lr)[1])
                    torch.cuda.synchronize()

                torch.cuda.empty_cache()
                base_mem = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step()  # cuDNN's autotuning of the step's shapes (cudnn.benchmark)
                warm = 1 + warm_up(step, 3.0)
                times = [host_ms(step) for _ in range(TRAIN_STEPS)]
                peak = torch.cuda.max_memory_allocated()
                busy, groups = profile_breakdown(step)
                ms = float(np.median(times))
                values = [{k: float(v) for k, v in m.items()} for m in losses]
                if not all(np.isfinite(v).all() for m in values for v in m.values()):
                    raise AssertionError(f"train {name}: non-finite losses {values}")
                rec = {"warmup_steps": warm, "ms": ms, "ms_min": min(times), "ms_max": max(times),
                       "img_per_s": n / ms * 1e3, "peak_gib": peak / 2**30,
                       "peak_over_start_gib": (peak - base_mem) / 2**30, "busy_ms": busy,
                       "idle_share": None if busy is None else max(0.0, 1 - busy / ms),
                       "busy_groups_ms": groups, "steps": state.step,
                       "loss_per_step": [m["loss"] for m in values]}
                out[name] = rec
                idle = "not measured" if busy is None else f"{rec['idle_share']:.3f}"
                log(f"train {name}: {ms:.1f} ms a step (median of {TRAIN_STEPS} after {warm} warm-up "
                    f"steps; {min(times):.1f}-{max(times):.1f}), {rec['img_per_s']:.2f} img/s, peak "
                    f"{rec['peak_gib']:.2f} GiB ({rec['peak_over_start_gib']:.2f} over the phase's start), "
                    f"device busy {busy} ms (idle share {idle}); loss a step "
                    f"{[round(v, 6) for v in rec['loss_per_step']]}  [{smi}]")
                if dtype == torch.float32:
                    _, acc = accumulated_keypoints_train_step(2)(state, batch, sched.lr)
                    acc = {k: float(v) for k, v in acc.items()}
                    if not all(np.isfinite(v) for v in acc.values()):
                        raise AssertionError(f"train: accumulated step metrics {acc}")
                    out["accumulated_2"] = acc
                    log(f"train float32 accumulated_keypoints_train_step(2): {acc}")
        finally:
            cudnn.benchmark, cudnn.deterministic, cudnn.enabled = saved

    _, out["launches"] = counted(run, "phase 9 (training: reduced card vs CPU, W32 float32 and "
                                      "bfloat16 steps, accumulated step)", {})
    return out


def train_only(dev, smi: str) -> int:
    """Phase 9 alone: no kernel is built (none lies on the training path);
    every kernel's launch counter is still required to stay at 0. Prints the
    phase's record as one JSON object last."""
    counted = make_counted(kernel_counters())
    print(json.dumps({"train": train_phase(dev, counted, smi)}), flush=True)
    return 0


# phase 10, the training input pipeline: a synthesized train2017 / val2017
# directory, the yaml's loader at its point (batch 36, 512^2, heatmaps 128^2
# and 256^2, sigma 2, 30 persons, no mosaic), W32 trained from its batches
TRAIN_DATA_N_IMAGES = 72  # two batches of 36 an epoch
TRAIN_DATA_N_VAL = 12
TRAIN_DATA_PERSONS = (2, 9)  # 2-8 persons an image
TRAIN_DATA_CROWD_EVERY = 9
TRAIN_DATA_WORKERS = (4, 8)
TRAIN_DATA_EPOCHS = 1  # epochs a loader-rate reading
TRAIN_DATA_STEPS = 6  # timed steps from the loader, across epoch boundaries
TRAIN_DATA_REPEAT = 5  # the training set repeated in the steady-state epoch
TRAIN_DATA_STEADY_STEPS = 4  # timed steps within that epoch
TRAIN_DATA_CARD_STEPS = 4  # timed steps on phase 9's batch made on the card


def splat_parity(sigma: float, persons: int) -> dict:
    """The native splat against its plain NumPy loop on seeded joints at the
    two heatmap sizes (coordinates 3 past every edge, vis 0-2): the largest
    difference (held at 1e-6, as the JAX package holds its extension) and
    ms a call of each."""
    from human_pose_tpu_torch.data import HeatmapGenerator

    rs = np.random.RandomState(SEED + 10)
    out = {}
    for size in (SIZE // 4, SIZE // 2):
        gen = HeatmapGenerator(K, size, sigma)
        joints = np.stack([rs.randint(-3, size + 3, (persons, K)), rs.randint(-3, size + 3, (persons, K)),
                           rs.randint(0, 3, (persons, K))], -1).astype(np.int32)
        err = float(np.abs(gen(joints) - gen.plain(joints)).max())
        out[size] = {"max_abs_err": err, "native_ms": host_ms(lambda: gen(joints), iters=20),
                     "plain_ms": host_ms(lambda: gen.plain(joints), iters=3),
                     "visible_in_map": int(((joints[..., 2] > 0) & (joints[..., :2] >= 0).all(-1)
                                            & (joints[..., :2] < size).all(-1)).sum())}
        if err > 1e-6:
            raise AssertionError(f"splat at {size}^2: native vs plain differ by {err}")
    log("splat native vs plain (30 persons x 17, sigma 2): " + ", ".join(
        f"{size}^2 max |diff| {r['max_abs_err']:.3g}, native {r['native_ms']:.3f} ms, plain "
        f"{r['plain_ms']:.2f} ms a call" for size, r in out.items()))
    return out


def loader_stage_ms(ds, n: int) -> dict:
    """Host ms a sample of each stage of ``__getitem__``, serially on
    samples 0..n-1 of a training dataset (normalizing transform; call it
    twice: the first pass pays first touches): the jpeg
    read (decode, BGR to RGB), the annotation yaml, the mask npy and the
    joints, the affine warps of the image and both masks with the flip, the
    joints targets and the two splats, the normalize, and ``collate`` of the
    n samples (a sample's share); and the whole ``__getitem__`` for
    comparison."""
    from human_pose_tpu_torch.data import collate, get_coco_joints

    affine, flip, normalize = ds.transform.transforms
    stages = dict.fromkeys(("jpeg", "annot_yaml", "mask_and_joints", "warps", "splat", "normalize"), 0.0)
    samples = []
    for idx in range(n):
        rng = np.random.default_rng((SEED, 0, idx))
        rng.random()  # the mosaic draw
        t = [time.perf_counter()]
        img = ds.load_image(idx)
        t.append(time.perf_counter())
        annot = ds.load_annot(idx)
        t.append(time.perf_counter())
        mask = np.load(ds.masks_filepaths[idx])
        joints = get_coco_joints([o for o in annot if o.get("iscrowd", 0) == 0
                                  or o.get("num_keypoints", 0) > 0])
        masks = [mask.astype(np.float32) for _ in range(ds.num_scales)]
        joints_list = [joints.copy() for _ in range(ds.num_scales)]
        t.append(time.perf_counter())
        img, masks, joints_list = flip(*affine(img, masks, joints_list, rng), rng)
        t.append(time.perf_counter())
        padded = [g(j) for g, j in zip(ds.joints_generators, joints_list)]
        hms = [g(p[p.sum(axis=(1, 2)) > 0]) for g, p in zip(ds.hm_generators, padded)]
        t.append(time.perf_counter())
        img = normalize(img, masks, joints_list)[0]
        t.append(time.perf_counter())
        for key, t0, t1 in zip(stages, t, t[1:]):
            stages[key] += (t1 - t0) * 1e3 / n
        samples.append((img, hms, masks, padded[0]))
    stages["collate"] = host_ms(lambda: collate(samples)) / n
    stages["getitem"] = host_ms(lambda: [ds.__getitem__(i, np.random.default_rng((SEED, 0, i)))
                                         for i in range(n)]) / n
    return stages


def loader_rate(dl, epochs: int) -> float:
    """Samples a second of ``dl`` over ``epochs`` epochs (host wall, its
    thread pool's start in each epoch included)."""
    t0 = time.perf_counter()
    n = 0
    for epoch in range(epochs):
        dl.set_epoch(epoch)
        n += sum(b["images"].shape[0] for b in dl)
    return n / (time.perf_counter() - t0)


class Repeated:
    """``dataset`` ``times`` times over, as one longer epoch (each index its
    own augmentation): the loader's steady state, which two batches an
    epoch never reach."""

    def __init__(self, dataset, times: int):
        self.dataset, self.times = dataset, times

    def __len__(self) -> int:
        return len(self.dataset) * self.times

    def __getitem__(self, idx: int, rng=None):
        return self.dataset.__getitem__(idx % len(self.dataset), rng)


def train_data_steps(dev, cfg, smi: str, phase9: dict | None = None) -> dict:
    """W32 from ``cfg`` (``create_module`` on the card, ``create_datamodule``)
    trained from real loader batches through ``DevicePrefetcher`` (pinned
    staging, the side stream), each step timed by host wall to a device
    sync with the time spent waiting for its batch: (1) the datamodule's
    train loader, two batches an epoch: one step (cuDNN's autotuning), a 3 s
    warm-up, then ``TRAIN_DATA_STEPS`` steps across epoch boundaries
    (``set_epoch``); (2) the steady state, the same loader settings over the
    training set repeated ``TRAIN_DATA_REPEAT`` times:
    ``TRAIN_DATA_STEADY_STEPS`` steps within one epoch after two, and the
    device busy time, idle share and groups of one more; (3) phase 9's
    step on its batch made on the
    card: read from ``phase9`` (its record, when phase 9 ran in this
    process), else ``TRAIN_DATA_CARD_STEPS`` steps of this module on it.
    The peak memory; every loss finite. Returns the record, the module and
    the datamodule (for the validation check)."""
    import torch

    from human_pose_tpu_torch.data import DataLoader, collate
    from human_pose_tpu_torch.train import DeviceBatch, DevicePrefetcher

    dm = cfg.create_datamodule()
    module = cfg.create_module()
    if module.device != dev or sum(p.numel() for p in module.model.parameters()) != W32_PARAMS:
        raise AssertionError(f"train data: module on {module.device}, not W32")
    name = str(module.state.dtype).split(".")[-1]
    n = cfg.dataloader.batch_size
    losses = []

    def endless(loader):
        """(epoch, batch) through the prefetcher, epoch after epoch."""
        pf = DevicePrefetcher(loader, module.batch_to_device, buffer=cfg.trainer.device_prefetch,
                              device=dev)
        epoch = 0
        while True:
            pf.set_epoch(epoch)
            for batch in pf:
                yield epoch, batch
            epoch += 1

    def timed(it, steps: int):
        """``steps`` steps from ``it``: (ms, wait ms, epoch) of each."""
        rows = []
        for _ in range(steps):
            t0 = time.perf_counter()
            epoch, batch = next(it)
            t1 = time.perf_counter()
            losses.append(module.training_step(batch))
            torch.cuda.synchronize()
            rows.append(((time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3, epoch))
        return rows

    def summary(rows) -> dict:
        ms = [r[0] for r in rows]
        med = float(np.median(ms))
        return {"ms": med, "ms_min": min(ms), "ms_max": max(ms), "img_per_s": n / med * 1e3,
                "wait_ms": [r[1] for r in rows], "epochs": [r[2] for r in rows]}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"dtype": name}
    it = endless(dm.train_dl)
    try:
        timed(it, 1)
        warm = 1 + warm_up(lambda: timed(it, 1), 3.0)
        rec["boundary"] = {"warmup_steps": warm, **summary(timed(it, TRAIN_DATA_STEPS))}
    finally:
        it.close()  # stops the loader's producer
    if len(set(rec["boundary"]["epochs"])) < 2:
        raise AssertionError(f"train data {name}: timed steps within one epoch {rec['boundary']}")
    dl = dm.train_dl
    it = endless(DataLoader(Repeated(dm.train_ds, TRAIN_DATA_REPEAT), n, collate, num_workers=dl.num_workers,
                            seed=dl.seed))
    try:
        timed(it, 2)
        rec["steady"] = summary(timed(it, TRAIN_DATA_STEADY_STEPS))
        busy, groups = profile_breakdown(lambda: timed(it, 1))
    finally:
        it.close()
    if len(set(rec["steady"]["epochs"])) != 1:
        raise AssertionError(f"train data {name}: steady steps crossed an epoch {rec['steady']}")
    rec["steady"].update(busy_ms=busy, busy_groups_ms=groups,
                         idle_share=None if busy is None else max(0.0, 1 - busy / rec["steady"]["ms"]))
    if phase9 is not None and name in phase9:
        rec["card_batch"] = {k: phase9[name][k] for k in ("ms", "ms_min", "ms_max", "img_per_s")}
        rec["card_batch"]["source"] = "phase 9"
    else:
        card_batch = DeviceBatch(train_batch(n, cfg.dataloader.train_ds.out_size,
                                             cfg.dataloader.train_ds.max_num_people,
                                             torch.Generator(device=dev).manual_seed(SEED), dev))
        card = timed(iter(lambda: (0, card_batch), None), 1 + TRAIN_DATA_CARD_STEPS)[1:]
        rec["card_batch"] = {k: v for k, v in summary(card).items() if k not in ("wait_ms", "epochs")}
        rec["card_batch"]["source"] = "this module"
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"train data {name}: non-finite losses {values}")
    rec.update(steps=module.state.step, loss_first_last=[values[0]["loss"], values[-1]["loss"]],
               native_splats=[g.native_calls for g in dm.train_ds.hm_generators])
    b, st, cb = rec["boundary"], rec["steady"], rec["card_batch"]
    idle = "not measured" if busy is None else f"{st['idle_share']:.3f}"
    log(f"train data {name}: from the loader, two batches an epoch: {b['ms']:.1f} ms a step (median "
        f"of {TRAIN_DATA_STEPS} after {warm} warm-up steps; {b['ms_min']:.1f}-{b['ms_max']:.1f}; epochs "
        f"{b['epochs']}; waits {[round(w, 1) for w in b['wait_ms']]} ms), {b['img_per_s']:.2f} img/s; "
        f"steady ({TRAIN_DATA_REPEAT}x the set an epoch): {st['ms']:.1f} ms ({st['ms_min']:.1f}-"
        f"{st['ms_max']:.1f}; waits {[round(w, 1) for w in st['wait_ms']]} ms), {st['img_per_s']:.2f} "
        f"img/s, device busy {busy} ms (idle share {idle}); the card's own batch {cb['ms']:.1f} ms "
        f"({cb['ms_min']:.1f}-{cb['ms_max']:.1f}), {cb['img_per_s']:.2f} img/s; peak "
        f"{rec['peak_gib']:.2f} GiB  [{smi}]")
    return rec, module, dm


def train_data_phase(dev, counted, smi: str, phase9: dict | None = None) -> dict:
    """Phase 10: the keypoints training input pipeline on the card. (a) a
    synthesized ``train2017`` (72 images) and ``val2017`` (12) directory in
    COCO's commonest raw sizes, 2-8 persons an image, a crowd region every
    9th image; (b) the native splat against its plain version; (c) the host
    loader's samples a second at the yaml's point with 4 and 8 workers,
    normal and compact, and the host ms a sample of each stage; (d) W32 from
    ``TRAIN_YAML`` (roots overridden) through ``create_datamodule`` and
    ``create_module``, float32 (TF32 off) and bfloat16, trained from the
    loader through ``DevicePrefetcher`` beside phase 9's batch made on the
    card (``train_data_steps``; ``phase9`` is phase 9's record when it ran
    in this process); (e) ``validation_step`` and
    ``make_results`` on a val batch with the launch counters zeroed: one
    launch of the dense refine and one of the grouping, every output
    finite; (f) the reduced net's step on one loader batch (128^2, batch 4)
    card vs CPU (``train_step_card_vs_cpu``). Any failed check raises."""
    import tempfile

    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.train import host_batch_to_device

    rng = np.random.default_rng(SEED + 10)
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "coco"
        t0 = time.perf_counter()
        out["corpus"] = {
            split: make_eval_corpus(root, rng, split, n, TRAIN_DATA_PERSONS, TRAIN_DATA_CROWD_EVERY)
            for split, n in (("train2017", TRAIN_DATA_N_IMAGES), ("val2017", TRAIN_DATA_N_VAL))}
        log(f"train data corpus ({time.perf_counter() - t0:.1f}s): {out['corpus']}")
        roots = [f"--dataloader.train_ds.root={root}", f"--dataloader.val_ds.root={root}"]
        yaml_path = str(Path(__file__).resolve().parent / TRAIN_YAML)

        def config(*argv):
            return KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(yaml_path, [*roots, *argv]))

        cfg = config()
        ds_cfg = cfg.dataloader.train_ds
        out["point"] = {"batch": cfg.dataloader.batch_size, "size": ds_cfg.out_size,
                        "hm_sizes": [int(r * ds_cfg.out_size) for r in ds_cfg.hm_resolutions],
                        "sigma": ds_cfg.sigma, "max_persons": ds_cfg.max_num_people,
                        "mosaic": ds_cfg.mosaic_probability, "workers": cfg.dataloader.num_workers,
                        "pin_memory": cfg.dataloader.pin_memory,
                        "device_prefetch": cfg.trainer.device_prefetch}

        # (b) the splat
        out["splat"] = splat_parity(ds_cfg.sigma, ds_cfg.max_num_people)

        # (c) the host loader
        dm = cfg.create_datamodule()
        first = loader_stage_ms(dm.train_ds, cfg.dataloader.batch_size)
        out["host_ms_a_sample"] = loader_stage_ms(dm.train_ds, cfg.dataloader.batch_size)
        out["host_ms_a_sample"]["getitem_first_pass"] = first["getitem"]
        out["host_cpus"] = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}
        log(f"train data host ms a sample, one thread ({out['host_cpus']}): " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["host_ms_a_sample"].items()))
        out["loader_samples_per_s"] = {}
        for compact in (False, True):
            dl = (config("--dataloader.compact_batches=true") if compact else cfg).create_datamodule().train_dl
            for workers in TRAIN_DATA_WORKERS:
                dl.num_workers = workers
                key = f"{'compact' if compact else 'normal'}_w{workers}"
                out["loader_samples_per_s"][key] = loader_rate(dl, TRAIN_DATA_EPOCHS)
            if not all(g.native_calls > 0 for g in dl.dataset.hm_generators):
                raise AssertionError("train data: the dataset's heatmaps did not go through the native splat")
        log(f"train data loader samples/s ({TRAIN_DATA_EPOCHS} epochs of {TRAIN_DATA_N_IMAGES}): "
            + ", ".join(f"{k} {v:.1f}" for k, v in out["loader_samples_per_s"].items()) + f"  [{smi}]")

        # (d) W32 from the loader, float32 then bfloat16
        cudnn = torch.backends.cudnn
        saved = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
        try:
            for argv in (["--trainer.accelerator=gpu"], []):
                run_cfg = config(*argv)
                run_cfg.apply_cudnn()
                rec, module, run_dm = train_data_steps(dev, run_cfg, smi, phase9)
                out[rec["dtype"]] = rec
                if rec["dtype"] == "bfloat16":
                    # (e) validation with the decode's kernels
                    val_batch = next(iter(run_dm.val_dl))

                    def validate():
                        metrics, outputs = module.validation_step(val_batch)
                        return metrics, outputs, module.make_results(val_batch, outputs)

                    (metrics, outputs, results), launches = counted(
                        validate, "phase 10 (validation_step + make_results on a val batch)",
                        {"match_by_tag": 1, "refine_argmax": 1})
                    arrays = [*outputs[0], outputs[1], *(torch.as_tensor(v) for v in metrics.values())]
                    arrays += [torch.from_numpy(np.asarray(getattr(r, f), np.float32)) for r in results
                               for f in ("kpts_heatmaps", "tags_heatmaps", "kpts_coords", "kpts_scores",
                                         "obj_scores")]
                    if not all(bool(torch.isfinite(a).all()) for a in arrays):
                        raise AssertionError("train data: non-finite validation outputs")
                    out["validation"] = {"launches": launches, "batch": int(val_batch["images"].shape[0]),
                                         "metrics": {k: float(v) for k, v in metrics.items()},
                                         "results": len(results),
                                         "persons": [len(r.obj_scores) for r in results]}
                    log(f"train data validation: {out['validation']}")
                del module
                torch.cuda.empty_cache()
        finally:
            cudnn.benchmark, cudnn.deterministic, cudnn.enabled = saved

        # (f) the reduced net on one loader batch, card vs CPU
        small = config(f"--dataloader.train_ds.out_size={TRAIN_REDUCED_SIZE}",
                       f"--transform.out_size={TRAIN_REDUCED_SIZE}",
                       f"--dataloader.batch_size={TRAIN_REDUCED_BATCH}", "--trainer.accelerator=cpu")
        batch = host_batch_to_device(next(iter(small.create_datamodule().train_dl)), torch.device("cpu"))
        # cuDNN's float32 algorithms (TF32 off) missed float64 by 2.3e-3 of
        # the whole gradient on this batch (an H100; 8.4e-7 with cuDNN off):
        # the port's own arithmetic is held with cuDNN off, cuDNN's gap is
        # read beside it
        out["card_vs_cpu"] = train_step_card_vs_cpu(dev, batch=batch, what="one loader batch",
                                                   cudnn=False)
        out["card_vs_cpu_cudnn"] = train_step_card_vs_cpu(dev, batch=batch, what="one loader batch",
                                                         check_grads=False)
    out["launches"] = out["validation"]["launches"]
    return out


def train_data_only(dev, smi: str) -> int:
    """Phase 10 alone: build the dense refine and the grouping (the
    validation's decode), then the training input pipeline's phase. Prints
    the phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"train_data": train_data_phase(dev, counted, smi)}), flush=True)
    return 0


def refine_only(dev, rng, smi: str) -> int:
    """The short loop for the dense refine: build, SASS counts, parity, then
    its time on the main path's and the dense scene's inputs and over a
    sweep of row splits. Prints one JSON object last."""
    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import _build, cuda_decode, decode_batch

    secs = _build.build_kernels(("refine_argmax", "match_by_tag"))
    log(f"build: per kernel {secs}")
    log_build(_build)
    sass = log_refine_sass(_build)
    kpts, tags = make_scene(rng, BATCH, SIZE, SIZE, 1)
    refine_scene_parity(dev, rng, kpts, tags)
    refine_edge_parity(dev)

    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    model.eval()
    images = torch.from_numpy(rng.standard_normal((BATCH, 3, SIZE, SIZE), dtype=np.float32)).to(dev)
    stages_d, tags_d = dense_stage_inputs(kpts, tags, dev)

    def decode(stages, tags_list):
        return decode_batch(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                            det_thr=DET_THR, tag_thr=TAG_THR)

    def infer():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            hms, tg = model(images)
        return decode(hms, [tg])

    main_in = record_kernel_inputs(infer)["refine_argmax"]
    dense_in = record_kernel_inputs(lambda: decode(stages_d, tags_d))["refine_argmax"]
    refine = cuda_decode.refine_argmax_batch
    for what, args in (("main", main_in), ("dense scene", dense_in)):
        if not torch.equal(refine(*args), cuda_decode.refine_argmax_batch_plain(*args)):
            raise AssertionError(f"refine differs from plain on the {what} inputs")
    warm_up(lambda: (refine(*main_in), torch.cuda.synchronize()), 2.0)
    result = {"card": smi, "active_persons": int(main_in[3].sum()),
              "ms_main": cuda_ms(lambda: refine(*main_in), iters=20),
              "ms_dense_scene": cuda_ms(lambda: refine(*dense_in), iters=20),
              "bound_ms": refine_bound(*main_in)[0], "ms_main_by_splits": {},
              "sass": {k: v for k, v in sass.items() if k.endswith("<1>")}}
    for splits in (1, 2, 4, 8, 12, 16, 24, 32, 64):
        result["ms_main_by_splits"][splits] = cuda_ms(lambda: refine(*main_in, splits=splits), iters=20)
    result["ms_main_again"] = cuda_ms(lambda: refine(*main_in), iters=20)
    result["clocks_sm_under_load"] = clocks_under_load(lambda: refine(*main_in), 1500)
    log(f"refine: main {result['ms_main']:.4f} ms (again {result['ms_main_again']:.4f}), dense scene "
        f"{result['ms_dense_scene']:.4f} ms, bound {result['bound_ms']:.4f} ms; by splits "
        f"{ {k: round(v, 4) for k, v in result['ms_main_by_splits'].items()} }; SM clock, max, "
        f"power under load: {result['clocks_sm_under_load']}  [{smi}]")
    print(json.dumps({"refine_only": result}), flush=True)
    return 0


def phase_refine_only(dev, rng, smi: str) -> int:
    """The short loop for the phase refine: build, SASS counts, parity, then
    its time on the fused decode's inputs (forward outputs, stage scene) and
    over a sweep of row splits, and fused vs dense decode on both inputs.
    Prints one JSON object last."""
    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import _build, cuda_aggregate, decode_batch, decode_batch_fused

    secs = _build.build_kernels(("refine_argmax_phase", "fused_aggregate", "match_by_tag",
                                 "refine_argmax"))
    log(f"build: per kernel {secs}")
    log_build(_build)
    sass = log_refine_sass(_build, "refine_argmax_phase")
    text = dump_sass(_build, "refine_argmax_phase")
    loop = None if text is None else hot_loop(text, "refine_phase_scan_kernel<1>", M, 16)
    log(f"phase refine hot loop at E=1, {M} persons (fast instance): {loop}")
    # FRND only in the rintf instances: 4 pixels x every person count compiled
    rintf_frnd = {1: 4 * sum(range(2, 33, 2)), 2: 4 * sum(range(8, 33, 8))}
    for e, want in rintf_frnd.items():
        got = sass.get(f"refine_phase_scan_kernel<{e}>", {}).get("FRND")
        log(f"phase refine scan E={e}: FRND {got}; {want} in the rintf instances if none is in the fast ones")
    q_s, h2_s, t_s = [torch.from_numpy(a).to(dev) for a in make_stage_scene(rng, BATCH, SIZE // 4, SIZE // 4)]
    fused_parity(dev, rng, q_s, h2_s, t_s)

    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    model.eval()
    images = torch.from_numpy(rng.standard_normal((BATCH, 3, SIZE, SIZE), dtype=np.float32)).to(dev)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        hms, tags = model(images)
    inputs = {"forward": (hms, [tags]), "stage_scene": ([q_s, h2_s], [t_s[:, :, 0]])}

    def fused(stages, tags_list):
        return decode_batch_fused(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                                  det_thr=DET_THR, tag_thr=TAG_THR)

    def dense(stages, tags_list):
        return decode_batch(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                            det_thr=DET_THR, tag_thr=TAG_THR)

    refine = cuda_aggregate.refine_argmax_phase_batch
    kin = {what: record_kernel_inputs(lambda a=a: fused(*a))["refine_argmax_phase"]
           for what, a in inputs.items()}
    for what, args in kin.items():
        gi, gv = refine(*args)
        wi, wv = cuda_aggregate.refine_argmax_phase_batch_plain(*args)
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            raise AssertionError(f"phase refine differs from plain on the {what} inputs")
    main_in = kin["forward"]
    warm_up(lambda: (refine(*main_in), torch.cuda.synchronize()), 3.0)
    avg, tl, prev = main_in
    result = {"card": smi, "shape": f"B{BATCH} K{K} H4 {avg.shape[4]} W4 {avg.shape[5]} "
                                    f"E{tl.shape[2]} P{prev.shape[1]}",
              "ms_fused": cuda_ms(lambda: refine(*main_in), iters=20),
              "ms_fused_scene": cuda_ms(lambda: refine(*kin["stage_scene"]), iters=20),
              "bound_ms": refine_phase_bound(*main_in)[0], "ms_fused_by_splits": {},
              "sass": sass}
    result["splits"] = cuda_aggregate.phase_refine_splits(
        BATCH * K, avg.shape[4], avg.shape[5], tl.shape[2],
        torch.cuda.get_device_properties(dev).multi_processor_count)
    for splits in (1, 2, 4, 6, 8, 10, 12, 16, 24, 32, 64):
        result["ms_fused_by_splits"][splits] = cuda_ms(lambda: refine(*main_in, splits=splits), iters=20)
    result["ms_fused_again"] = cuda_ms(lambda: refine(*main_in), iters=20)
    result["hot_loop_e1"] = loop
    result["frnd_in_rintf_instances"] = rintf_frnd
    result["decode_ms"] = decode_times(inputs, fused, dense)
    result["clocks_sm_under_load"] = clocks_under_load(lambda: refine(*main_in), 1000)
    log(f"phase refine: fused {result['ms_fused']:.4f} ms (again {result['ms_fused_again']:.4f}), stage "
        f"scene {result['ms_fused_scene']:.4f} ms, bound {result['bound_ms']:.4f} ms; by splits "
        f"{ {k: round(v, 4) for k, v in result['ms_fused_by_splits'].items()} }; decode fused vs dense "
        f"{result['decode_ms']}; SM clock, max, power under load: {result['clocks_sm_under_load']}  [{smi}]")
    print(json.dumps({"phase_refine_only": result}), flush=True)
    return 0


# strip heights (quarter rows a block) that --aggregate-only times; past H4 skipped
AGG_ROWS_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128)


def aggregate_only(dev, rng, smi: str) -> int:
    """The short loop for the fused aggregate: build, parity, then its time
    on the fused decode's inputs (forward outputs, stage scene) and over a
    sweep of strip heights, the write floor (``fill_`` of two tensors of the
    outputs' size), and fused vs dense decode on both inputs. Prints one JSON
    object last."""
    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import _build, cuda_aggregate, decode_batch, decode_batch_fused

    secs = _build.build_kernels(("fused_aggregate", "refine_argmax_phase", "match_by_tag", "refine_argmax"))
    log(f"build: per kernel {secs}")
    log_build(_build)
    q_s, h2_s, t_s = [torch.from_numpy(a).to(dev) for a in make_stage_scene(rng, BATCH, SIZE // 4, SIZE // 4)]
    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    model.eval()
    images = torch.from_numpy(rng.standard_normal((BATCH, 3, SIZE, SIZE), dtype=np.float32)).to(dev)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        hms, tags = model(images)
    inputs = {"forward": (hms, [tags]), "stage_scene": ([q_s, h2_s], [t_s[:, :, 0]])}

    def fused(stages, tags_list):
        return decode_batch_fused(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                                  det_thr=DET_THR, tag_thr=TAG_THR)

    def dense(stages, tags_list):
        return decode_batch(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                            det_thr=DET_THR, tag_thr=TAG_THR)

    agg = cuda_aggregate.fused_aggregate
    kin = {what: record_kernel_inputs(lambda a=a: fused(*a))["fused_aggregate"] for what, a in inputs.items()}
    aggregate_edge_parity(dev)
    for what, args in kin.items():
        got, want = agg(*args), cuda_aggregate.fused_aggregate_plain(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"fused aggregate differs from plain on the {what} inputs")
    log(f"parity: fused aggregate equal to plain on the fused decode's inputs ({', '.join(kin)})")
    q, h2 = kin["forward"]
    b, k, h4, w4 = q.shape
    warm_up(lambda: (agg(q, h2), torch.cuda.synchronize()), 3.0)
    avg = torch.empty((b, k, 4, 4, h4, w4), dtype=torch.float32, device=dev)
    sup = torch.empty_like(avg)
    result = {"card": smi, "shape": f"B{b} K{k} H4 {h4} W4 {w4}",
              "ms_fused": cuda_ms(lambda: agg(q, h2), iters=20),
              "ms_fused_scene": cuda_ms(lambda: agg(*kin["stage_scene"]), iters=20),
              "bound_ms": aggregate_bound(q, h2)[0],
              "write_floor_ms": cuda_ms(lambda: (avg.fill_(0.0), sup.fill_(0.0)), iters=20),
              "ms_fused_by_rows": {}}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    result["rows"], result["threads"] = cuda_aggregate.aggregate_launch(b * k, h4, w4, sm_count)
    for rows in AGG_ROWS_SWEEP:
        if rows <= h4:
            result["ms_fused_by_rows"][rows] = cuda_ms(lambda: agg(q, h2, rows), iters=20)
    result["ms_fused_again"] = cuda_ms(lambda: agg(q, h2), iters=20)
    result["write_floor_ms_again"] = cuda_ms(lambda: (avg.fill_(0.0), sup.fill_(0.0)), iters=20)
    result["decode_ms"] = decode_times(inputs, fused, dense)
    result["clocks_sm_under_load"] = clocks_under_load(lambda: agg(q, h2), 1000)
    log(f"fused aggregate: fused {result['ms_fused']:.4f} ms (again {result['ms_fused_again']:.4f}), stage "
        f"scene {result['ms_fused_scene']:.4f} ms, bound {result['bound_ms']:.4f} ms, write floor "
        f"{result['write_floor_ms']:.4f} ms; by rows "
        f"{ {r: round(v, 4) for r, v in result['ms_fused_by_rows'].items()} }; decode fused vs dense "
        f"{result['decode_ms']}; SM clock, max, power under load: {result['clocks_sm_under_load']}  [{smi}]")
    print(json.dumps({"aggregate_only": result}), flush=True)
    return 0


def block_only(dev, gen, smi: str) -> int:
    """The short loop for the fused BasicBlock: build, HGMMA per instance,
    parity at the four W32 branch shapes in both dtypes, then the times of
    ``block_times`` after a 3 s warm-up, and cuDNN's float32 pair with TF32
    on (one TF32 product: an example, not a target; it misses 1e-4). Prints
    one JSON object last."""
    import torch

    from human_pose_tpu_torch.ops import _build, cuda_conv

    secs = _build.build_kernels(("fused_basic_block",))
    log(f"build: {secs}")
    log_build(_build)
    sass = block_hgmma(_build)
    rows = basic_block_parity(dev, gen)
    x, w1, b1, w2, b2 = rows[0]["inputs"]
    packed = cuda_conv.pack_block_weights(w1, b1, w2, b2, dtype=x.dtype)
    warm_up(lambda: (cuda_conv.fused_basic_block_packed(x, *packed), torch.cuda.synchronize()), 3.0)
    shapes = block_times(rows, smi)
    for r, rec in zip(rows, shapes):
        if rec["dtype"] == "float32":
            want = cuda_conv.fused_basic_block_plain(*r["inputs"])  # TF32 off
            pair = cudnn_pair(*r["inputs"])
            torch.backends.cudnn.allow_tf32 = True
            rec["library_tf32_ms"] = cuda_ms(pair, iters=10)
            rec["library_tf32_max_abs_err"] = float((pair().permute(0, 2, 3, 1) - want).abs().max())
            torch.backends.cudnn.allow_tf32 = False
    clocks = clocks_under_load(lambda: cuda_conv.fused_basic_block_packed(x, *packed), 2000)
    log(f"SM clock, max, power under load: {clocks}  [{smi}]")
    print(json.dumps({"block_only": {"card": smi, "build_s": secs, "sass": sass, "shapes": shapes,
                                     "clocks_sm_under_load": clocks}}), flush=True)
    return 0


def infer_only(dev, rng, smi: str) -> int:
    """Phase 6 alone: build the dense refine and the grouping, then the
    inference model's configurations on the seeded W32 model. Prints the
    phase's record as one JSON object last."""
    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import _build, cuda_decode, cuda_match

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    model.eval()
    counted = make_counted({"match_by_tag": cuda_match.match_by_tag_batched,
                            "refine_argmax": cuda_decode.refine_argmax_batch})
    print(json.dumps({"inference": inference_phase(dev, model, rng, counted, smi)}), flush=True)
    return 0


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--refine-only", action="store_true",
                        help="build, check and time the dense refine kernel alone")
    parser.add_argument("--phase-refine-only", action="store_true",
                        help="build, check and time the phase refine kernel alone")
    parser.add_argument("--aggregate-only", action="store_true",
                        help="build, check and time the fused aggregate kernel alone")
    parser.add_argument("--block-only", action="store_true",
                        help="build, check and time the fused BasicBlock kernel alone")
    parser.add_argument("--infer-only", action="store_true",
                        help="build the decode's kernels and run the inference model's phase alone")
    parser.add_argument("--eval-only", action="store_true",
                        help="build the decode's kernels and run the COCO evaluation phase alone")
    parser.add_argument("--train-only", action="store_true",
                        help="run the training phase alone (it builds no kernel)")
    parser.add_argument("--train-data-only", action="store_true",
                        help="build the decode's kernels and run the training input pipeline's "
                             "phase alone")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    import human_pose_tpu_torch
    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import (
        _build, cuda_aggregate, cuda_conv, cuda_decode, cuda_match, decode_batch, decode_batch_fused,
        fold_basic_block,
    )

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
    gen = torch.Generator().manual_seed(SEED + 1)
    if args.refine_only:
        return refine_only(dev, rng, smi)
    if args.phase_refine_only:
        return phase_refine_only(dev, rng, smi)
    if args.aggregate_only:
        return aggregate_only(dev, rng, smi)
    if args.block_only:
        return block_only(dev, gen, smi)
    if args.infer_only:
        return infer_only(dev, rng, smi)
    if args.eval_only:
        return eval_only(dev, smi)
    if args.train_only:
        return train_only(dev, smi)
    if args.train_data_only:
        return train_data_only(dev, smi)

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f}s wall, per kernel {secs}")
    log_build(_build)
    hgmma = block_hgmma(_build)
    refine_sass = log_refine_sass(_build)
    phase_sass = log_refine_sass(_build, "refine_argmax_phase")

    # 3. kernel parity
    errs, scenes = phase_parity(dev, rng)
    log(f"stage scene bs{BATCH}: {SIZE // 4}^2 and {SIZE // 2}^2 heatmaps, {SIZE // 4}^2 tags, "
        f"{N_PERSONS} persons ...")
    q_s, h2_s, t_s = [torch.from_numpy(a).to(dev)
                      for a in make_stage_scene(rng, BATCH, SIZE // 4, SIZE // 4)]
    errs.update(fused_parity(dev, rng, q_s, h2_s, t_s))
    block_rows = basic_block_parity(dev, gen)

    # 4. main path
    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    model.eval()
    images = torch.from_numpy(rng.standard_normal((BATCH, 3, SIZE, SIZE), dtype=np.float32)).to(dev)
    stages_d, tags_d = dense_stage_inputs(*scenes[1], dev)
    stages_s, tags_s = [q_s, h2_s], [t_s[:, :, 0]]

    def forward(x):
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            return model(x)

    def dense(stages, tags_list):
        return decode_batch(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                            det_thr=DET_THR, tag_thr=TAG_THR)

    def fused(stages, tags_list):
        return decode_batch_fused(stages, tags_list, (SIZE, SIZE), max_num_people=M,
                                  det_thr=DET_THR, tag_thr=TAG_THR)

    def infer(x):
        """The main path: forward, then decode. Returns (hms, tags, decoded)."""
        hms, tags = forward(x)
        return hms, tags, dense(hms, [tags])

    def decode_dense():
        return dense(stages_d, tags_d)

    counted = make_counted(kernel_counters())

    dense_want = {"match_by_tag": 1, "refine_argmax": 1}
    (hms, tags, (joints, scores, valid)), launches = counted(
        lambda: infer(images), "main path (forward + decode)", dense_want)
    (dj, ds, dv), launches_dense = counted(decode_dense, "dense-scene decode", dense_want)

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

    # 5. the fused path, on the forward's outputs and on the stage scene
    fused_want = {"fused_aggregate": 1, "match_by_tag": 1, "refine_argmax_phase": 1}
    (fj, fs, fv), launches_fused = counted(lambda: fused(hms, [tags]),
                                           "fused decode of the forward's outputs", fused_want)
    (sj, ss, sv), launches_fused_scene = counted(lambda: fused(stages_s, tags_s),
                                                 "fused decode of the stage scene", fused_want)
    (rj, rs, rv), _ = counted(lambda: dense(stages_s, tags_s), "dense decode of the stage scene",
                              dense_want)
    for name_, t in (("fused joints", fj), ("fused scores", fs), ("scene joints", sj)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name_}")
    if tuple(fj.shape) != (BATCH, M, K, 4) or tuple(fv.shape) != (BATCH, M):
        raise AssertionError(f"fused decode shapes {tuple(fj.shape)} {tuple(fv.shape)}")
    # the scene's maps are dyadic, so both front ends see the same values
    score_err = max(float((ss - rs).abs().max()), float((sj[..., 2] - rj[..., 2]).abs().max()))
    if not (torch.equal(sv, rv) and torch.equal(sj[..., :2], rj[..., :2]) and score_err <= 1e-5):
        raise AssertionError(f"stage scene: fused vs dense decode differ (persons "
                             f"{sv.sum(1).tolist()} vs {rv.sum(1).tolist()}, scores {score_err})")
    log(f"stage scene: fused == dense decode ({sv.sum(1).tolist()} persons; joints x, y equal; "
        f"scores within {score_err:.3g})")
    both = fv & valid
    persons_differ = int((fv != valid).sum())
    joints_differ = int(((fj[..., :2] != joints[..., :2]).any(-1) & both[..., None]).sum())
    log(f"forward outputs: fused vs dense decode: {persons_differ} person slots differ in validity, "
        f"{joints_differ} of {int(both.sum()) * K} joints of persons valid in both differ in x, y "
        "(not asserted: the two resize formulations differ by ulps)")
    for what, stages, tags_list, (gj, gs, gv) in (
            ("forward outputs", hms, [tags], (fj, fs, fv)), ("stage scene", stages_s, tags_s, (sj, ss, sv))):
        cj, cs, cv = decode_batch_fused([x[:2].cpu() for x in stages], [t[:2].cpu() for t in tags_list],
                                        (SIZE, SIZE), max_num_people=M, det_thr=DET_THR, tag_thr=TAG_THR)
        # joints: the kernels equal their plain versions, so x, y and score are
        # exact; person scores are means over K summed in another order on
        # each device: within 1e-6 of their scale
        joints_equal = torch.equal(gj[:2, ..., :3].cpu(), cj[..., :3])
        rel = float((gs[:2].cpu() - cs).abs().max() / cs.abs().max().clamp(min=1.0))
        if not (torch.equal(gv[:2].cpu(), cv) and joints_equal and rel <= 1e-6):
            raise AssertionError(f"{what}: fused decode card vs CPU: persons {gv[:2].sum(1).tolist()} "
                                 f"vs {cv.sum(1).tolist()}, joints equal {joints_equal}, "
                                 f"person scores rel {rel}")
        log(f"{what}: fused decode card == CPU path on 2 images ({cv.sum(1).tolist()} persons, "
            f"joint x, y, score equal, person scores within {rel:.3g} relative; largest person "
            f"score {float(cs.abs().max()):.4g})")

    # the per-image grouping entry on the scene's candidates
    scene_in = record_kernel_inputs(lambda: fused(stages_s, tags_s))
    cand_s, _, _, order_s, persons_s = scene_in["match_by_tag"]
    (pj, pc), launches_per_image = counted(
        lambda: cuda_match.match_by_tag_per_image(cand_s, DET_THR, TAG_THR, order_s, persons_s),
        "per-image grouping of the scene's candidates", {"match_by_tag_per_image": 1})
    bj, bc = cuda_match.match_by_tag_batched(cand_s, DET_THR, TAG_THR, order_s, persons_s)
    t0 = time.perf_counter()
    wj, wc = cuda_match.match_by_tag_batched_plain(cand_s, DET_THR, TAG_THR, order_s, persons_s)
    torch.cuda.synchronize()
    per_image_plain_ms = (time.perf_counter() - t0) * 1e3
    errs["match_by_tag_per_image"] = float((pj - wj).abs().max())
    if not (torch.equal(pj, wj) and torch.equal(pc, wc) and torch.equal(pj, bj) and torch.equal(pc, bc)):
        raise AssertionError("per-image grouping differs from the plain or the batched version")
    log(f"per-image grouping == plain (on the card, {per_image_plain_ms / 1e3:.1f}s) == batched; "
        f"counts {pc.tolist()}")

    # the W32 model's BasicBlocks, folded, through the fused block
    blocks = w32_blocks(model, gen)
    block_x = [torch.rand((BATCH, hw, hw, blk.conv1.in_channels), generator=gen).to(dev)
               for blk, hw in blocks]
    blocks = [blk for blk, _ in blocks]
    folded = [fold_basic_block(blk) for blk in blocks]
    outs, launches_blocks = counted(
        lambda: [cuda_conv.fused_basic_block(xx, *f) for f, x in zip(folded, block_x)
                 for xx in (x, x.to(torch.bfloat16))],
        "W32 BasicBlocks through the fused block (float32, bfloat16)",
        {"fused_basic_block": 2 * len(blocks)})
    fold_errs, bf16_rel = [], 0.0
    with torch.no_grad():
        for i, (blk, x, f) in enumerate(zip(blocks, block_x, folded)):
            want = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            fold_errs.append((x.shape[-1], float((outs[2 * i] - want).abs().max())))
            want_bf16 = cuda_conv.fused_basic_block_plain(x.to(torch.bfloat16), *f).float()
            bf16_rel = max(bf16_rel, float((outs[2 * i + 1].float() - want_bf16).abs().max()
                                           / want_bf16.abs().max()))
    fold_err = max(err for _, err in fold_errs)
    log(f"folded W32 BasicBlocks, float32 vs eval forward by C: "
        + ", ".join(f"C={c} {err:.3g}" for c, err in fold_errs))
    if fold_err > 1e-4 or bf16_rel > 2 ** -6:
        raise AssertionError(f"folded W32 BasicBlocks: float32 vs eval forward {fold_err}, "
                             f"bfloat16 vs plain {bf16_rel} of the output scale")
    log(f"folded W32 BasicBlocks ({len(blocks)}, C=32..256): float32 == eval forward within "
        f"{fold_err:.3g}; bfloat16 == plain within {bf16_rel:.3g} of the output scale")

    # 6. the inference model: configurations (a)-(d), __call__ in (c)
    infer_rec = inference_phase(dev, model, rng, counted, smi)

    # 7. timing
    synced_infer = lambda: (infer(images), torch.cuda.synchronize())  # noqa: E731
    log(f"warm-up: {warm_up(synced_infer, 3.0)} forward+decode calls")
    fwd_ms = cuda_ms(lambda: forward(images), iters=10, warmup=2)
    dec_ms = cuda_ms(lambda: dense(hms, [tags]), iters=5, warmup=1)
    dense_ms = cuda_ms(decode_dense, iters=5, warmup=1)
    wall_ms = host_ms(synced_infer, iters=10)
    log(f"timing bs{BATCH}: forward {fwd_ms:.3f} ms, decode {dec_ms:.3f} ms "
        f"(dense scene {dense_ms:.3f} ms), forward+decode {wall_ms:.3f} ms host wall "
        f"-> {BATCH / wall_ms * 1e3:.2f} img/s  [{smi}]")
    fused_ms = cuda_ms(lambda: fused(hms, [tags]), iters=5, warmup=1)
    scene_ms = {"fused": cuda_ms(lambda: fused(stages_s, tags_s), iters=5, warmup=1),
                "dense": cuda_ms(lambda: dense(stages_s, tags_s), iters=5, warmup=1)}
    log(f"decode bs{BATCH}, forward outputs: fused {fused_ms:.3f} ms vs dense {dec_ms:.3f} ms; "
        f"stage scene: fused {scene_ms['fused']:.3f} ms vs dense {scene_ms['dense']:.3f} ms  [{smi}]")
    busy_ms, busy_groups = profile_breakdown(lambda: infer(images))
    if busy_ms is None:
        log("profile: the profiler recorded no device time; idle share not measured")
    else:
        log(f"profile of one forward+decode: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
            f"wall (idle share {max(0.0, 1 - busy_ms / wall_ms):.3f})")
    fused_busy_ms, fused_groups = profile_breakdown(lambda: fused(hms, [tags]))
    log(f"profile of one fused decode of the forward's outputs: device busy {fused_busy_ms} ms")
    dense_busy_ms, dense_groups = profile_breakdown(lambda: dense(hms, [tags]))
    log(f"profile of one dense decode of the forward's outputs: device busy {dense_busy_ms} ms of "
        f"{dec_ms:.3f} ms between CUDA events (the rest is the host: launches and syncs)")

    # 8. COCO evaluation
    eval_rec = eval_phase(dev, counted, smi)

    # 9. training
    train_rec = train_phase(dev, counted, smi)

    # 10. the training input pipeline
    train_data_rec = train_data_phase(dev, counted, smi, train_rec)

    # each kernel on the exact inputs its path gave it
    main_in = record_kernel_inputs(lambda: infer(images))
    dense_in = record_kernel_inputs(decode_dense)
    fused_in = record_kernel_inputs(lambda: fused(hms, [tags]))
    paths = {"main": launches, "dense_scene": launches_dense, "fused": launches_fused,
             "fused_scene": launches_fused_scene, "per_image": launches_per_image,
             "w32_blocks": launches_blocks,
             **{f"infer_{key}": rec["launches"] for key, rec in infer_rec["configs"].items()},
             **{f"eval_bs{bs}": c for bs, c in eval_rec["launches"].items()},
             "train_data_val": train_data_rec["launches"]}

    def row(key, path, parity, k_ms, p_ms, bound_ms_by, library_ms, **extra):
        return {"name": key, "route": "cuda", "source": SOURCES[key], "replaces": REPLACES[key][0],
                "launches": paths[path][key], "path": path,
                "launches_by_path": {p: c[key] for p, c in paths.items()},
                "parity": parity, "max_abs_err": errs[key], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1], "library_ms": library_ms,
                **extra}

    kernels = []
    hm, tg, prev, counts = main_in["refine_argmax"]
    kernels.append(row(
        "refine_argmax", "main", "exact idx on p < counts",
        cuda_ms(lambda: cuda_decode.refine_argmax_batch(hm, tg, prev, counts), iters=20),
        cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(hm, tg, prev, counts), iters=2),
        refine_bound(hm, tg, prev, counts), None,
        ms_dense_scene=cuda_ms(lambda: cuda_decode.refine_argmax_batch(*dense_in["refine_argmax"]), iters=20),
        shape=f"B{BATCH} K{K} HW{SIZE * SIZE} E{tg.shape[2]} P{M}", active_persons=int(counts.sum()),
        splits=cuda_decode.refine_splits(BATCH * K, SIZE * SIZE,
                                         torch.cuda.get_device_properties(dev).multi_processor_count),
        sass=refine_sass,
        ms_infer_e2={key: r["refine_ms"] for key, r in infer_rec["e2_kernels"].items()},
        infer_e2={key: {k_: v for k_, v in r.items() if k_.startswith("refine")}
                  for key, r in infer_rec["e2_kernels"].items()},
        eval_bs8={k_: v for k_, v in eval_rec["kernels"].items() if k_.startswith("refine")}))
    cand, _, _, order, persons = main_in["match_by_tag"]
    kernels.append(row(
        "match_by_tag", "main", "exact joints and count",
        cuda_ms(lambda: cuda_match.match_by_tag_batched(cand, DET_THR, TAG_THR, order, persons), iters=20),
        host_ms(lambda: (cuda_match.match_by_tag_batched_plain(cand, DET_THR, TAG_THR, order, persons),
                         torch.cuda.synchronize())),
        match_bound(cand, persons), None,
        ms_dense_scene=cuda_ms(lambda: cuda_match.match_by_tag_batched(*dense_in["match_by_tag"]), iters=20),
        ms_fused=cuda_ms(lambda: cuda_match.match_by_tag_batched(*fused_in["match_by_tag"]), iters=20),
        shape=f"B{BATCH} K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
        valid_rows=int((cand[..., 2] > DET_THR).sum()),
        ms_infer_e2={key: r["match_ms"] for key, r in infer_rec["e2_kernels"].items()},
        infer_e2={key: {k_: v for k_, v in r.items() if k_.startswith("match")}
                  for key, r in infer_rec["e2_kernels"].items()},
        eval_bs8={k_: v for k_, v in eval_rec["kernels"].items() if k_.startswith("match")}))
    kernels.append(row(
        "match_by_tag_per_image", "per_image", "exact joints and count; equal to match_by_tag",
        cuda_ms(lambda: cuda_match.match_by_tag_per_image(cand_s, DET_THR, TAG_THR, order_s, persons_s),
                iters=20),
        per_image_plain_ms, match_bound(cand_s, persons_s), None,
        shape=f"B{BATCH} K{K} M{cand_s.shape[2]} E{cand_s.shape[3] - 3} P{persons_s}",
        valid_rows=int((cand_s[..., 2] > DET_THR).sum())))
    q_in, h2_in = fused_in["fused_aggregate"]
    avg_out = torch.empty((BATCH, K, 4, 4, *q_in.shape[2:]), device=dev)  # the write floor's two outputs
    sup_out = torch.empty_like(avg_out)
    agg_rows, agg_threads = cuda_aggregate.aggregate_launch(
        BATCH * K, q_in.shape[2], q_in.shape[3], torch.cuda.get_device_properties(dev).multi_processor_count)
    kernels.append(row(
        "fused_aggregate", "fused", "avg, sup and cmax equal (edge cases too)",
        cuda_ms(lambda: cuda_aggregate.fused_aggregate(q_in, h2_in), iters=20),
        cuda_ms(lambda: cuda_aggregate.fused_aggregate_plain(q_in, h2_in), iters=3),
        aggregate_bound(q_in, h2_in), None,
        ms_fused_scene=cuda_ms(lambda: cuda_aggregate.fused_aggregate(q_s, h2_s), iters=20),
        write_floor_ms=cuda_ms(lambda: (avg_out.fill_(0.0), sup_out.fill_(0.0)), iters=20),
        rows=agg_rows, threads=agg_threads,
        shape=f"B{BATCH} K{K} H4 {q_in.shape[2]} W4 {q_in.shape[3]}"))
    avg_in, tl_in, prev_in = fused_in["refine_argmax_phase"]
    kernels.append(row(
        "refine_argmax_phase", "fused", "exact idx and val (E=1, E=2 on the stage scene; edge cases)",
        cuda_ms(lambda: cuda_aggregate.refine_argmax_phase_batch(avg_in, tl_in, prev_in), iters=20),
        cuda_ms(lambda: cuda_aggregate.refine_argmax_phase_batch_plain(avg_in, tl_in, prev_in), iters=2),
        refine_phase_bound(avg_in, tl_in, prev_in), None,
        ms_fused_scene=cuda_ms(lambda: cuda_aggregate.refine_argmax_phase_batch(
            *scene_in["refine_argmax_phase"]), iters=20),
        shape=f"B{BATCH} K{K} H4 {avg_in.shape[4]} W4 {avg_in.shape[5]} E{tl_in.shape[2]} "
              f"P{prev_in.shape[1]}",
        splits=cuda_aggregate.phase_refine_splits(
            BATCH * K, avg_in.shape[4], avg_in.shape[5], tl_in.shape[2],
            torch.cuda.get_device_properties(dev).multi_processor_count),
        sass=phase_sass))
    per_shape = block_times(block_rows, smi)
    head_row = next(r for r in per_shape if r["dtype"] == "bfloat16")  # C=32 at 128^2, bf16
    errs["fused_basic_block"] = head_row["max_abs_err"]
    kernels.append(row(
        "fused_basic_block", "w32_blocks",
        "bfloat16 (bf16 weights) within 2**-6 of the output scale, float32 within 1e-4",
        head_row["ms"], head_row["plain_ms"], (head_row["bound_ms"], head_row["bound_by"]),
        head_row["library_ms"], library="cuDNN conv pair with bias, add and ReLU: two conv calls",
        shape=f"B{BATCH} 128x128 C32 bfloat16 (row; ms on weights packed once, "
              f"{head_row['ms_with_packing']:.4f} with packing); every W32 branch shape and dtype "
              "in per_shape",
        per_shape=per_shape, fold_max_abs_err=fold_err, w32_bf16_rel_err=bf16_rel,
        hgmma_instructions=hgmma,
        float32={f"C{r['c']} {r['hw']}^2": {key: r[key] for key in (
            "ms", "ms_with_packing", "bound_ms", "bound_by", "floor_ms", "library_ms", "grid", "tile")}
                 for r in per_shape if r["dtype"] == "float32"}))
    print("kernels: " + "; ".join(
        f"{r['name']} replaces={r['replaces']} {REPLACES[r['name']][1]} launches={r['launches']} "
        f"({r['path']} path; {r['launches_by_path']}) parity={r['parity']} "
        f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) plain_ms={r['plain_ms']:.2f} "
        f"library_ms={r['library_ms']}"
        for r in kernels), flush=True)
    print(json.dumps({"e2e": {"batch": BATCH, "size": SIZE, "forward_ms": fwd_ms,
                              "decode_ms": dec_ms, "decode_dense_ms": dense_ms,
                              "decode_fused_ms": fused_ms, "stage_scene_decode_ms": scene_ms,
                              "forward_decode_wall_ms": wall_ms,
                              "img_per_s": BATCH / wall_ms * 1e3, "device_busy_ms": busy_ms,
                              "device_busy_groups_ms": busy_groups,
                              "fused_decode_busy_groups_ms": fused_groups,
                              "dense_decode_busy_ms": dense_busy_ms,
                              "dense_decode_busy_groups_ms": dense_groups,
                              "fused_vs_dense": {"person_slots_differ": persons_differ,
                                                 "joints_differ": joints_differ},
                              "card": smi}}), flush=True)
    print(json.dumps({"inference": infer_rec}), flush=True)
    print(json.dumps({"eval": eval_rec}), flush=True)
    print(json.dumps({"train": train_rec}), flush=True)
    print(json.dumps({"train_data": train_data_rec}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
