"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --refine-only        # the dense refine alone, see the end
    python3 chip_smoke.py --phase-refine-only  # the phase refine alone, see the end
    python3 chip_smoke.py --aggregate-only     # the fused aggregate alone, see the end

Drives the port's main path — HigherHRNet-W32 at 512x512, batch 24, bf16
forward with float32 outputs, then the associative-embedding decode at the
published eval point (det_thr 0.05, tag_thr 0.5, 30 people) — and the fused
decode front end (``decode_batch_fused``) on seeded random weights and
seeded synthetic scenes. Phases, any failure exits non-zero:

1. device: card name and power limit, TF32 switches
2. build: all five CUDA libraries from ``human_pose_tpu_torch/csrc`` (one
   nvcc per source, in parallel), with ptxas registers and spills of every
   kernel, the count of HGMMA (tensor-core) instructions in the fused
   BasicBlock's library and of FRND (round-to-integer, conversion unit)
   instructions in each kernel of the dense and the phase refine's
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
6. timing: forward, decode and img/s (CUDA events and host wall clock), a
   per-kernel profiler breakdown of one forward+decode with the device's
   idle share and of one fused and one dense decode alone, fused vs dense
   decode, each kernel vs its plain version, its bound and, where one
   exists, a library call

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

# H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
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


def count_sass(build, name: str, opcode: str) -> int | None:
    """Instructions of ``opcode`` in the SASS of library ``name`` (None when
    the toolkit has no cuobjdump)."""
    sass = dump_sass(build, name)
    return None if sass is None else sum(opcode in line for line in sass.splitlines())


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


def main() -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--refine-only", action="store_true",
                        help="build, check and time the dense refine kernel alone")
    parser.add_argument("--phase-refine-only", action="store_true",
                        help="build, check and time the phase refine kernel alone")
    parser.add_argument("--aggregate-only", action="store_true",
                        help="build, check and time the fused aggregate kernel alone")
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

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f}s wall, per kernel {secs}")
    log_build(_build)
    hgmma = count_sass(_build, "fused_basic_block", "HGMMA")
    log(f"fused_basic_block: {hgmma} HGMMA instructions in its SASS (cuobjdump --dump-sass)")
    if hgmma == 0:
        raise AssertionError("fused_basic_block: no HGMMA in the built library: the tensor cores are unused")
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

    # every wrapper's launch counter
    counters = {
        "match_by_tag": cuda_match.match_by_tag_batched,
        "refine_argmax": cuda_decode.refine_argmax_batch,
        "match_by_tag_per_image": cuda_match.match_by_tag_per_image,
        "fused_aggregate": cuda_aggregate.fused_aggregate,
        "refine_argmax_phase": cuda_aggregate.refine_argmax_phase_batch,
        "fused_basic_block": cuda_conv.fused_basic_block,
    }

    def counted(fn, what, want):
        """Run ``fn`` with every launch counter zeroed just before; require
        exactly the launches of ``want`` (and none of any other kernel).
        Returns (fn's result, counts)."""
        for wrapper in counters.values():
            wrapper.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {key: wrapper.launches for key, wrapper in counters.items()}
        log(f"{what} launches: {counts}")
        if counts != {key: want.get(key, 0) for key in counters}:
            raise AssertionError(f"{what}: launches {counts}, want {want} and no others")
        return out, counts

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
    fold_err, bf16_rel = 0.0, 0.0
    with torch.no_grad():
        for i, (blk, x, f) in enumerate(zip(blocks, block_x, folded)):
            want = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            fold_err = max(fold_err, float((outs[2 * i] - want).abs().max()))
            want_bf16 = cuda_conv.fused_basic_block_plain(x.to(torch.bfloat16), *f).float()
            bf16_rel = max(bf16_rel, float((outs[2 * i + 1].float() - want_bf16).abs().max()
                                           / want_bf16.abs().max()))
    if fold_err > 1e-4 or bf16_rel > 2 ** -6:
        raise AssertionError(f"folded W32 BasicBlocks: float32 vs eval forward {fold_err}, "
                             f"bfloat16 vs plain {bf16_rel} of the output scale")
    log(f"folded W32 BasicBlocks ({len(blocks)}, C=32..256): float32 == eval forward within "
        f"{fold_err:.3g}; bfloat16 == plain within {bf16_rel:.3g} of the output scale")

    # 6. timing
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

    # each kernel on the exact inputs its path gave it
    main_in = record_kernel_inputs(lambda: infer(images))
    dense_in = record_kernel_inputs(decode_dense)
    fused_in = record_kernel_inputs(lambda: fused(hms, [tags]))
    paths = {"main": launches, "dense_scene": launches_dense, "fused": launches_fused,
             "fused_scene": launches_fused_scene, "per_image": launches_per_image,
             "w32_blocks": launches_blocks}

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
        sass=refine_sass))
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
        valid_rows=int((cand[..., 2] > DET_THR).sum())))
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
    per_shape = []
    for r in block_rows:
        x, w1, b1, w2, b2 = r["inputs"]
        lib_w = [t.to(x.dtype) for t in (w1.permute(3, 2, 0, 1), b1, w2.permute(3, 2, 0, 1), b2)]
        lib_w[0] = lib_w[0].contiguous(memory_format=torch.channels_last)
        lib_w[2] = lib_w[2].contiguous(memory_format=torch.channels_last)
        x_cl = x.permute(0, 3, 1, 2)  # the NHWC tensor as a channels_last NCHW view

        def library(x_cl=x_cl, lib_w=lib_w):  # cuDNN: two conv calls with bias, add, ReLU
            y = torch.relu(F.conv2d(x_cl, lib_w[0], lib_w[1], padding=1))
            return torch.relu(F.conv2d(y, lib_w[2], lib_w[3], padding=1) + x_cl)

        b_ms, b_by = conv_bound(x)
        call_ms = cuda_ms(lambda: cuda_conv.fused_basic_block(*r["inputs"]), iters=10)
        if x.dtype == torch.bfloat16:  # the kernel alone, on weights packed once
            packed = cuda_conv.pack_block_weights(w1, b1, w2, b2)
            k_ms = cuda_ms(lambda: cuda_conv.fused_basic_block_packed(x, *packed), iters=10)
        else:
            k_ms = call_ms
        per_shape.append({
            "c": r["c"], "hw": r["hw"], "dtype": r["dtype"], "max_abs_err": r["max_abs_err"],
            "tol": r["tol"], "ms": k_ms, "ms_with_packing": call_ms,
            "plain_ms": cuda_ms(lambda: cuda_conv.fused_basic_block_plain(*r["inputs"]), iters=5),
            "library_ms": cuda_ms(library, iters=10), "bound_ms": b_ms, "bound_by": b_by})
        log(f"fused block C={r['c']} {r['hw']}^2 {r['dtype']}: {k_ms:.3f} ms (with weight packing "
            f"{call_ms:.3f}), plain {per_shape[-1]['plain_ms']:.3f}, cuDNN pair "
            f"{per_shape[-1]['library_ms']:.3f}, bound {b_ms:.4f} ({b_by})  [{smi}]")
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
        float32={f"C{r['c']} {r['hw']}^2": {key: r[key] for key in ("ms", "bound_ms", "bound_by", "library_ms")}
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
