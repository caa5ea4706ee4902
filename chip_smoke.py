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
    python3 chip_smoke.py --train-engine-only  # the training engine alone, see the end
    python3 chip_smoke.py --classification-only  # ImageNet classification alone, see the end
    python3 chip_smoke.py --serve-only         # serving and export alone, see the end
    python3 chip_smoke.py --zoo-only           # the model zoo alone, see the end
    python3 chip_smoke.py --dp-train-only      # zoo and data-parallel training alone, see the end
    python3 chip_smoke.py --sharded-eval-only  # distributed eval and the utilities alone, see the end
    python3 chip_smoke.py --model-parallel-only  # the pipeline and the mesh step alone, see the end
    python3 chip_smoke.py --bench-only         # the benchmark CLIs alone, see the end
    python3 chip_smoke.py --bn-backward-only   # the BatchNorm backward pair alone, see the end

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
   ``create_datamodule`` and ``create_module``, bfloat16 (float32 too
   with ``--train-data-only``), trained from loader batches through ``DevicePrefetcher`` (pinned
   staging, a side stream) across epoch boundaries beside phase 9's batch
   made on the card: ms a step, img/s, waits, peak memory, busy and idle
   share; ``validation_step`` and ``make_results`` with one launch each of
   the dense refine and the grouping; the reduced net's step on one loader
   batch card vs CPU
11. the training engine (``train_engine_phase``): W32 from the yaml (batch
   36, 512^2, bfloat16, Adam) through ``bin.train_keypoints.main`` on phase
   10's synthesized directories for two epochs: FINISHED, best.pt and
   last.pt, the epoch metrics' files, the model summary (28,645,331), the
   device log and the tracker's files; one launch of the dense refine and
   of the grouping an evaluate (counters zeroed before the run); the resume
   from last.pt runs one epoch and continues the step count; last.pt loads
   strictly into ``InferenceKeypointsModel`` and decodes a val image; ms a
   step through the ``Trainer`` beside phase 10's steady step, the step
   after a checkpoint submit, each save's seconds and size; the reduced
   net's engine run card vs CPU
12. ImageNet classification (``classification_phase``): one float32 SGD
   step (the yaml's: nesterov, weight decay; TF32 and cuDNN off) of a
   reduced ClassificationHRNet (C=8, 1000 classes, batch 8 and batch 4 at
   64^2) on the card and on the CPU from the same weights, each held
   against a float64 evaluation with its own ReLU decisions, and the card
   against the CPU where they decide alike; ClassificationHRNet-W32
   (41,232,680 parameters) from ``experiments/classification/hrnet_32.yaml``
   at its published point (batch 80, 224^2, SGD lr 0.1) through
   ``create_module`` on a batch made on the card, float32 and bfloat16: ms
   a step, img/s, peak memory, busy and idle share, every loss finite; the accumulated step at 2
   microbatches; a synthesized ImageFolder (4 classes, 160 train and 32 val
   seeded jpgs in ImageNet's commonest raw sizes): the loader's samples a
   second and host ms a sample, ``bin.train_classification.main`` for two
   epochs to FINISHED, its last.pt through ``bin.eval_classification.main``
   serial and batched (equal errors) and ``bin.inference_classification.main
   --mode=val`` (its overlays), eval img/s serial and batched and the
   inference model's ms an image at input 256 in float32 and bfloat16, its
   float32 probabilities card vs CPU, and the last.pt as HigherHRNet-W32's
   pretrained weights (every backbone parameter loaded); no kernel launched
13. serving and export (``serve_phase``): W32 from the keypoints yaml with
   seeded weights behind ``BatchedKeypointsPredictor`` in float32 and
   bfloat16 for a 480x640 raw image (every batch bucket up to 16 warmed
   up): a predict of 1, 3, 5 and 16 requests with one launch of the dense
   refine and of the grouping each, its payloads against each request's
   alone (float32: the same persons, median coordinates within 0.05 and
   person scores within 5e-3; bfloat16: the same persons), the pad rows
   changing no payload (bit for bit), one float32 predict and its forward
   repeated three times under cuDNN's deterministic algorithms (bit for
   bit), the yaml's cuDNN settings and PyTorch's defaults (recorded);
   ``DynamicBatcher`` under bench_serve's closed-loop load (16 clients x 8
   requests at 512, bfloat16, max batch 16, max wait 5 ms), plain and
   compact: p50/p95/p99 ms, requests a
   second, mean batch size, launches a device batch, busy and idle share;
   ``make_server`` on a free local port (a JPEG and an ``.npy`` POST,
   /healthz's "gpu", /stats, /metrics, a 413, a clean close) for keypoints
   and for ClassificationHRNet-W32, whose batched top-5 equals
   ``__call__``'s; ``bin.bench_serve`` and ``bin.serve`` (one POST, exit 0
   on SIGTERM) as processes; ``bin.export`` in the yaml's bfloat16, the
   ``.pt2`` on the card against the module and the ``.weights.npz`` into a
   new W32 bit for bit; the two W32s' parameter counts and ``model_cost``
14. the model zoo (``zoo_phase``): the AE hourglass, the stacked hourglass
   (16 joints), SimpleBaseline-R50 and HRNetSPPE-W32 at full width, seeded:
   parameter counts, each float32 forward card vs CPU (rel 1e-3);
   ``sppe_parse`` card == CPU on the SPPE nets' outputs and on ties;
   ``InferenceKeypointsModel`` on the AE hourglass at 512 with flip for a
   480x640 raw image with one launch of the dense refine and of the
   grouping, each equal to its plain version on that call's inputs, their
   times and bounds, ms an image float32 and bfloat16; ``InferenceSPPEModel``
   from the config for SimpleBaseline-R50 and HRNetSPPE-W32: no kernel
   launched, joints card == CPU parse, ms an image float32 and bfloat16; a
   torchvision-layout resnet50 state dict into SimpleBaseline's backbone on
   the card, strictly
15. zoo and data-parallel training (``dp_train_phase``): one float32 Adam
   step of the one-stage full-width AE hourglass (batch 2 at 128^2) on the
   card and on the CPU, each held against float64 on its own ReLU
   decisions; the AE hourglass (17 joints, 2 stages, 6,795,396 parameters)
   from the keypoints yaml with ``architecture: Hourglass`` and every target
   at 1/4, at the yaml's point (Adam 1e-3, batch 36 or the largest that
   fits, 512^2, 30 persons) in float32 and bfloat16: ms a step, img/s, peak
   memory, busy and idle share, no kernel launched; its bfloat16 step at
   batch 16 through an NCCL group of one in this process against the plain
   step (what the data-parallel step adds); a synthesized COCO (16
   train, 8 val images) through ``bin.train_keypoints.main`` with that
   architecture: FINISHED, one launch of the dense refine and of the
   grouping in the validation's ``make_results``, each equal to its plain
   version on those inputs, their times and bounds; the same CLI side by
   side in two processes, one with torchrun's environment for one rank (an
   NCCL group of one, the data-parallel mesh and its collectives) and one
   without: metrics, weights and Adam state of last.pt bit for bit equal
   (cuDNN deterministic), the NCCL version and the group's backend
16. distributed eval and the last utilities (``sharded_eval_phase``): on
   phase 8's corpus with cuDNN deterministic, ``bin.eval_keypoints
   --sharded=true --batch_size=8`` under ``torch.distributed.run
   --nproc_per_node=1`` (NCCL) and, in this process, the CLI without and
   with ``--sharded=true`` under torchrun's environment: one launch of the
   dense refine and of the grouping a batch in both, the three results
   files with the same detections bit for bit, each kernel on the sharded
   path's last batch equal to its plain version, img/s at batch 8 without
   a mesh and through an NCCL group of one (float32, bfloat16, in turns);
   W32's Adam state through the file and the directory checkpoint backends
   (save, async submit and write, restore: ms, MB, bit for bit); the
   card-memory monitor against ``mem_get_info``; the native RLE decode
   against NumPy
17. model parallelism (``parallel_phase``): the main path's W32 model
   through ``PipelinedModel`` (``DEFAULT_PARTITION``, all four segments on
   ``cuda:0``) against its monolithic forward at batch 8, 512^2, float32
   (within 1e-4 of the outputs' scale) and bfloat16: ms a batch, img/s, each segment's ms;
   ``InferenceKeypointsModel(pipeline_devices=1)`` with flip against
   ``pipeline_devices=0`` (cuDNN deterministic): decisions equal, one
   launch of the dense refine and of the grouping, each equal to its plain
   version on that call's inputs; one float32 W32 step at batch 8 on the
   (1, 1) and (1, 1, 1) meshes of an NCCL group of one equal to the plain
   step bit for bit, and the ms each path adds (a tensor axis of 1 shards
   nothing); the two tensor operators on that group, forward and backward,
   the identity on a W32 activation
18. the benchmark CLIs (``bench_phase``): ``bin.bench_decompose`` at its
   defaults (W32, batch 8 at 512^2, 10 iterations a pass) with the counters
   zeroed: its four records (forward, decode on GT-like sparse maps, decode
   on uniform-noise maps, end to end; host wall and the stream's time
   between CUDA events), one launch of the dense refine and of the
   grouping a ``decode_batch`` call; each stage's card busy time under the
   profiler beside its host wall; its sparse and noise maps alone: one
   launch each a call, the refine equal to its plain version on the batch
   and the grouping on the batch of sparse maps and the first noise image,
   no more persons than the cap, the kernels' times and bounds on the
   batch, valid candidate rows and persons an image; ``bin.bench_train`` for keypoints (W32 bs36
   512^2 bfloat16 Adam, 5 + 5 steps) and classification (W32 bs80 224^2
   SGD, 10 + 10): img/s, ms a step, finite losses, peak memory, beside
   phases 9 and 12's bfloat16 steps; no kernel launched in training

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
``--train-only`` for phase 9 (which builds no decode kernel) and
``--train-data-only`` for phase 10 (which builds the dense refine and the
grouping for its validation), ``--train-engine-only`` for phase 11 (the
same two kernels; without phase 10 in the process it measures phase 10's
steady step itself), ``--classification-only`` for phase 12 (which
builds no decode kernel), ``--serve-only`` for phase 13, ``--zoo-only`` for
phase 14, ``--dp-train-only`` for phase 15 and ``--sharded-eval-only`` for
phase 16 (each the dense refine and the grouping); ``--model-parallel-only``
and ``--bench-only`` run phases 17 and 18 alike.

Every path counts the launches of every kernel of the port
(``kernel_counters``), the BatchNorm backward pair of ``ops/cuda_norm.py``
too: the bfloat16 training steps of phases 9-18 launch it, 2 a BatchNorm
layer a step. Phase 9 runs one more W32 bfloat16 step with the counters
zeroed just before, requires those 2 launches for each train-mode
BatchNorm forward, and keeps the BatchNorm inputs the step gave the pair:
the kernels' summary row of the pair holds it against its plain version on
those inputs and times the pair, the plain version and the library route it
replaced (device ms: CUDA events behind a sleep kernel that outlasts the
host's launches), beside the bound, summed over the step's layers.
``--bn-backward-only`` is the short loop for that pair: it builds it, runs
the W32 bs36 bfloat16 Adam step counted the same way, and on the BatchNorm
inputs of that step (and fp16 at its two largest shapes) checks and times
the pair as the full run does; then ms a step with the pair and with the
library route in turns, and each route's BatchNorm backward device ms a
step (profiler). Its last line is one JSON object of those records.
"""

from __future__ import annotations

import contextlib
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

# images of the main path's batch on which row 2's plain_ms is timed
MATCH_PLAIN_IMAGES = 4

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
    "batch_norm_backward": ("none", "(the JAX package leaves BatchNorm to flax and XLA; the pair "
                                    "replaces PyTorch's native_batch_norm_backward and four "
                                    "float32 sums)"),
}
SOURCES = {
    "match_by_tag": "human_pose_tpu_torch/csrc/match_by_tag.cu",
    "refine_argmax": "human_pose_tpu_torch/csrc/refine_argmax.cu",
    "match_by_tag_per_image": "human_pose_tpu_torch/csrc/match_by_tag.cu",
    "fused_aggregate": "human_pose_tpu_torch/csrc/fused_aggregate.cu",
    "refine_argmax_phase": "human_pose_tpu_torch/csrc/refine_argmax_phase.cu",
    "fused_basic_block": "human_pose_tpu_torch/csrc/fused_basic_block.cu",
    "batch_norm_backward": "human_pose_tpu_torch/csrc/batch_norm_backward.cu",
}


# the inference model's configurations (phase 6): a 480x640 raw image at
# input size 512, W32 at the published eval point; (d) compact uint8 inputs
# bucketed to multiples of 128
INFER_RAW_HW = (480, 640)
INFER_WARMUP_S = 1.5  # a configuration's warm-up in each dtype before its timing
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


# kernels whose launches a path records without fixing them where ``want``
# does not name them: the BatchNorm backward pair, 2 a layer in each
# training step, and a training path's steps are its own
RECORDED = ("batch_norm_backward",)


def make_counted(counters: dict):
    """``counted(fn, what, want)``: run ``fn`` with every launch counter of
    ``counters`` zeroed just before; require exactly the launches of
    ``want`` (and none of any other kernel), save that a ``RECORDED``
    kernel that ``want`` does not name is only required even (whole
    calls); ``want`` may be a function of fn's result. Returns (fn's
    result, counts)."""
    import torch

    def counted(fn, what, want):
        for wrapper in counters.values():
            wrapper.launches = 0
        out = fn()
        torch.cuda.synchronize()
        want = want(out) if callable(want) else want
        counts = {key: wrapper.launches for key, wrapper in counters.items()}
        log(f"{what} launches: {counts}")
        fixed = {key: want.get(key, 0) for key in counters if key in want or key not in RECORDED}
        if ({key: counts[key] for key in fixed} != fixed
                or any(counts[key] % 2 for key in RECORDED if key in counts)):
            raise AssertionError(f"{what}: launches {counts}, want {want} and no others")
        return out, counts
    return counted


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name; each counts its
    launches in ``.launches``."""
    from human_pose_tpu_torch.ops import (
        cuda_aggregate, cuda_conv, cuda_decode, cuda_match, cuda_norm,
    )

    return {
        "match_by_tag": cuda_match.match_by_tag_batched,
        "refine_argmax": cuda_decode.refine_argmax_batch,
        "match_by_tag_per_image": cuda_match.match_by_tag_per_image,
        "fused_aggregate": cuda_aggregate.fused_aggregate,
        "refine_argmax_phase": cuda_aggregate.refine_argmax_phase_batch,
        "fused_basic_block": cuda_conv.fused_basic_block,
        "batch_norm_backward": cuda_norm.batch_norm_backward,
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
            warm_up(lambda: (fn(), torch.cuda.synchronize()), INFER_WARMUP_S)
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
        out["kernels"] = path_kernel_times(lambda: run(im, 8))
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
                    lambda: evaluate_dataset_batched(model, ds, bs, progress=False)) * 1e3
            wall = host_ms(lambda: run(model, 8))
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


def path_kernel_times(fn) -> dict:
    """The dense refine's and the grouping's shapes, times (CUDA events)
    and bounds on the inputs of their last launch in ``fn()``."""
    return kernel_times(record_kernel_inputs(fn))


def kernel_times(seen: dict) -> dict:
    """``path_kernel_times`` on inputs already kept by ``record_kernel_inputs``."""
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    hm, tg, prev, cnt = seen["refine_argmax"]
    cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
    return {
        "refine_shape": f"B{hm.shape[0]} K{K} HW{hm.shape[2]} E{tg.shape[2]} P{prev.shape[1]}",
        "refine_active_persons": int(cnt.sum()),
        "refine_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch(hm, tg, prev, cnt), iters=20),
        "refine_bound_ms": refine_bound(hm, tg, prev, cnt)[0],
        "match_shape": f"B{cand.shape[0]} K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
        "match_ms": cuda_ms(lambda: cuda_match.match_by_tag_batched(
            cand, det_thr, tag_thr, order, persons), iters=20),
        "match_bound_ms": match_bound(cand, persons)[0]}


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


def train_batch(n: int, size: int, persons: int, gen, device, strides: tuple = (4, 2)) -> dict:
    """A seeded keypoints batch made on ``device`` (``gen`` is a generator
    there): uint8 images, a heatmap and a mask of ones at each of
    ``strides`` (HigherHRNet's 1/4 and 1/2; the AE hourglass's (4, 4)),
    joints of ``persons`` x K on the 1/4 grid, about half visible (as
    tests/test_train_steps.py's ``make_kpts_batch``)."""
    import torch

    kw = {"generator": gen, "device": device}
    h4 = size // 4
    joints = torch.stack([torch.randint(0, h4, (n, persons, K), **kw),
                          torch.randint(0, h4, (n, persons, K), **kw),
                          (torch.rand((n, persons, K), **kw) > 0.5).long()], -1).to(torch.int32)
    return {"images": torch.randint(0, 256, (n, 3, size, size), dtype=torch.uint8, **kw),
            "heatmaps": [torch.rand((n, K, size // s, size // s), **kw) for s in strides],
            "masks": [torch.ones((n, size // s, size // s), device=device) for s in strides],
            "joints": joints}


def relu_decisions(replay: list | None = None):
    """A torch function mode over every ReLU that runs inside it
    (``torch.relu``, ``torch.relu_``, ``F.relu``, ``nn.ReLU``), in call
    order: each ReLU's input is kept (``.inputs``, float64 on the CPU).
    With ``replay``, an earlier evaluation's ``.inputs``, each ReLU instead
    returns its input times that evaluation's decision (input > 0), in
    place where the ReLU is: a forward that takes another evaluation's ReLU
    decisions."""
    import torch
    from torch.nn import functional as F
    from torch.overrides import TorchFunctionMode

    inplace_relus = {torch.relu_, torch.Tensor.relu_}
    relus = {torch.relu, F.relu, torch.Tensor.relu} | inplace_relus

    class ReluDecisions(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.inputs = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in relus:
                return func(*args, **kwargs)
            x = args[0]
            if replay is None:
                self.inputs.append(x.detach().cpu().double())
                return func(*args, **kwargs)
            keep = (replay[len(self.inputs)] > 0).to(x.device, x.dtype)
            self.inputs.append(x.detach().cpu().double())
            inplace = func in inplace_relus or kwargs.get("inplace") or args[1:2] == (True,)
            return x.mul_(keep) if inplace else x * keep

    return ReluDecisions()


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| (float64 tensors)."""
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def step_card_vs_cpu(dev, model, step, ref_loss, cudnn: bool = True,
                     decisions: bool = False) -> dict:
    """One training step of a copy of ``model`` on the CPU and of another on
    ``dev``: ``step(net, where)`` makes the copy's state, steps and returns
    the step's metrics (TF32 is the caller's; cuDNN is ``cudnn`` for both
    steps). The reference is the gradient of ``ref_loss(net)`` on a float64
    copy of ``model`` on the CPU (BatchNorm moments in float64 too). With
    ``decisions`` each step keeps its ReLU inputs (``relu_decisions``), and
    where a device's ReLU decisions differ from float64's the reference is
    evaluated again with that device's decisions.

    Returns ``metrics`` and ``after`` (the state dicts after the step) as
    (CPU, card), ``start`` (the state dict before), ``grads``: {"cpu",
    "card", "ref", and with ``decisions`` "ref_cpu", "ref_card"} of name ->
    float64 CPU tensor (the parameters that have a gradient); the BatchNorm running statistics' largest card-CPU
    gap of each tensor's largest value and how many moved; with
    ``decisions`` ``relu``: for each device the decisions that differ from
    float64's (count, and the largest |float64 input| among them over that
    ReLU input's largest |value|) and the decisions in which card and CPU
    differ."""
    import torch

    cpu = torch.device("cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step(where):
        net = copy.deepcopy(model).to(where)
        mode = relu_decisions() if decisions else contextlib.nullcontext()
        enabled = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        try:
            with mode:
                metrics = step(net, where)
        finally:
            torch.backends.cudnn.enabled = enabled
        return net, {k: float(v) for k, v in metrics.items()}, getattr(mode, "inputs", None)

    def reference(replay=None):
        net = copy.deepcopy(model).double().train()
        mode = relu_decisions(replay) if decisions else contextlib.nullcontext()
        with mode:
            loss = ref_loss(net)
        loss.backward()
        return ({name: p.grad for name, p in net.named_parameters() if p.grad is not None},
                getattr(mode, "inputs", None))

    (net_c, m_c, in_c), (net_g, m_g, in_g) = one_step(cpu), one_step(dev)
    ref, in_ref = reference()
    # a parameter whose output the loss never reads (the AE hourglass's
    # last remap convs) has no gradient on any device
    grads = {"cpu": {n: p.grad.double() for n, p in net_c.named_parameters() if n in ref},
             "card": {n: p.grad.cpu().double() for n, p in net_g.named_parameters() if n in ref},
             "ref": ref}
    sd_c = net_c.state_dict()
    sd_g = {k: v.cpu() for k, v in net_g.state_dict().items()}
    stats = {k: float((sd_g[k] - sd_c[k]).abs().max() / sd_c[k].abs().max().clamp(min=1e-30))
             for k in sd_c if ".running_" in k}
    moved = sum(not torch.equal(sd_c[k], start[k]) for k in stats)
    out = {"metrics": (m_c, m_g), "start": start, "after": (sd_c, sd_g), "grads": grads,
           "bn_stats_rel_max": max(stats.values()), "bn_stats_moved": f"{moved} of {len(stats)}",
           "bn_stats_all_moved": moved == len(stats)}
    if not decisions:
        return out

    def differ(inputs, base):
        if len(inputs) != len(base):
            raise AssertionError(f"{len(inputs)} ReLUs against {len(base)}")
        return [(x > 0) != (b > 0) for x, b in zip(inputs, base)]

    relu = {"calls": len(in_ref)}
    for who, inputs in (("cpu", in_c), ("card", in_g)):
        flips = differ(inputs, in_ref)
        n = sum(int(f.sum()) for f in flips)
        worst = max((float(b[f].abs().max() / b.abs().max()) for f, b in zip(flips, in_ref)
                     if bool(f.any())), default=0.0)
        relu[who] = {"differ_from_float64": n, "differ_input_rel_max": worst}
        grads[f"ref_{who}"] = reference(inputs)[0] if n else ref
    relu["card_vs_cpu_differ"] = sum(int(f.sum()) for f in differ(in_g, in_c))
    out["relu"] = relu
    return out


def train_step_card_vs_cpu(dev, lr: float = 1e-3, batch: dict | None = None,
                           what: str = "a seeded batch", cudnn: bool = True,
                           check_grads: bool = True) -> dict:
    """One float32 Adam step (TF32 off) of the reduced net (``TRAIN_REDUCED``,
    batch 4 at 128^2) on the card and on the CPU, from the same
    ``init_keypoints_weights_`` weights and the same batch (``batch``, NCHW
    CPU tensors, or a seeded one made on the CPU), by ``step_card_vs_cpu``.
    cuDNN's backward sums in its own order, so the checks are tolerances:
    each loss term within rel 1e-4; each parameter's gradient within
    ||card - ref|| / ||ref|| <= 1e-3 of ``ref``, the same gradients
    evaluated in float64 on the CPU. The CPU's own float32 gradients are
    not the reference: on phase 9's seeded batch they miss float64 by
    1.9e-4 where the card's stay within 1.1e-5 (an H100), and on phase 10's
    loader batch cuDNN's miss it by 2.3e-3 of the whole gradient where the
    CPU's stay within 4.7e-6; both gaps are returned. ``cudnn`` False runs
    the steps with cuDNN off (PyTorch's own convolutions); ``check_grads``
    False reports the gradients' gap without holding it. Each BatchNorm
    running statistic within 1e-3 of its tensor's largest value; the
    parameters after the step within 2e-5 + 1e-6 where both gradients have
    one sign and |g| >= 1e-6 (Adam's first update is lr * g / (|g| + 1e-8),
    so there the two updates differ by at most lr * 1e-8 * 2 / 1e-6), and
    within 2 * lr + 1e-6 elsewhere. Raises on a miss; returns the largest
    errors."""
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

    def step(net, where):
        state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", lr), device=where)
        return keypoints_train_step(state, batch, lr)[1]

    def ref_loss(net):
        hms, tags = net(prep_images(batch["images"]).double())
        return ae_keypoints_loss(hms, tags, batch["heatmaps"], batch["masks"], batch["joints"])[0]

    run = step_card_vs_cpu(dev, model, step, ref_loss, cudnn)
    (m_c, m_g), (sd_c, sd_g), g = run["metrics"], run["after"], run["grads"]
    out = {"loss_rel": max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c), "metrics_card": m_g}
    grad_rel = {n: rel_gap(g["card"][n], r) for n, r in g["ref"].items()}
    cpu_rel = {n: rel_gap(g["cpu"][n], r) for n, r in g["ref"].items()}
    p_sure = p_any = 0.0
    ambiguous = total = 0
    for name in g["ref"]:
        gc, gg = g["cpu"][name], g["card"][name]
        diff = (sd_g[name] - sd_c[name]).abs()
        sure = (gc.abs() >= 1e-6) & (gg.abs() >= 1e-6) & (torch.sign(gc) == torch.sign(gg))
        p_sure = max(p_sure, float(diff[sure].max()) if bool(sure.any()) else 0.0)
        p_any = max(p_any, float(diff.max()))
        ambiguous += int((~sure).sum())
        total += sure.numel()
    card_flat = torch.cat([v.flatten() for v in g["card"].values()])
    ref_flat = torch.cat([v.flatten() for v in g["ref"].values()])
    out.update(grad_rel_max=max(grad_rel.values()),
               grad_rel_worst=max(grad_rel, key=grad_rel.get),
               grad_rel_global=rel_gap(card_flat, ref_flat),
               cpu_grad_rel_max=max(cpu_rel.values()), cpu_grad_rel_worst=max(cpu_rel, key=cpu_rel.get),
               grad_rel_vs_cpu_max=max(rel_gap(g["card"][n], g["cpu"][n]) for n in g["ref"]),
               bn_stats_rel_max=run["bn_stats_rel_max"], bn_stats_moved=run["bn_stats_moved"],
               params_sure_abs_max=p_sure, params_abs_max=p_any,
               params_sign_ambiguous=f"{ambiguous} of {total}")
    n, size = batch["images"].shape[0], batch["images"].shape[-1]
    out["cudnn"] = cudnn
    log(f"train step card vs CPU ({n} x {size}^2, {what}, C=8 reduced, float32, TF32 off, cuDNN "
        f"{'on' if cudnn else 'off'}): " + ", ".join(f"{k} {v}" for k, v in out.items()))
    grads_ok = out["grad_rel_max"] <= 1e-3 or not check_grads
    if not (out["loss_rel"] <= 1e-4 and grads_ok and out["bn_stats_rel_max"] <= 1e-3
            and run["bn_stats_all_moved"] and p_sure <= 2e-5 + 1e-6 and p_any <= 2 * lr + 1e-6):
        raise AssertionError(f"train step card vs CPU: {out}")
    return out


def timed_steps(step, n_images: int, what: str, smi: str) -> dict:
    """``step()`` (ending in a device sync, returning its metrics) once for
    cuDNN's autotuning, then for a 2 s warm-up, then ``TRAIN_STEPS`` times by
    host wall (median, spread, img/s); the peak memory over the phase's
    start, the device busy time and idle share of one more step (profiler);
    every step's losses finite. Raises on a non-finite loss."""
    import torch

    losses = []

    def call():
        losses.append({k: float(v) for k, v in step().items()})

    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    warm = 1 + warm_up(call, 2.0)
    times = [host_ms(call) for _ in range(TRAIN_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    busy, groups = profile_breakdown(call)
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"{what}: non-finite losses {losses}")
    ms = float(np.median(times))
    rec = {"warmup_steps": warm, "ms": ms, "ms_min": min(times), "ms_max": max(times),
           "img_per_s": n_images / ms * 1e3, "peak_gib": peak / 2**30,
           "peak_over_start_gib": (peak - base_mem) / 2**30, "busy_ms": busy,
           "idle_share": None if busy is None else max(0.0, 1 - busy / ms), "busy_groups_ms": groups,
           "loss_per_step": [m["loss"] for m in losses]}
    idle = "not measured" if busy is None else f"{rec['idle_share']:.3f}"
    log(f"{what}: {ms:.1f} ms a step (median of {TRAIN_STEPS} after {warm} warm-up steps; "
        f"{min(times):.1f}-{max(times):.1f}), {rec['img_per_s']:.2f} img/s, peak {rec['peak_gib']:.2f} GiB "
        f"({rec['peak_over_start_gib']:.2f} over the start), device busy {busy} ms (idle share {idle}); "
        f"loss a step {[round(v, 6) for v in rec['loss_per_step']]}  [{smi}]")
    return rec


def train_phase(dev, counted, smi: str) -> dict:
    """Phase 9: the port's keypoints training step on the card. (1) the
    reduced step card vs CPU (``train_step_card_vs_cpu``); (2) HigherHRNet-W32
    from ``TRAIN_YAML`` with ``init_keypoints_weights_``, the yaml's optimizer
    and scheduler (Adam, lr 1e-3, MultiStepLR) at its batch size and input
    size, on a batch made on the card, in float32 (TF32 off) and in bfloat16
    autocast: after one step (cuDNN autotunes) and a 3 s warm-up,
    ``TRAIN_STEPS`` steps timed by host wall to a device sync (median,
    spread, img/s), the peak memory, the device busy time and idle share of
    one step (profiler), every step's losses finite (``timed_steps``);
    ``accumulated_keypoints_train_step(2)`` once on the same batch.
    All of it with every kernel's launch counter zeroed before; after, the
    decode's and the convolution's required at 0 (none lies on the training
    path), the BatchNorm backward pair's recorded. Then (3) one more
    bfloat16 step with the counters zeroed just before: 2 launches of the
    pair for each train-mode BatchNorm forward and none of any other kernel,
    and on the BatchNorm inputs the step gave the pair, the pair against its
    plain version and timed beside it, the library route and the bound
    (``bn_rows``; the kernels' summary row of the pair)."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.models import init_keypoints_weights_
    from human_pose_tpu_torch.train import (
        TrainState, accumulated_keypoints_train_step, create_lr_scheduler, create_optimizer,
        keypoints_train_step,
    )

    out = {"card": smi}
    steps = {}

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

                def step():
                    metrics = keypoints_train_step(state, batch, sched.lr)[1]
                    torch.cuda.synchronize()
                    return metrics

                out[name] = timed_steps(step, n, f"train {name}", smi)
                out[name]["steps"] = state.step
                steps[name] = step
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
    seen = {}
    _, out["step_launches"] = counted(
        lambda: seen.update(record_bn_inputs(steps["bfloat16"])),
        "phase 9 (one more W32 bfloat16 step, its BatchNorm inputs kept)",
        lambda _: {"batch_norm_backward": 2 * seen["forwards"]})
    rows, totals = bn_rows(dev, bn_step_cases(seen), smi)
    out["bn_backward"] = {"layers": seen["forwards"], "rows": rows, "totals": totals}
    return out


def train_only(dev, smi: str) -> int:
    """Phase 9 alone: no decode kernel is built (none lies on the training
    path; their launch counters are still required to stay at 0); the
    BatchNorm backward pair builds at its first use. Prints the phase's
    record as one JSON object last."""
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
TRAIN_DATA_STEPS = 4  # timed steps from the loader, across epoch boundaries
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


def train_data_phase(dev, counted, smi: str, phase9: dict | None = None,
                     float32: bool = True) -> dict:
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
    in this process; ``float32`` False: bfloat16 alone, the yaml's dtype,
    as the full smoke runs it for time); (e) ``validation_step`` and
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
            for argv in ((["--trainer.accelerator=gpu"], []) if float32 else ([],)):
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


TRAIN_ENGINE_EPOCHS = 2  # the W32 run through the CLI; the resume runs one more
TRAIN_ENGINE_REPEAT = 4  # the timing run's epoch: the training set 4x, 8 steps
TRAIN_ENGINE_SKIP = 2  # its first steps, not steady
TRAIN_ENGINE_CARD_STEPS = 4  # steps on a batch made on the card around a submit
# the reduced engine run card vs CPU, with the yaml's Adam and with SGD
# (momentum 0.9, lr 0.01): the first step's loss terms within rel 1e-4
# (phase 9's) for both; SGD's later steps and epoch means within 1e-3 of the
# larger of the term and the loss. Summation order alone moves this run's
# later losses: two CPU runs that differ only in torch's thread count drift
# by 9.3e-5 of the loss by the fourth step with SGD and by 1.1e-3 with Adam
# on phase 11's corpus (the drift grows 25x in the fourth step; an
# 8-core x86 CPU); an NVIDIA H100 80GB HBM3 at 700 W read 4.5e-4 with SGD
# and 6.5e-2 with Adam. Adam's later steps are read, not held: its update
# lr * m / (sqrt(v) + 1e-8) moves a weight by ~lr whatever its gradient's
# size, and the keypoints init's weights are N(0, 0.001)
ENGINE_FIRST_RTOL, ENGINE_SGD_RTOL = 1e-4, 1e-3
ENGINE_SGD = ("--module.optimizers.optim.name=SGD", "--module.optimizers.optim.params.lr=0.01",
              "--module.optimizers.optim.params.momentum=0.9")
ENGINE_REDUCED = ("--net.params.C=8", "--net.params.num_blocks_per_stage=[1,1,1,1]",
                  "--net.params.num_units=1", "--net.params.num_deconv_resid_blocks=1",
                  f"--dataloader.batch_size={TRAIN_REDUCED_BATCH}",
                  f"--dataloader.train_ds.out_size={TRAIN_REDUCED_SIZE}",
                  f"--dataloader.val_ds.out_size={TRAIN_REDUCED_SIZE}",
                  f"--transform.out_size={TRAIN_REDUCED_SIZE}", "--trainer.limit_batches=2",
                  "--trainer.max_epochs=2", "--cudnn.enabled=false")


class EngineProbe:
    """While active: each ``Trainer.evaluate``'s epoch and the kernel
    launches it made (from ``counters``), each ``AsyncCheckpointWriter.submit``'s
    caller-thread ms, and each checkpoint write's seconds and bytes (the
    writer thread's ``_write``). The working directory is ``workdir`` (where
    ``results/`` lands); at the end the file log handlers a run added are
    closed and the cuDNN switches it applied are restored."""

    def __init__(self, workdir: Path, counters: dict | None = None):
        self.workdir, self.counters = workdir, counters or {}
        self.evaluates, self.submits_ms, self.writes = [], [], []

    def __enter__(self):
        from human_pose_tpu_torch.loggers.pylogger import log as port_log
        from human_pose_tpu_torch.train import checkpoint, trainer

        import torch

        cudnn = torch.backends.cudnn
        self._cudnn = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
        self._saved = (os.getcwd(), list(port_log.handlers), trainer.Trainer.evaluate,
                       checkpoint.AsyncCheckpointWriter.submit, checkpoint._write)
        cwd, _, evaluate, submit, write = self._saved
        probe = self

        def counted_evaluate(tr, *args, **kwargs):
            before = {k: w.launches for k, w in probe.counters.items()}
            out = evaluate(tr, *args, **kwargs)
            if probe.counters:
                import torch

                torch.cuda.synchronize()
            probe.evaluates.append((tr.current_epoch, {k: w.launches - before[k]
                                                       for k, w in probe.counters.items()}))
            return out

        def timed_submit(writer, *args, **kwargs):
            t0 = time.perf_counter()
            submit(writer, *args, **kwargs)
            probe.submits_ms.append((time.perf_counter() - t0) * 1e3)

        def timed_write(path, *args, **kwargs):
            t0 = time.perf_counter()
            write(path, *args, **kwargs)
            probe.writes.append((Path(path).name, time.perf_counter() - t0, Path(path).stat().st_size))

        trainer.Trainer.evaluate = counted_evaluate
        checkpoint.AsyncCheckpointWriter.submit = timed_submit
        checkpoint._write = timed_write
        os.chdir(self.workdir)
        return self

    def __exit__(self, *exc):
        from human_pose_tpu_torch.loggers.pylogger import log as port_log
        from human_pose_tpu_torch.train import checkpoint, trainer

        import torch

        cudnn = torch.backends.cudnn
        cudnn.benchmark, cudnn.deterministic, cudnn.enabled = self._cudnn  # the CLI applies the yaml's
        cwd, handlers, evaluate, submit, write = self._saved
        os.chdir(cwd)
        trainer.Trainer.evaluate = evaluate
        checkpoint.AsyncCheckpointWriter.submit = submit
        checkpoint._write = write
        for h in [h for h in port_log.handlers if h not in handlers]:
            port_log.removeHandler(h)
            h.close()
        return False


def engine_losses(tr) -> dict:
    """Per-step train losses and the epoch means of a trainer's storage."""
    epochs = tr.storage.aggregate_over_key("epoch").metrics
    return {"steps": {k: [r["value"] for r in v["train"]] for k, v in tr.storage.metrics.items()},
            "epochs": {k: {s: [r["value"] for r in recs] for s, recs in v.items()}
                       for k, v in epochs.items()}}


def engine_card_vs_cpu(dev, yaml_path: str, roots: list, workdir: Path) -> dict:
    """The reduced net (C=8, 128^2, batch 4, two epochs of two batches and
    two val batches, float32, cuDNN off as phase 10 holds the step) trained
    through ``bin.train_keypoints.main`` on the card and on the CPU from the
    same seeded weights and the same loader batches, with the yaml's Adam
    and with SGD (``ENGINE_SGD``): the largest relative difference of the
    first step's loss terms, and of every later step's terms and every epoch
    mean (train and val) as a share of the larger of the term and the loss.
    Holds both first steps within ``ENGINE_FIRST_RTOL`` and SGD's later
    steps and means within ``ENGINE_SGD_RTOL``; Adam's later steps are read
    (see ``ENGINE_SGD_RTOL``'s comment). Raises on a miss; returns the
    errors."""
    from human_pose_tpu_torch.bin import train_keypoints

    out = {}
    for opt, opt_argv in (("adam", ()), ("sgd", ENGINE_SGD)):
        runs = {}
        for where in ("gpu", "cpu"):
            (workdir / opt / where).mkdir(parents=True, exist_ok=True)
            with EngineProbe(workdir / opt / where):
                tr = train_keypoints.main([f"--config={yaml_path}", *roots,
                                           "--setup.pretrained_ckpt_path=null", *ENGINE_REDUCED,
                                           *opt_argv, f"--trainer.accelerator={where}"])
            if tr.module.device.type != (dev.type if where == "gpu" else "cpu"):
                raise AssertionError(f"engine card vs CPU: the {where} run ran on {tr.module.device}")
            runs[where] = engine_losses(tr)
        card, cpu = runs["gpu"], runs["cpu"]
        rec = {"first_rel": 0.0, "later_rel_of_scale": 0.0, "epochs_rel_of_scale": 0.0,
               "loss_card": card["steps"]["loss"], "loss_cpu": cpu["steps"]["loss"]}
        for key, want in cpu["steps"].items():
            got = card["steps"][key]
            if len(got) != len(want) or len(want) != 4:
                raise AssertionError(f"engine card vs CPU ({opt}): {key} steps {len(got)} vs {len(want)}")
            rec["first_rel"] = max(rec["first_rel"], abs(got[0] - want[0]) / max(abs(want[0]), 1e-30))
            for g, w, loss in list(zip(got, want, cpu["steps"]["loss"]))[1:]:
                rec["later_rel_of_scale"] = max(rec["later_rel_of_scale"], abs(g - w) / max(abs(w), loss))
            for split, values in cpu["epochs"][key].items():
                for g, w, loss in zip(card["epochs"][key][split], values, cpu["epochs"]["loss"][split]):
                    rec["epochs_rel_of_scale"] = max(rec["epochs_rel_of_scale"],
                                                     abs(g - w) / max(abs(w), loss))
        out[opt] = rec
        log(f"engine card vs CPU, {opt} (C=8, {TRAIN_REDUCED_SIZE}^2, batch {TRAIN_REDUCED_BATCH}, 2 epochs "
            f"of 2 batches, float32, TF32 and cuDNN off): " + ", ".join(f"{k} {v}" for k, v in rec.items()))
    if not (out["adam"]["first_rel"] <= ENGINE_FIRST_RTOL and out["sgd"]["first_rel"] <= ENGINE_FIRST_RTOL
            and out["sgd"]["later_rel_of_scale"] <= ENGINE_SGD_RTOL
            and out["sgd"]["epochs_rel_of_scale"] <= ENGINE_SGD_RTOL):
        raise AssertionError(f"engine card vs CPU: {out}")
    return out


def summary_txt_total(path: Path) -> int:
    return int(path.read_text().splitlines()[-1].split()[-1].replace(",", ""))


def train_engine_phase(dev, counted, smi: str, phase10: dict | None = None) -> dict:
    """Phase 11: the training engine on the card. (a) a synthesized
    ``train2017`` (72 images, two batches of 36) and ``val2017`` (12) as
    phase 10's; (b) W32 from ``TRAIN_YAML`` (batch 36, 512^2, bfloat16, Adam)
    through ``bin.train_keypoints.main`` for ``TRAIN_ENGINE_EPOCHS`` epochs
    in a temporary working directory, the pretrained path null: FINISHED in
    the tracker, best.pt, last.pt, the epoch metrics' yaml, html and jpg,
    the model summary (TOTAL 28,645,331), the device log and the tracker's
    metrics files; with the launch counters zeroed before the run, each
    evaluate launches the dense refine and the grouping once; each
    checkpoint's submit ms, write seconds and size; (c) the resume from
    last.pt to one more epoch: that epoch only, the step count continued;
    (d) the last.pt strictly into ``InferenceKeypointsModel``, one val image
    decoded; (e) a timing run through the ``Trainer`` (the training set
    ``TRAIN_ENGINE_REPEAT`` times in one epoch): ms between step launches,
    median of the steady steps, beside phase 10's steady step (``phase10``
    when it ran in this process, else measured here); the step right after a
    checkpoint submit against steps on a batch made on the card; (f) the
    reduced run card vs CPU with Adam and with SGD (``engine_card_vs_cpu``).
    Raises on a failed check."""
    import tempfile

    import torch

    from human_pose_tpu_torch.bin import train_keypoints
    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.data import DataLoader, collate
    from human_pose_tpu_torch.train import DeviceBatch, checkpoint

    rng = np.random.default_rng(SEED + 11)
    out = {"card": smi}
    yaml_path = str(Path(__file__).resolve().parent / TRAIN_YAML)
    counters = {k: w for k, w in kernel_counters().items() if k in ("match_by_tag", "refine_argmax")}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "coco"
        out["corpus"] = {
            split: make_eval_corpus(root, rng, split, n, TRAIN_DATA_PERSONS, TRAIN_DATA_CROWD_EVERY)
            for split, n in (("train2017", TRAIN_DATA_N_IMAGES), ("val2017", TRAIN_DATA_N_VAL))}
        roots = [f"--dataloader.train_ds.root={root}", f"--dataloader.val_ds.root={root}"]
        argv = [f"--config={yaml_path}", *roots, "--setup.pretrained_ckpt_path=null"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # (b) the W32 run
        work = tmp / "w32"
        work.mkdir()
        t0 = time.perf_counter()
        with EngineProbe(work, counters) as probe:
            tr, launches = counted(
                lambda: train_keypoints.main([*argv, f"--trainer.max_epochs={TRAIN_ENGINE_EPOCHS}"]),
                f"phase 11 (the W32 run: {TRAIN_ENGINE_EPOCHS} epochs, an evaluate each)",
                {"match_by_tag": TRAIN_ENGINE_EPOCHS, "refine_argmax": TRAIN_ENGINE_EPOCHS})
        run_s = time.perf_counter() - t0
        run_dir = work / tr.log_path
        n_params = sum(p.numel() for p in tr.module.model.parameters())
        status = json.loads((run_dir / "tracker" / "run.json").read_text())["status"]
        files = ["checkpoints/best.pt", "checkpoints/last.pt", "epoch_metrics.yaml", "epoch_metrics.html",
                 "epoch_metrics.jpg", "model/model_summary.txt", "logs/device_0.log",
                 "tracker/metrics_train.jsonl", "tracker/metrics_val.jsonl", "tracker/run.json",
                 "config.yaml"]
        missing = [f for f in files if not (run_dir / f).is_file()]
        total = summary_txt_total(run_dir / "model" / "model_summary.txt")
        per_eval = [c for _, c in probe.evaluates]
        if (status != "FINISHED" or missing or total != W32_PARAMS or n_params != W32_PARAMS
                or tr.module.device != dev or tr.module.state.dtype != torch.bfloat16
                or per_eval != [{"match_by_tag": 1, "refine_argmax": 1}] * TRAIN_ENGINE_EPOCHS
                or tr.current_step != 2 * TRAIN_ENGINE_EPOCHS):
            raise AssertionError(f"train engine W32 run: status {status}, missing {missing}, TOTAL {total}, "
                                 f"{n_params} parameters on {tr.module.device} {tr.module.state.dtype}, "
                                 f"launches an evaluate {per_eval}, steps {tr.current_step}")
        losses = engine_losses(tr)
        if not all(np.isfinite(v) for k in losses["steps"].values() for v in k):
            raise AssertionError(f"train engine W32 run: non-finite losses {losses['steps']}")
        last = run_dir / "checkpoints" / "last.pt"
        saved = checkpoint.load_checkpoint(last)
        out["w32_run"] = {
            "seconds": run_s, "status": status, "steps": tr.current_step, "params": n_params,
            "summary_total": total, "dtype": "bfloat16", "launches": launches,
            "launches_an_evaluate": per_eval, "loss_steps": losses["steps"]["loss"],
            "val_loss_epochs": losses["epochs"]["loss"]["val"],
            "saves": [{"file": f, "write_s": s, "mb": b / 1e6, "submit_ms": ms}
                      for (f, s, b), ms in zip(probe.writes, probe.submits_ms)],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "last_pt": {"epoch": saved["epoch"], "step": saved["step"]}}
        log(f"train engine W32 run ({TRAIN_ENGINE_EPOCHS} epochs of 2 batches of 36 at 512^2, bfloat16, Adam): "
            f"{run_s:.1f}s, FINISHED, {tr.current_step} steps, loss a step "
            f"{[round(v, 6) for v in out['w32_run']['loss_steps']]}, launches an evaluate {per_eval}; saves "
            + ", ".join(f"{r['file']} submit {r['submit_ms']:.1f} ms, write {r['write_s']:.2f}s, {r['mb']:.1f} MB"
                        for r in out["w32_run"]["saves"]) + f"  [{smi}]")
        del tr
        torch.cuda.empty_cache()

        # (c) the resume
        with EngineProbe(work, counters) as probe:
            tr = train_keypoints.main([*argv, f"--setup.ckpt_path={last.resolve()}",
                                       f"--trainer.max_epochs={TRAIN_ENGINE_EPOCHS + 1}"])
        epochs = [e for e, _ in probe.evaluates]
        if epochs != [TRAIN_ENGINE_EPOCHS] or tr.current_step != saved["step"] + 2:
            raise AssertionError(f"train engine resume: evaluated epochs {epochs}, step {tr.current_step} "
                                 f"after {saved['step']}")
        out["resume"] = {"from_step": saved["step"], "epochs_run": epochs, "step": tr.current_step,
                         "loss_steps": engine_losses(tr)["steps"]["loss"][-2:]}
        log(f"train engine resume: {out['resume']}")
        last = work / tr.log_path / "checkpoints" / "last.pt"
        del tr
        torch.cuda.empty_cache()

        # (d) inference from the run's last.pt
        cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(yaml_path, roots))
        model = cfg.create_inference_model(ckpt_path=str(last))
        ds = cfg.create_datamodule().val_ds
        result = model(ds.load_image(0))
        det = result.to_coco_detections(0)
        if not all(np.isfinite(np.asarray(a, np.float32)).all()
                   for a in (result.kpts_coords, result.kpts_scores, result.obj_scores)):
            raise AssertionError("train engine: non-finite inference from last.pt")
        out["inference"] = {"persons": len(result.obj_scores), "detections": len(det),
                            "dtype": str(model.dtype).split(".")[-1]}
        log(f"train engine: last.pt -> InferenceKeypointsModel (strict load), one val image: {out['inference']}")
        del model

        # (e) the timing run through the Trainer
        cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
            yaml_path, [*roots, "--setup.pretrained_ckpt_path=null", "--trainer.max_epochs=1"]))
        work = tmp / "timing"
        work.mkdir()
        with EngineProbe(work) as probe:
            cfg.initialize_logging()
            cfg.apply_cudnn()
            dm = cfg.create_datamodule()
            dl = dm.train_dl
            dm.train_dl = DataLoader(Repeated(dm.train_ds, TRAIN_ENGINE_REPEAT), dl.batch_size, collate,
                                     num_workers=dl.num_workers, seed=dl.seed)
            module = cfg.create_module()
            tr = cfg.create_trainer()
            stamps, step = [], module.training_step

            def stamped(batch):
                stamps.append(time.perf_counter())
                return step(batch)

            module.training_step = stamped
            tr.fit(module, dm)
            gaps = np.diff(stamps) * 1e3
            steady = gaps[TRAIN_ENGINE_SKIP - 1:]
            rec = {"steps": len(stamps), "ms": float(np.median(steady)), "ms_min": float(steady.min()),
                   "ms_max": float(steady.max()), "gaps_ms": gaps.tolist()}
            if phase10 is None:
                phase10 = {"bfloat16": train_data_steps(dev, cfg, smi)[0]}
                rec["phase10_source"] = "measured in this phase"
            else:
                rec["phase10_source"] = "phase 10 in this process"
            p10 = phase10["bfloat16"]["steady"]
            rec.update(phase10_steady_ms=p10["ms"], engine_overhead_ms=rec["ms"] - p10["ms"])
            # the writer's cost: steps on a batch made on the card around one submit
            module.training_step = step
            batch = DeviceBatch(train_batch(cfg.dataloader.batch_size, cfg.dataloader.train_ds.out_size,
                                            cfg.dataloader.train_ds.max_num_people,
                                            torch.Generator(device=dev).manual_seed(SEED), dev))

            def synced_step():
                module.training_step(batch)
                torch.cuda.synchronize()

            synced_step()
            card_ms = [host_ms(synced_step) for _ in range(TRAIN_ENGINE_CARD_STEPS)]
            path = work / "submit.pt"
            t0 = time.perf_counter()
            tr.save_checkpoint(path)
            submit_ms = (time.perf_counter() - t0) * 1e3
            after_ms = host_ms(synced_step)
            t1 = time.perf_counter()
            tr._ckpt_writer.wait()
            join_s = time.perf_counter() - t1
            t2 = time.perf_counter()
            checkpoint.save_checkpoint(work / "sync.pt", module.state, 0,
                                       lr_schedulers=module.schedulers_state_dict())
            sync_s = time.perf_counter() - t2
            rec["writer"] = {"card_step_ms": float(np.median(card_ms)), "card_step_ms_all": card_ms,
                             "submit_ms": submit_ms, "step_after_submit_ms": after_ms,
                             "join_after_step_s": join_s, "sync_save_s": sync_s,
                             "mb": path.stat().st_size / 1e6}
        out["timing"] = rec
        w = rec["writer"]
        log(f"train engine timing (one epoch of {rec['steps']} steps through the Trainer, W32 bfloat16 bs36 "
            f"512^2 from the loader): {rec['ms']:.1f} ms a step between launches (median of "
            f"{len(steady)} steady; {rec['ms_min']:.1f}-{rec['ms_max']:.1f}) vs phase 10's steady "
            f"{rec['phase10_steady_ms']:.1f} ms ({rec['phase10_source']}): engine overhead "
            f"{rec['engine_overhead_ms']:.1f} ms; on a card batch {w['card_step_ms']:.1f} ms a step, "
            f"submit {w['submit_ms']:.1f} ms, the step after it {w['step_after_submit_ms']:.1f} ms, the "
            f"write joined {w['join_after_step_s']:.2f}s after; a synchronous save {w['sync_save_s']:.2f}s, "
            f"{w['mb']:.1f} MB  [{smi}]")
        del tr, module, dm
        torch.cuda.empty_cache()

        # (f) the reduced run, card vs CPU
        out["card_vs_cpu"] = engine_card_vs_cpu(dev, yaml_path, roots, tmp / "reduced")
    out["launches"] = out["w32_run"]["launches"]
    return out


def train_engine_only(dev, smi: str) -> int:
    """Phase 11 alone: build the dense refine and the grouping (the
    validation's decode), then the training engine's phase. Prints the
    phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"train_engine": train_engine_phase(dev, counted, smi)}), flush=True)
    return 0


# phase 12, ImageNet classification: ClassificationHRNet-W32 from its yaml
# (batch 80, 224^2, SGD lr 0.1, momentum 0.9, nesterov, weight decay 1e-4)
CLS_YAML = "experiments/classification/hrnet_32.yaml"
CLS_PARAMS = 41_232_680  # ClassificationHRNet-W32 at 1000 classes
CLS_REDUCED = {"C": 8, "num_classes": 1000, "num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1}
# the reduced step is held at batch 8 and at batch 4; at batch 4 a ReLU
# input of the head's last Bottleneck (2x2 maps) lies within rounding of
# zero, and a float32 evaluation that decides it otherwise than float64 moves
# gradients by more than 1e-3 a tensor (``classification_step_card_vs_cpu``)
CLS_REDUCED_BATCHES, CLS_REDUCED_SIZE = (8, 4), 64
# a synthesized ImageFolder in ImageNet's commonest raw sizes (h, w): 4
# classes, 40 training images a class (two batches of 80 an epoch) and 8
# validation images a class
CLS_RAW_HW = ((375, 500), (500, 375), (333, 500), (500, 500))
CLS_CLASSES, CLS_TRAIN_PER_CLASS, CLS_VAL_PER_CLASS = 4, 40, 8
CLS_EPOCHS = 2
CLS_EVAL_BATCH = 16
CLS_INFER_CALLS = 20


def make_imagefolder(root: Path, rng, split: str, per_class: int) -> dict:
    """``root/<split>/<wnid>/<wnid>_<i>.JPEG``: ``per_class`` seeded jpgs of
    the sizes ``CLS_RAW_HW`` in each of ``CLS_CLASSES`` classes (a smooth
    random background and a disc of the class's color, so that the classes
    can be told apart). Returns the counts of images a raw size."""
    import cv2

    sizes = {}
    for c in range(CLS_CLASSES):
        d = root / split / f"n{c:08d}"
        d.mkdir(parents=True)
        color = tuple(int(v) for v in (np.arange(3) * 97 + c * 61) % 256)
        for i in range(per_class):
            h, w = CLS_RAW_HW[int(rng.integers(len(CLS_RAW_HW)))]
            sizes[f"{h}x{w}"] = sizes.get(f"{h}x{w}", 0) + 1
            small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
            img = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
            r = int(rng.integers(min(h, w) // 6, min(h, w) // 3))
            center = (int(rng.integers(r, w - r)), int(rng.integers(r, h - r)))
            cv2.circle(img, center, r, color, -1)
            cv2.imwrite(str(d / f"n{c:08d}_{i:04d}.JPEG"), img)
    return sizes


def cls_batch(n: int, size: int, num_classes: int, gen, device) -> tuple:
    """A seeded batch made on ``device``: uint8 NCHW images, int64 labels."""
    import torch

    kw = {"generator": gen, "device": device}
    return (torch.randint(0, 256, (n, 3, size, size), dtype=torch.uint8, **kw),
            torch.randint(0, num_classes, (n,), **kw))


def _cls_sgd(cfg) -> tuple:
    """(lr, the optimizer's other parameters) of a classification config."""
    params = dict(cfg.module.optimizers["optim"]["params"])
    return params.pop("lr"), params


def classification_step_card_vs_cpu(dev, batch_size: int = CLS_REDUCED_BATCHES[0]) -> dict:
    """One float32 SGD step (the yaml's: nesterov, momentum 0.9, weight decay
    1e-4, lr 0.1; TF32 off, cuDNN off, as phase 10 holds its step) of the
    reduced ClassificationHRNet (``CLS_REDUCED``, ``batch_size`` at 64^2) on
    the card and on the CPU from the same ``init_classification_weights_``
    weights and a seeded batch (``step_card_vs_cpu`` with ReLU decisions).
    A ReLU input within rounding of zero makes float32 and float64 take
    different decisions, and one such decision at 2x2 maps moves the whole
    gradient (``CLS_REDUCED_BATCHES``), so each device is held against the
    float64 gradient evaluated with its own ReLU decisions. Held: the loss
    within rel 1e-4, each error within one sample; each device's decisions
    that differ from float64's at an input within 1e-4 of that ReLU input's
    largest value; every gradient of the card and of the CPU within
    ||g - ref|| / ||ref|| 1e-3 of that reference (a bias right before a
    train-mode BatchNorm has a zero gradient in exact arithmetic: where
    ||ref|| is below 1e-6 of the whole gradient's norm, the card's must be
    below 1e-5 of it); each BN running statistic within 1e-3 of its
    tensor's largest value; where card and CPU take every decision alike,
    each gradient of the card within 1e-3 of the CPU's and each other
    parameter's update within 1e-3 of the CPU's (else both gaps are only
    reported). Raises on a miss; returns the largest errors."""
    import torch

    from human_pose_tpu_torch.configs import ClassificationConfig
    from human_pose_tpu_torch.models import ClassificationHRNet, init_classification_weights_
    from human_pose_tpu_torch.ops import prep_images
    from human_pose_tpu_torch.train import (
        TrainState, classification_loss, classification_train_step, create_optimizer,
    )

    cfg = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / CLS_YAML), []))
    lr, opt_params = _cls_sgd(cfg)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 12)
    model = init_classification_weights_(ClassificationHRNet(**CLS_REDUCED, device=cpu), gen)
    images, labels = cls_batch(batch_size, CLS_REDUCED_SIZE, CLS_REDUCED["num_classes"], gen, cpu)

    def step(net, where):
        opt = create_optimizer(net.parameters(), "SGD", lr, **opt_params)
        return classification_train_step(TrainState.create(net, opt, device=where), images, labels, lr)[1]

    run = step_card_vs_cpu(dev, model, step,
                           lambda net: classification_loss(net(prep_images(images).double()), labels),
                           cudnn=False, decisions=True)
    (m_c, m_g), (sd_c, sd_g), g, relu = run["metrics"], run["after"], run["grads"], run["relu"]
    total = float(torch.cat([v.flatten() for v in g["ref"].values()]).norm())
    grad_rel, cpu_rel, own_rel, cpu_own_rel, zero_rel, vs_cpu, step_rel = {}, {}, {}, {}, {}, {}, {}
    for name, ref in g["ref"].items():
        if float(ref.norm()) < 1e-6 * total:
            zero_rel[name] = float(g["card"][name].norm()) / total
            continue
        grad_rel[name] = rel_gap(g["card"][name], g["ref_card"][name])
        cpu_rel[name] = rel_gap(g["cpu"][name], g["ref_cpu"][name])
        own_rel[name] = rel_gap(g["card"][name], ref)
        cpu_own_rel[name] = rel_gap(g["cpu"][name], ref)
        vs_cpu[name] = rel_gap(g["card"][name], g["cpu"][name])
        step_c, step_g = sd_c[name] - run["start"][name], sd_g[name] - run["start"][name]
        step_rel[name] = float((step_g - step_c).norm() / step_c.norm())
    alike = relu["card_vs_cpu_differ"] == 0
    out = {"batch": batch_size, "loss_rel": abs(m_g["loss"] - m_c["loss"]) / abs(m_c["loss"]),
           "errors_abs": max(abs(m_g[k] - m_c[k]) for k in ("top-1_error", "top-5_error")),
           "relu": relu,
           "grad_rel_max": max(grad_rel.values()), "grad_rel_worst": max(grad_rel, key=grad_rel.get),
           "cpu_grad_rel_max": max(cpu_rel.values()),
           "grad_rel_own_decisions_max": max(own_rel.values()),
           "cpu_grad_rel_own_decisions_max": max(cpu_own_rel.values()),
           "zero_grad_biases": len(zero_rel), "zero_grad_rel_max": max(zero_rel.values(), default=0.0),
           "bn_stats_rel_max": run["bn_stats_rel_max"], "bn_stats_moved": run["bn_stats_moved"],
           "grad_rel_vs_cpu_max": max(vs_cpu.values()), "update_rel_max": max(step_rel.values()),
           "metrics_card": m_g}
    log(f"classification step card vs CPU ({batch_size} x {CLS_REDUCED_SIZE}^2, C=8 reduced, "
        f"SGD nesterov, float32, TF32 and cuDNN off): " + ", ".join(f"{k} {v}" for k, v in out.items()))
    decisions_ok = all(relu[who]["differ_input_rel_max"] <= 1e-4 for who in ("cpu", "card"))
    if not (out["loss_rel"] <= 1e-4 and out["errors_abs"] <= 1 / batch_size + 1e-6 and decisions_ok
            and out["grad_rel_max"] <= 1e-3 and out["cpu_grad_rel_max"] <= 1e-3
            and out["zero_grad_rel_max"] <= 1e-5
            and out["bn_stats_rel_max"] <= 1e-3 and run["bn_stats_all_moved"]
            and (not alike or (out["grad_rel_vs_cpu_max"] <= 1e-3 and out["update_rel_max"] <= 1e-3))):
        raise AssertionError(f"classification step card vs CPU: {out}")
    return out


def classification_steps(dev, smi: str) -> dict:
    """W32 from ``CLS_YAML`` (``create_module`` on the card: the
    classification init, the yaml's SGD and MultiStepLR) at its batch and
    input size on a batch made on the card, in float32 (TF32 off) and in
    bfloat16 autocast (``timed_steps``); ``accumulated_classification_train_step(2)``
    once in float32."""
    import torch

    from human_pose_tpu_torch.configs import ClassificationConfig
    from human_pose_tpu_torch.train import DeviceBatch, accumulated_classification_train_step

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        argv = [] if dtype == torch.bfloat16 else ["--trainer.accelerator=gpu"]
        cfg = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(
            str(Path(__file__).resolve().parent / CLS_YAML), argv))
        module = cfg.create_module(device=dev)
        n_params = sum(p.numel() for p in module.model.parameters())
        if module.state.dtype != dtype or n_params != CLS_PARAMS:
            raise AssertionError(f"classification W32: {module.state.dtype}, {n_params} parameters")
        n, size = cfg.dataloader.batch_size, cfg.transform.out_size
        images, labels = cls_batch(n, size, cfg.net.params["num_classes"],
                                   torch.Generator(device=dev).manual_seed(SEED), dev)
        batch = DeviceBatch({"images": images, "labels": labels})  # NCHW on the card already

        def step():
            metrics = module.training_step(batch)
            torch.cuda.synchronize()
            return metrics

        lr, opt_params = _cls_sgd(cfg)
        out.update(batch=n, size=size, params=n_params, lr=lr, optimizer=opt_params)
        out[name] = timed_steps(step, n, f"classification W32 {name} (batch {n} at {size}^2, SGD)", smi)
        out[name]["steps"] = module.state.step
        if dtype == torch.float32:
            _, acc = accumulated_classification_train_step(2)(module.state, images, labels, module.lr)
            acc = {k: float(v) for k, v in acc.items()}
            if not all(np.isfinite(v) for v in acc.values()):
                raise AssertionError(f"classification: accumulated step metrics {acc}")
            out["accumulated_2"] = acc
            log(f"classification float32 accumulated_classification_train_step(2): {acc}")
        del module, batch
        torch.cuda.empty_cache()
    return out


def classification_cli(dev, tmp: Path, smi: str) -> dict:
    """The synthesized ImageFolder (``make_imagefolder``) through the port's
    entry points: the loader's samples a second (yaml's 4 workers, and 8)
    and host ms a sample; ``bin.train_classification.main`` (W32 from the
    yaml, bfloat16) for ``CLS_EPOCHS`` epochs to FINISHED; its last.pt
    through ``bin.eval_classification.main`` in float32 serial and at batch
    ``CLS_EVAL_BATCH`` (errors equal) and ``bin.inference_classification.main
    --mode=val`` (an overlay an image); eval img/s serial and batched in
    float32 and bfloat16 (``evaluate_split``, after a warm-up), the
    inference model's ms an image at input 256; its float32 probabilities
    and logits card vs CPU on seeded random weights; the last.pt as HigherHRNet-W32's pretrained weights
    (``load_params_partial``, as ``Trainer.fit`` loads
    ``pretrained_ckpt_path``): every backbone parameter. Raises on a miss."""
    import torch

    from human_pose_tpu_torch.bin import (
        eval_classification, inference_classification, train_classification,
    )
    from human_pose_tpu_torch.configs import ClassificationConfig, KeypointsConfig
    from human_pose_tpu_torch.data import DataLoader, ImagenetClassificationDataset, collate_classification
    from human_pose_tpu_torch.data.transforms import ClassificationTransform
    from human_pose_tpu_torch.ops import prep_images
    from human_pose_tpu_torch.train import checkpoint

    rng = np.random.default_rng(SEED + 12)
    root = tmp / "imagenet"
    out = {"corpus": {"train": make_imagefolder(root, rng, "train", CLS_TRAIN_PER_CLASS),
                      "val": make_imagefolder(root, rng, "val", CLS_VAL_PER_CLASS)}}
    yaml_path = str(Path(__file__).resolve().parent / CLS_YAML)
    roots = [f"--dataloader.train_ds.root={root}", f"--dataloader.val_ds.root={root}"]
    cfg = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(yaml_path, roots))

    # the loader
    t = ClassificationTransform(out_size=cfg.transform.out_size)
    ds = ImagenetClassificationDataset(str(root), "train", t.train)
    rates = {}
    for workers in (cfg.dataloader.num_workers, 8):
        dl = DataLoader(ds, cfg.dataloader.batch_size, collate_classification, num_workers=workers,
                        seed=SEED)
        loader_rate(dl, 1)  # first touches of the files
        rates[f"workers_{workers}"] = loader_rate(dl, 2)
    stage = {"jpeg": 0.0, "crop_flip_normalize": 0.0}
    for idx in range(32):
        t0 = time.perf_counter()
        img = ds.load_image(idx)
        t1 = time.perf_counter()
        t.train(img, np.random.default_rng(idx))
        stage["jpeg"] += (t1 - t0) * 1e3 / 32
        stage["crop_flip_normalize"] += (time.perf_counter() - t1) * 1e3 / 32
    out["loader"] = {"samples_per_s": rates, "host_ms_a_sample": stage}
    log(f"classification loader (batch {cfg.dataloader.batch_size}, {cfg.transform.out_size}^2, "
        f"{len(ds)} images): samples/s {rates}; host ms a sample {stage}")

    # the training CLI
    work = tmp / "cls"
    work.mkdir()
    t0 = time.perf_counter()
    with EngineProbe(work):
        tr = train_classification.main([f"--config={yaml_path}", *roots,
                                        f"--trainer.max_epochs={CLS_EPOCHS}"])
    run_s = time.perf_counter() - t0
    run_dir = work / tr.log_path
    status = json.loads((run_dir / "tracker" / "run.json").read_text())["status"]
    last = run_dir / "checkpoints" / "last.pt"
    steps_an_epoch = len(ds) // cfg.dataloader.batch_size
    losses = engine_losses(tr)
    if (status != "FINISHED" or not last.is_file() or tr.module.device != dev
            or tr.module.state.dtype != torch.bfloat16 or tr.current_step != CLS_EPOCHS * steps_an_epoch
            or not all(np.isfinite(v) for k in losses["steps"].values() for v in k)):
        raise AssertionError(f"classification CLI run: {status}, {last.is_file()}, {tr.module.device} "
                             f"{tr.module.state.dtype}, {tr.current_step} steps, {losses['steps']}")
    out["train_cli"] = {"seconds": run_s, "status": status, "steps": tr.current_step,
                        "loss_steps": losses["steps"]["loss"], "val_epochs": losses["epochs"]["loss"]["val"],
                        "val_top1_error_epochs": losses["epochs"]["top-1_error"]["val"],
                        "last_pt_mb": last.stat().st_size / 1e6}
    log(f"classification train CLI (W32, bfloat16, {CLS_EPOCHS} epochs of {steps_an_epoch} batches of "
        f"{cfg.dataloader.batch_size}): {out['train_cli']}  [{smi}]")
    del tr
    torch.cuda.empty_cache()

    # the eval and inference CLIs from last.pt
    ckpt = [f"--inference.ckpt_path={last}"]
    with EngineProbe(work):
        serial = eval_classification.main([f"--config={yaml_path}", *roots, *ckpt, "--trainer.accelerator=gpu"])
        batched = eval_classification.main([f"--config={yaml_path}", *roots, *ckpt, "--trainer.accelerator=gpu",
                                            f"--batch_size={CLS_EVAL_BATCH}"])
        written = inference_classification.main([f"--config={yaml_path}", *roots, *ckpt, "--mode=val"])
        missing = [str(p) for p in written if not (work / p).is_file()]
    if serial != batched or serial["n"] != CLS_CLASSES * CLS_VAL_PER_CLASS or len(written) != 8 or missing:
        raise AssertionError(f"classification eval / inference CLI: serial {serial}, batched {batched}, "
                             f"{len(written)} overlays, missing {missing}")
    out["eval_cli"] = {"serial": serial, "batched": batched, "overlays": len(written)}
    log(f"classification eval CLI (float32, last.pt): serial {serial} == batch {CLS_EVAL_BATCH} {batched}; "
        f"inference CLI wrote {len(written)} overlays")

    # eval img/s and the inference model's ms an image
    val = ImagenetClassificationDataset(str(root), "val")
    n_val = len(val)
    raw = val.load_image(0)
    speed = {}
    for name, argv in (("float32", ["--trainer.accelerator=gpu"]), ("bfloat16", [])):
        c = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(yaml_path, [*roots, *argv]))
        model = c.create_inference_model(ckpt_path=str(last))
        rec = {}
        for bs in (1, CLS_EVAL_BATCH):
            eval_classification.evaluate_split(model, val, n_val, bs)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec[f"stats_bs{bs}"] = eval_classification.evaluate_split(model, val, n_val, bs)
            rec[f"img_per_s_bs{bs}"] = n_val / (time.perf_counter() - t0)
        model(raw)
        rec["ms_an_image"] = host_ms(lambda: model(raw), CLS_INFER_CALLS)
        x = model.to_device(model.transform.inference(raw)[None])
        rec["device_ms_an_image"] = cuda_ms(lambda: model.probs(x), iters=10, warmup=2)
        rec["input_size"] = model.transform.out_size
        speed[name] = rec
        log(f"classification inference {name} (W32, input {rec['input_size']}): {rec['ms_an_image']:.2f} ms an "
            f"image through __call__ (a {raw.shape[0]}x{raw.shape[1]} raw image; forward+softmax "
            f"{rec['device_ms_an_image']:.2f} ms between CUDA events); eval img/s serial "
            f"{rec['img_per_s_bs1']:.2f}, batch {CLS_EVAL_BATCH} {rec[f'img_per_s_bs{CLS_EVAL_BATCH}']:.2f}  [{smi}]")
        del model
    # card vs CPU on seeded random weights (flax's default init): the last.pt
    # of a four-step run saturates its softmax in eval mode (BatchNorm's
    # running statistics have barely moved), which would hide a difference
    c = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(
        yaml_path, [*roots, "--trainer.accelerator=gpu", "--inference.ckpt_path=null"]))
    card, cpu = (c.create_inference_model(device=where) for where in (dev, "cpu"))
    got, want = card(raw).probs, cpu(raw).probs
    err = float(np.abs(got - want).max())
    # W32's logits on random weights reach a scale where the softmax is one-hot,
    # so the logits themselves are held too (rel 1e-3, the main path's rule)
    x = card.to_device(card.transform.inference(raw)[None])
    with torch.no_grad():
        logits_card, logits_cpu = card.model(prep_images(x)).cpu(), cpu.model(prep_images(x.cpu()))
    logits_rel = float((logits_card - logits_cpu).abs().max() / logits_cpu.abs().max())
    speed["float32"].update(probs_card_vs_cpu_abs=err, probs_top=float(want.max()),
                            logits_card_vs_cpu_rel=logits_rel,
                            logits_abs_max=float(logits_cpu.abs().max()))
    if not (err <= 1e-5 and logits_rel <= 1e-3):  # NaN fails too
        raise AssertionError(f"classification inference float32 card vs CPU: probabilities {err}, "
                             f"logits {logits_rel}")
    log(f"classification inference float32, seeded random weights: card == CPU probabilities within "
        f"{err:.3g} (the top one {float(want.max()):.4g}), logits within {logits_rel:.3g} of their "
        f"largest ({float(logits_cpu.abs().max()):.4g})")
    del card, cpu
    out["inference"] = speed

    # the two-stage hand-off
    kcfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / TRAIN_YAML), []))
    net = kcfg.create_net(device=dev)
    loaded = checkpoint.load_params_partial(net, last)
    saved = checkpoint.load_checkpoint(last)["module"]["model"]
    backbone = [n for n, _ in net.named_parameters() if n.startswith("backbone.")]
    differ = [n for n, p in net.named_parameters()
              if n.startswith("backbone.") and not torch.equal(p.detach().cpu(), saved[n])]
    if loaded != len(backbone) or differ:
        raise AssertionError(f"classification last.pt into HigherHRNet-W32: {loaded} loaded of "
                             f"{len(backbone)} backbone tensors, {len(differ)} differ")
    out["handoff"] = {"loaded": loaded, "backbone_tensors": len(backbone),
                      "higher_hrnet_tensors": sum(1 for _ in net.parameters())}
    log(f"classification last.pt as HigherHRNet-W32's pretrained weights: {out['handoff']}")
    return out


def classification_phase(dev, counted, smi: str) -> dict:
    """Phase 12: ImageNet classification on the card. (1) the reduced step
    card vs CPU at each of ``CLS_REDUCED_BATCHES``
    (``classification_step_card_vs_cpu``); (2) W32 from
    ``CLS_YAML`` at its published point in float32 and bfloat16
    (``classification_steps``); (3) the synthesized ImageFolder through the
    loader and the three classification CLIs, the inference model and the
    hand-off to HigherHRNet (``classification_cli``). All of it with every
    kernel's launch counter zeroed before; after, the decode's and the
    convolution's required at 0 (none lies on the classification path), the
    BatchNorm backward pair's recorded (its bfloat16 steps launch it)."""
    import tempfile

    out = {"card": smi}

    def run():
        out["card_vs_cpu"] = {b: classification_step_card_vs_cpu(dev, b) for b in CLS_REDUCED_BATCHES}
        out["steps"] = classification_steps(dev, smi)
        with tempfile.TemporaryDirectory() as tmp:
            out.update(classification_cli(dev, Path(tmp), smi))

    t0 = time.perf_counter()
    _, out["launches"] = counted(run, "phase 12 (classification: reduced card vs CPU, W32 float32 and "
                                      "bfloat16 steps, the CLIs, inference, the hand-off)", {})
    out["seconds"] = time.perf_counter() - t0
    return out


def classification_only(dev, smi: str) -> int:
    """Phase 12 alone: no decode kernel is built (none lies on the
    classification path; their launch counters are still required to stay
    at 0). Prints the phase's record as one JSON object last."""
    counted = make_counted(kernel_counters())
    print(json.dumps({"classification": classification_phase(dev, counted, smi)}), flush=True)
    return 0


# the serving phase (phase 13): W32 from the keypoints yaml (seeded weights)
# behind the port's predictor, batcher and HTTP server; bench_serve's point
# for the closed-loop load
SERVE_BATCHES = (1, 3, 5, 16)  # predict sizes held to one launch of each decode kernel
SERVE_MAX_BATCH = 16
SERVE_LOAD = {"concurrency": 16, "requests": 8, "max_wait_ms": 5.0}
SERVE_CLS_BATCHES = (1, 5)
SERVE_CLS_RAW_HW = (375, 500)
# a batched payload against the same request alone: JAX's serving test's
# tolerances (tests/test_serving.py: coordinates within 0.05, scores within
# 5e-3) held on the medians over every joint and person, with the same
# person count an image. On random W32 weights the heatmaps reach the
# hundreds and 30 persons an image crowd the grouping, so a few near-tied
# assignments flip with the convolutions' summation order (the batch size
# changes cuDNN's algorithm); in bfloat16 (8-bit activations) most do, so
# bfloat16 holds the person counts and the exact padding check
# (``padding_exact``), and the trained C=8 fixture's card test
# (test_serving_batched_decides_as_single_on_card) its decisions
SERVE_XY_TOL, SERVE_SCORE_TOL = 0.05, 5e-3


def payload_stats(got: list, want: list) -> dict:
    """Keypoints payloads against others of the same images: images whose
    person counts differ, then over the joints (persons) of the images that
    agree the median and largest joint x, y difference, the share of joints
    past ``SERVE_XY_TOL``, the largest joint score difference and the median
    and largest person score difference."""
    xy, joint_score, score = [], [], []
    differ = 0
    for g, w in zip(got, want):
        if g["num_people"] != w["num_people"]:
            differ += 1
            continue
        if g["num_people"]:
            gk = np.asarray([p["keypoints"] for p in g["people"]], np.float64)
            wk = np.asarray([p["keypoints"] for p in w["people"]], np.float64)
            xy.append(np.abs(gk[..., :2] - wk[..., :2]).max(-1).ravel())
            joint_score.append(np.abs(gk[..., 2] - wk[..., 2]).ravel())
            score.append(np.abs([a["score"] - b["score"] for a, b in zip(g["people"], w["people"])]))
    xy, joint_score, score = (np.concatenate(a) if a else np.zeros(0) for a in (xy, joint_score, score))
    return {"images": len(got), "people_differ": differ, "people": sum(g["num_people"] for g in got),
            "median_xy": float(np.median(xy)) if xy.size else 0.0, "max_xy": float(xy.max(initial=0.0)),
            "share_xy_past_tol": float((xy > SERVE_XY_TOL).mean()) if xy.size else 0.0,
            "max_joint_score": float(joint_score.max(initial=0.0)),
            "median_score": float(np.median(score)) if score.size else 0.0,
            "max_score": float(score.max(initial=0.0))}


def payloads_agree(stats: dict) -> bool:
    return (stats["people_differ"] == 0 and stats["median_xy"] <= SERVE_XY_TOL
            and stats["median_score"] <= SERVE_SCORE_TOL)


def decisions_gap(a, b) -> dict:
    """Decode outputs ``(joints, scores, valid)`` of the same images against
    each other at the level of decisions: person counts an image, the median
    and largest joint x, y difference and the largest sorted person score
    difference where the counts agree."""
    (ja, sa, va), (jb, sb, vb) = [[t.cpu().numpy() for t in x] for x in (a, b)]
    out = {"persons": (va.sum(1).tolist(), vb.sum(1).tolist()), "median_xy": 0.0, "max_xy": 0.0,
           "score": 0.0}
    xy = [np.abs(ja[i][va[i]][..., :2] - jb[i][vb[i]][..., :2]).ravel()
          for i in range(len(va)) if va[i].sum() == vb[i].sum()]
    xy = np.concatenate(xy) if xy else np.zeros(0)
    if xy.size:
        out["median_xy"], out["max_xy"] = float(np.median(xy)), float(xy.max())
    out["score"] = max([float(np.abs(np.sort(sa[i][va[i]]) - np.sort(sb[i][vb[i]])).max(initial=0.0))
                        for i in range(len(va)) if va[i].sum() == vb[i].sum()], default=0.0)
    return out


def http_json(url: str, body: bytes | None = None) -> tuple:
    """(status, parsed JSON or text) of a GET, or of a POST of ``body``;
    an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    try:
        return status, json.loads(text)
    except json.JSONDecodeError:
        return status, text


def npy_bytes(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def jpeg_bytes(rgb: np.ndarray) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    if not ok:
        raise AssertionError("cv2 could not encode a jpeg")
    return enc.tobytes()


def serve_models(dev) -> dict:
    """The keypoints yaml's W32 through the port's config with seeded
    weights, ``{"float32": ..., "bfloat16": ...}`` inference models on the
    card (the yaml's accelerator "tpu" means bfloat16)."""
    from human_pose_tpu_torch.configs import KeypointsConfig

    yaml_path = str(Path(__file__).resolve().parent / EVAL_YAML)
    models = {}
    for dtype, argv in (("float32", ["--trainer.accelerator=gpu"]), ("bfloat16", [])):
        cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
            yaml_path, ["--inference.ckpt_path=null", *argv]))
        models[dtype] = cfg.create_inference_model()
        if str(models[dtype].dtype) != f"torch.{dtype}" or models[dtype].device != dev:
            raise AssertionError(f"serve: {dtype} model is {models[dtype].dtype} on {models[dtype].device}")
    return models


def serve_predictor_checks(models: dict, counted, raws: list) -> dict:
    """(1) ``BatchedKeypointsPredictor`` in each dtype: warm-up of every
    batch bucket up to ``SERVE_MAX_BATCH`` for one 480x640 shape, then each
    predict of ``SERVE_BATCHES`` requests with one launch of the dense
    refine and of the grouping, its payloads against each request's payload
    alone (``payload_stats``; float32 held by ``payloads_agree``, bfloat16
    on its person counts, see ``SERVE_XY_TOL``); ``padding_exact``; the
    largest batch's forward against each image's alone (float32 within rel
    1e-3); host ms of a predict by size."""
    import torch

    from human_pose_tpu_torch.inference import BatchedKeypointsPredictor

    out = {}
    for dtype, im in models.items():
        pred = BatchedKeypointsPredictor(im)
        t0 = time.perf_counter()
        pred.warmup(raws[0], SERVE_MAX_BATCH)
        torch.cuda.synchronize()
        rec = {"warmup_s": time.perf_counter() - t0, "launches": {}, "gaps": {}, "predict_ms": {}}
        reqs = [pred.prepare(r) for r in raws]
        rec["key"] = str(reqs[0].key)
        singles = [pred.predict([q])[0] for q in reqs]
        rec["people_alone"] = [s["num_people"] for s in singles]
        rec["repeat_equal"] = pred.predict(reqs[:1]) == singles[:1]
        for n in SERVE_BATCHES:
            payloads, rec["launches"][n] = counted(
                lambda: pred.predict(reqs[:n]), f"serve predict {dtype} of {n} (padded to "
                f"{1 << (n - 1).bit_length()})", {"match_by_tag": 1, "refine_argmax": 1})
            rec["gaps"][n] = payload_stats(payloads, singles[:n])
            log(f"serve {dtype}: predict of {n} against each request alone: {rec['gaps'][n]}")
            held = (payloads_agree(rec["gaps"][n]) if dtype == "float32"
                    else rec["gaps"][n]["people_differ"] == 0)
            if not held:
                raise AssertionError(f"serve {dtype}: batched predict of {n} differs from single "
                                     f"requests: {rec['gaps'][n]}")
            rec["predict_ms"][n] = host_ms(lambda: pred.predict(reqs[:n]), iters=3)
        rec["padding_exact"] = padding_exact(pred, reqs)
        if dtype == "float32":
            rec["repeat"] = repeat_readings(pred, reqs[0], yaml_cudnn())
            log(f"serve float32: one predict repeated {SERVE_REPEATS}x by cuDNN setting: "
                + "; ".join(f"{k}: payload equal {r['payload_bit_equal']}, forward equal "
                            f"{r['forward_bit_equal']} (max diff {r['forward_max_abs_diff']:.3g}), "
                            f"largest joint gap {max(g['max_xy'] for g in r['payload_gaps']):.4g} px"
                            for k, r in rec["repeat"].items()))
            det = rec["repeat"]["deterministic"]
            if not (det["forward_bit_equal"] and det["payload_bit_equal"]):
                raise AssertionError(f"serve float32: one predict repeated with cuDNN deterministic "
                                     f"is not bit-equal: {det}")
        rec["kernels"] = path_kernel_times(lambda: pred.predict(reqs))
        log(f"serve {dtype} kernels (predict of {len(reqs)}): {rec['kernels']}")
        # the forward of the largest padded batch against each image alone
        x = im.to_device(np.concatenate([q.x for q in reqs]))
        hw = tuple(x.shape[2:])
        avg, tags = im.forward_scale(x, hw)
        rel = 0.0
        for i in range(len(reqs)):
            a1, t1 = im.forward_scale(x[i:i + 1], hw)
            for got, want in ((avg[i], a1[0]), (tags[0][i], t1[0][0])):
                rel = max(rel, float((got - want).abs().max() / want.abs().max().clamp(min=1e-3)))
        rec["forward_batch_vs_single_rel"] = rel
        if dtype == "float32" and rel > 1e-3:
            raise AssertionError(f"serve float32: batch-{len(reqs)} forward vs single rel {rel}")
        log(f"serve {dtype}: warm-up {rec['warmup_s']:.1f}s, persons alone {rec['people_alone']}, "
            f"predict host ms by size {rec['predict_ms']}, batch-{len(reqs)} forward vs single rel "
            f"{rel:.3g}, a single request repeated equal: {rec['repeat_equal']}; padded rows change "
            f"no payload: {rec['padding_exact']}")
        out[dtype] = rec
    return out


SERVE_REPEATS = 3  # repeats of one float32 predict under each cuDNN setting


def repeat_readings(pred, req, yaml_cudnn: tuple, n: int = SERVE_REPEATS) -> dict:
    """One predict of ``req`` and the forward of its input repeated ``n``
    times under each cuDNN setting (deterministic, benchmark): cuDNN's
    deterministic algorithms with benchmark off, the yaml's ``cudnn``
    section (``yaml_cudnn``), and PyTorch's defaults (neither); for each,
    whether every repeat equals the first bit for bit (payload and forward
    maps), the largest forward difference and ``payload_stats`` of the
    repeats against the first. cuDNN's switches are restored."""
    import torch

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    im = pred.m
    x = im.to_device(req.x)
    hw = tuple(x.shape[2:])
    out = {}
    try:
        for what, (det, bench) in (("deterministic", (True, False)), ("yaml", yaml_cudnn),
                                   ("torch_default", (False, False))):
            cudnn.deterministic, cudnn.benchmark = det, bench
            payloads = [pred.predict([req]) for _ in range(n)]
            maps = [torch.cat([a.flatten() for a in (avg, *tags)])
                    for avg, tags in (im.forward_scale(x, hw) for _ in range(n))]
            out[what] = {
                "deterministic": det, "benchmark": bench,
                "payload_bit_equal": all(p == payloads[0] for p in payloads[1:]),
                "forward_bit_equal": all(torch.equal(m, maps[0]) for m in maps[1:]),
                "forward_max_abs_diff": max(float((m - maps[0]).abs().max()) for m in maps[1:]),
                "payload_gaps": [payload_stats(p, payloads[0]) for p in payloads[1:]]}
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    return out


def yaml_cudnn() -> tuple:
    """(deterministic, benchmark) as ``apply_cudnn`` sets them from the
    keypoints yaml."""
    from human_pose_tpu_torch.configs import KeypointsConfig

    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / EVAL_YAML), []))
    return cfg.cudnn.deterministic or cfg.setup.deterministic, cfg.cudnn.benchmark


def padding_exact(pred, reqs: list) -> list:
    """The zero images that pad a batch to a power of two change no real
    request's payload: a predict of ``n`` requests (padded) equals, request
    by request, a predict of the same requests followed by real ones up to
    the same power of two (one batch shape, so one cuDNN algorithm), with
    cuDNN's deterministic algorithms. Raises on a miss; returns the (n,
    batch) pairs held."""
    import torch

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    held = []
    cudnn.deterministic = True
    try:
        for n in (3, 5):
            full = 1 << (n - 1).bit_length()
            if full > len(reqs):
                continue
            padded, real = pred.predict(reqs[:n]), pred.predict(reqs[:full])[:n]
            if padded != real:
                raise AssertionError(f"serve: the pad rows of a batch of {n} changed a payload")
            held.append((n, full))
    finally:
        cudnn.deterministic = saved
    return held


def serve_load(net, dev, counted, smi: str) -> dict:
    """(2) ``DynamicBatcher`` under bench_serve's closed-loop load (its W32
    weights and images, bfloat16, ``SERVE_LOAD``, max batch
    ``SERVE_MAX_BATCH``), plain and with compact inputs: p50/p95/p99,
    requests a second, mean batch size; one launch of each decode kernel a
    device batch; the device's busy and idle share over a profiled load."""
    import torch

    from human_pose_tpu_torch.bin.bench_serve import closed_loop
    from human_pose_tpu_torch.inference import (
        BatchedKeypointsPredictor, DynamicBatcher, InferenceKeypointsModel,
    )

    rs = np.random.RandomState(0)  # bench_serve's images
    images = [(rs.rand(SIZE, SIZE, 3) * 255).astype(np.uint8) for _ in range(4)]
    n_req = SERVE_LOAD["concurrency"] * SERVE_LOAD["requests"]
    out = {"card": smi, **SERVE_LOAD, "input_size": SIZE, "max_batch": SERVE_MAX_BATCH}
    for compact in (False, True):
        im = InferenceKeypointsModel(net, input_size=SIZE, max_num_people=30, compact_inputs=compact,
                                     dtype=torch.bfloat16, device=dev)
        pred = BatchedKeypointsPredictor(im)
        pred.warmup(images[0], SERVE_MAX_BATCH)
        runs = []

        def load():
            batcher = DynamicBatcher(pred, max_batch=SERVE_MAX_BATCH,
                                     max_wait_ms=SERVE_LOAD["max_wait_ms"])
            try:
                lat, wall = closed_loop(batcher, images, SERVE_LOAD["concurrency"],
                                        SERVE_LOAD["requests"])
            finally:
                batcher.close()
            if len(lat) != n_req or batcher.stats()["errors"]:
                raise AssertionError(f"serve load: {len(lat)} of {n_req} answered, "
                                     f"stats {batcher.stats()}")
            runs.append((lat, wall, batcher.stats()))

        # two loads: the profiler's warm-up (timed) and the profiled one
        (busy, groups), launches = counted(
            lambda: profile_breakdown(load), f"serve load ({'compact' if compact else 'plain'}, twice)",
            lambda _: {"match_by_tag": sum(r[2]["batches"] for r in runs),
                       "refine_argmax": sum(r[2]["batches"] for r in runs)})
        (lat, wall, stats), profiled = runs[0], runs[-1]
        batches = sum(r[2]["batches"] for r in runs)
        rec = {"p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)), "max_ms": float(lat[-1]),
               "throughput_rps": n_req / wall, "mean_batch_size": stats["mean_batch_size"],
               "wall_s": wall, "batches": stats["batches"], "launches": launches,
               "launches_a_batch": {k: v / batches for k, v in launches.items() if v},
               "profiled_wall_s": profiled[1], "profiled_batches": profiled[2]["batches"],
               "busy_ms": busy, "busy_groups_ms": groups,
               "idle_share": None if busy is None else max(0.0, 1 - busy / (profiled[1] * 1e3))}
        out["compact" if compact else "plain"] = rec
        log(f"serve load ({'compact uint8' if compact else 'float32'} inputs, bf16 W32, "
            f"{SERVE_LOAD['concurrency']}x{SERVE_LOAD['requests']}): p50 {rec['p50_ms']:.2f} "
            f"p95 {rec['p95_ms']:.2f} p99 {rec['p99_ms']:.2f} ms, {rec['throughput_rps']:.2f} req/s, "
            f"mean batch {rec['mean_batch_size']}, {stats['batches']} batches, launches a batch "
            f"{rec['launches_a_batch']}; profiled load: busy {busy} ms of {profiled[1] * 1e3:.1f} ms "
            f"wall (idle share {rec['idle_share']})  [{smi}]")
    return out


def serve_http(models: dict, cls_model, raws: list) -> dict:
    """(3) ``make_server`` on 127.0.0.1, a free port, in a thread: a JPEG
    and an ``.npy`` POST to /predict, /healthz (platform "gpu"), /stats,
    /metrics, a 413 past the body limit; the classification server's POST;
    ``close`` with no thread left running."""
    import threading

    from human_pose_tpu_torch.inference import (
        BatchedClassificationPredictor, BatchedKeypointsPredictor, DynamicBatcher, make_server,
    )

    out = {}
    for task, pred in (("keypoints", BatchedKeypointsPredictor(models["bfloat16"])),
                       ("classification", BatchedClassificationPredictor(cls_model))):
        batcher = DynamicBatcher(pred, max_batch=4, max_wait_ms=2.0)
        servers = [make_server(batcher, host="127.0.0.1", port=0),
                   make_server(batcher, host="127.0.0.1", port=0, max_body_bytes=1024)]
        threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
        for t in threads:
            t.start()
        url = f"http://127.0.0.1:{servers[0].server_address[1]}"
        rec = {}
        try:
            for kind, body in (("jpeg", jpeg_bytes(raws[1])), ("npy", npy_bytes(raws[2]))):
                t0 = time.perf_counter()
                status, payload = http_json(f"{url}/predict", body)
                rec[kind] = {"status": status, "ms": (time.perf_counter() - t0) * 1e3,
                             "bytes": len(body)}
                want_key = "num_people" if task == "keypoints" else "top"
                if status != 200 or want_key not in payload:
                    raise AssertionError(f"serve http {task} {kind}: {status} {payload}")
                rec[kind][want_key] = payload[want_key] if task == "keypoints" else payload["pred"]
            rec["healthz"] = http_json(f"{url}/healthz")
            rec["stats"] = http_json(f"{url}/stats")
            status, metrics = http_json(f"{url}/metrics")
            rec["over_limit"] = http_json(
                f"http://127.0.0.1:{servers[1].server_address[1]}/predict", b"x" * 2048)[0]
            if (rec["healthz"] != (200, {"status": "ok", "platform": "gpu"})
                    or rec["stats"][0] != 200 or rec["stats"][1]["requests"] != 2
                    or status != 200 or "serving_requests_total 2" not in metrics
                    or rec["over_limit"] != 413):
                raise AssertionError(f"serve http {task}: {rec}, metrics {status} {metrics!r}")
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()
            batcher.close()
        for t in [*threads, batcher._worker]:
            t.join(timeout=5)
        if any(t.is_alive() for t in [*threads, batcher._worker]):
            raise AssertionError(f"serve http {task}: a thread still runs after close()")
        out[task] = rec
        log(f"serve http {task}: {rec}")
    return out


def serve_classification(cls_model, counted, rng) -> dict:
    """(4) ``BatchedClassificationPredictor`` on ClassificationHRNet-W32 in
    float32 at batch sizes ``SERVE_CLS_BATCHES``: each request's top-5 and
    their probabilities against ``InferenceClassificationModel.__call__``'s
    (the top label equal, rel 1e-3 above the payload's 6-decimal rounding);
    no kernel launched."""
    from human_pose_tpu_torch.inference import BatchedClassificationPredictor

    pred = BatchedClassificationPredictor(cls_model)
    raws = [rng.integers(0, 256, (*SERVE_CLS_RAW_HW, 3), dtype=np.uint8)
            for _ in range(max(SERVE_CLS_BATCHES))]
    calls = [cls_model(r).probs for r in raws]
    out = {"rel_err": {}}
    for n in SERVE_CLS_BATCHES:
        payloads, out[f"launches_{n}"] = counted(
            lambda: pred.predict([pred.prepare(r) for r in raws[:n]]),
            f"serve classification predict of {n}", {})
        worst = 0.0
        for payload, probs in zip(payloads, calls):
            order = np.argsort(-probs, kind="stable")
            if payload["pred"] != cls_model.labels[int(order[0])] or len(payload["top"]) != 5:
                raise AssertionError(f"serve classification of {n}: {payload} vs top "
                                     f"{order[:5].tolist()}")
            for t in payload["top"]:
                want = float(probs[cls_model.labels.index(t["label"])])
                gap = abs(t["prob"] - want) - 5e-7
                worst = max(worst, gap / max(want, 1e-30))
                if gap > 1e-3 * want:
                    raise AssertionError(f"serve classification of {n}: {t} vs __call__'s {want}")
        out["rel_err"][n] = max(worst, 0.0)
    log(f"serve classification (W32 float32): predict of {SERVE_CLS_BATCHES} == __call__'s top-5 "
        f"(rel {out['rel_err']}); top-1 of the first {payloads[0]['top'][0]}")
    return out


def serve_clis(raws: list, bench_argv: tuple = (), serve_argv: tuple = ()) -> dict:
    """(5) ``bin.bench_serve`` as a process at ``SERVE_LOAD`` (its W32 in
    bfloat16, max batch ``SERVE_MAX_BATCH``) with its JSON line parsed;
    ``bin.serve`` as a process on the keypoints yaml (seeded weights, a
    warm-up of the 480x640 shape): one POST answered, exit 0 on SIGTERM.
    ``bench_argv`` and ``serve_argv`` are appended to each command line."""
    import signal

    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(here)}
    n_req = SERVE_LOAD["concurrency"] * SERVE_LOAD["requests"]
    t0 = time.perf_counter()
    res = subprocess.run([
        sys.executable, "-m", "human_pose_tpu_torch.bin.bench_serve",
        f"--concurrency={SERVE_LOAD['concurrency']}", f"--requests={SERVE_LOAD['requests']}",
        f"--input_size={SIZE}", f"--max_batch={SERVE_MAX_BATCH}",
        f"--max_wait_ms={SERVE_LOAD['max_wait_ms']}", *bench_argv],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"bench_serve exited {res.returncode}: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    bench = json.loads(res.stdout.strip().splitlines()[-1])
    bench["seconds"] = time.perf_counter() - t0
    if bench["requests"] != n_req or bench["platform"] != "gpu" or not bench["throughput_rps"] > 0:
        raise AssertionError(f"bench_serve: {bench}")
    log(f"bin.bench_serve (process): {bench}")

    h, w = INFER_RAW_HW
    argv = [sys.executable, "-m", "human_pose_tpu_torch.bin.serve", f"--config={here / EVAL_YAML}",
            "--inference.ckpt_path=null", "--host=127.0.0.1", "--port=0", f"--warmup={h}x{w}",
            "--max_batch=1", *serve_argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, serve = [], {}
    try:
        port = None
        while port is None:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"bin.serve ended before listening: {''.join(lines)[-3000:]}")
            lines.append(line)
            if "serving keypoints on 127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split()[0])
        serve["ready_s"] = time.perf_counter() - t0
        status, payload = http_json(f"http://127.0.0.1:{port}/predict", jpeg_bytes(raws[3]))
        if status != 200 or "num_people" not in payload:
            raise AssertionError(f"bin.serve POST: {status} {payload}")
        serve["num_people"], serve["latency_ms"] = payload["num_people"], payload["latency_ms"]
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        serve["exit_code"] = proc.returncode
        if proc.returncode != 0 or "SIGTERM: shutting down server" not in rest:
            raise AssertionError(f"bin.serve after SIGTERM: exit {proc.returncode}: {rest[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    log(f"bin.serve (process): listening after {serve['ready_s']:.1f}s with the warm-up, one POST "
        f"({serve['num_people']} persons, {serve['latency_ms']} ms), exit 0 on SIGTERM")
    return {"bench_serve": bench, "serve": serve}


def serve_export(dev, im, rng, tmp: Path) -> dict:
    """(6) ``bin.export.main`` on the keypoints yaml in its dtype (bfloat16;
    the float32 program's round trip is the card test
    test_export_program_round_trip_on_card): the ``.pt2`` loaded on the
    card against the inference model ``im``'s forward at the level of
    decisions after the decode (``decisions_gap``); the ``.weights.npz``
    through ``load_flax_npz`` into a new W32, strictly, the state dict
    bit-equal; file sizes and seconds."""
    import torch

    from human_pose_tpu_torch.bin import export as export_cli
    from human_pose_tpu_torch.models import HigherHRNet
    from human_pose_tpu_torch.ops import decode_batch
    from human_pose_tpu_torch.utils import load_flax_npz

    yaml_path = str(Path(__file__).resolve().parent / EVAL_YAML)
    x = torch.from_numpy(rng.standard_normal((1, 3, SIZE, SIZE), dtype=np.float32)).to(dev)
    t0 = time.perf_counter()
    program, npz = export_cli.main([f"--config={yaml_path}", "--inference.ckpt_path=null",
                                    f"--out={tmp}"])
    rec = {"dtype": str(im.dtype), "seconds": time.perf_counter() - t0,
           "pt2_mb": program.stat().st_size / 2**20, "npz_mb": npz.stat().st_size / 2**20}
    t0 = time.perf_counter()
    loaded = torch.export.load(str(program)).module()
    rec["load_s"] = time.perf_counter() - t0
    with torch.no_grad():
        hms_p, tags_p = loaded(x)
        hms_m, tags_m = im._forward(x)
    pairs = list(zip([*hms_p, tags_p], [*hms_m, tags_m]))
    if any(a.dtype != torch.float32 or a.shape != b.shape for a, b in pairs):
        raise AssertionError(f"export: program outputs {[(a.dtype, a.shape) for a, _ in pairs]}")
    rec["bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
    rec["max_rel_err"] = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-3)) for a, b in pairs)
    rec["decisions"] = decisions_gap(*[
        decode_batch(list(h), [t], (SIZE, SIZE), max_num_people=M, det_thr=DET_THR, tag_thr=TAG_THR)
        for h, t in ((hms_p, tags_p), (hms_m, tags_m))])
    d = rec["decisions"]
    if d["persons"][0] != d["persons"][1] or d["median_xy"] >= 0.5 or d["score"] >= 0.05:
        raise AssertionError(f"export: program vs module decisions {d}")
    net = HigherHRNet(num_kpts=K, C=32, device=dev)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in load_flax_npz(npz).items()}, strict=True)
    want = im.model.state_dict()
    if net.state_dict().keys() != want.keys() or not all(
            torch.equal(v, want[k]) for k, v in net.state_dict().items()):
        raise AssertionError("export: the npz's W32 differs from the exported model")
    log(f"export ({rec['dtype']}): {program.name} {rec['pt2_mb']:.1f} MB, {npz.name} {rec['npz_mb']:.1f} "
        f"MB in {rec['seconds']:.1f}s (load {rec['load_s']:.1f}s); program vs module: bit-equal "
        f"{rec['bit_equal']}, rel {rec['max_rel_err']:.3g}, decisions {d}; npz -> new W32 strict, "
        "state dict bit-equal")
    return rec


def serve_phase(dev, counted, smi: str) -> dict:
    """Phase 13: serving and export through the port's entry points, W32
    from ``EVAL_YAML`` with seeded weights (``init_flax_default_``):
    ``serve_predictor_checks`` (1), ``serve_load`` (2), ``serve_http`` (3),
    ``serve_classification`` (4) on ClassificationHRNet-W32 from
    ``CLS_YAML``, ``serve_clis`` (5), ``serve_export`` (6), and model info
    (7): the two W32s' parameter counts and ``model_cost`` of HigherHRNet-W32
    at 512^2, batch 1. Raises on any miss; returns the phase's record."""
    import tempfile

    from human_pose_tpu_torch.configs import ClassificationConfig
    from human_pose_tpu_torch.utils import count_params, model_cost

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    out = {"card": smi}
    models = serve_models(dev)
    cfg = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / CLS_YAML),
        ["--inference.ckpt_path=null", "--trainer.accelerator=gpu"]))
    cls_model = cfg.create_inference_model()
    out["params"] = {"HigherHRNet-W32": count_params(models["float32"].model),
                     "ClassificationHRNet-W32": count_params(cls_model.model)}
    if out["params"] != {"HigherHRNet-W32": W32_PARAMS, "ClassificationHRNet-W32": CLS_PARAMS}:
        raise AssertionError(f"serve: parameter counts {out['params']}")
    raws = [rng.integers(0, 256, (*INFER_RAW_HW, 3), dtype=np.uint8) for _ in range(max(SERVE_BATCHES))]
    out["predictor"] = serve_predictor_checks(models, counted, raws)
    out["launches"] = out["predictor"]["bfloat16"]["launches"][max(SERVE_BATCHES)]
    out["load"] = serve_load(models["bfloat16"].model, dev, counted, smi)
    out["http"] = serve_http(models, cls_model, raws)
    out["classification"] = serve_classification(cls_model, counted, rng)
    out["clis"] = serve_clis(raws)
    with tempfile.TemporaryDirectory() as tmp:
        out["export"] = serve_export(dev, models["bfloat16"], rng, Path(tmp))
    t0 = time.perf_counter()
    out["model_cost"] = model_cost(models["float32"].model, (3, SIZE, SIZE), batch=1)
    out["model_cost"]["seconds"] = time.perf_counter() - t0
    log(f"model info: {out['params']}; model_cost of HigherHRNet-W32 at {SIZE}^2 bs1: {out['model_cost']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 (serving and export): {out['seconds']:.1f}s")
    return out


def serve_only(dev, smi: str) -> int:
    """Phase 13 alone: build the dense refine and the grouping, then the
    serving and export phase. Prints the phase's record as one JSON object
    last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"serve": serve_phase(dev, counted, smi)}), flush=True)
    return 0


# phase 14, the model zoo: each network at full width (the JAX package's
# defaults; depth not cut), seeded with init_flax_default_
ZOO_NETS = {
    "AEHourglassNet": ("AEHourglassNet", {"num_kpts": K, "num_stages": 2}, 6_795_396),
    "HourglassNet": ("HourglassNet", {"num_kpts": 16, "num_stages": 2}, 6_785_632),
    "SimpleBaseline-R50": ("SimpleBaseline", {"num_kpts": K, "backbone": "resnet50"}, 33_999_697),
    "HRNetSPPE-W32": ("HRNetSPPE", {"num_keypoints": K, "C": 32}, 28_536_113),
}
ZOO_FORWARD_HW = 128  # the card-vs-CPU forward's input: full width, an image the CPU runs fast
ZOO_SPPE_ARCHS = {"SimpleBaseline-R50": "SimpleBaseline", "HRNetSPPE-W32": "HRNet"}
ZOO_CALLS = 5  # timed __call__s an SPPE model and dtype, after the warm-up


def torchvision_resnet_state_dict(variant: str, rng, num_classes: int = 1000) -> dict:
    """A seeded state dict in torchvision's ResNet layout (``conv1``,
    ``bn1``, ``layer{L}.{i}.conv{j}`` / ``.bn{j}``, ``.downsample.{0,1}``,
    ``fc``, with ``num_batches_tracked``), named and shaped from
    torchvision's scheme, not from the port's modules."""
    import torch

    from human_pose_tpu_torch.models import RESNET_SPECS

    block, layers = RESNET_SPECS[variant]
    sd = {}

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    def conv(key, o, i, k):
        sd[f"{key}.weight"] = randn(o, i, k, k) / float(np.sqrt(i * k * k))

    def bn(key, c):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + 0.1 * randn(c), 0.1 * randn(c)
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = 0.1 * randn(c), 0.5 + randn(c).abs()
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for L, (width, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
        for i in range(n):
            stride, base = (2 if i == 0 and L > 1 else 1), f"layer{L}.{i}"
            widths = [width, width] if block == "basic" else [width, width, 4 * width]
            for j, (w, k) in enumerate(zip(widths, (3, 3) if block == "basic" else (1, 3, 1)), 1):
                conv(f"{base}.conv{j}", w, cin if j == 1 else widths[j - 2], k)
                bn(f"{base}.bn{j}", w)
            if stride != 1 or cin != widths[-1]:
                conv(f"{base}.downsample.0", widths[-1], cin, 1)
                bn(f"{base}.downsample.1", widths[-1])
            cin = widths[-1]
    sd["fc.weight"], sd["fc.bias"] = 0.05 * randn(num_classes, cin), torch.zeros(num_classes)
    return sd


def _outputs(out) -> list:
    return [t for o in out for t in _outputs(o)] if isinstance(out, (list, tuple)) else [out]


def zoo_forwards(dev, rng) -> tuple:
    """(1) Each zoo network at full width on the card, float32, seeded with
    ``init_flax_default_``: its parameter count, and its forward of one
    seeded ``ZOO_FORWARD_HW``^2 image against the same weights on the CPU
    (through ``state_dict``) within rel 1e-3 of each output's scale, as the
    W32 forward. Returns (record, {name: card net}, {name: card outputs})."""
    import torch

    from human_pose_tpu_torch import models
    from human_pose_tpu_torch.utils import count_params

    x = torch.from_numpy(rng.standard_normal((1, 3, ZOO_FORWARD_HW, ZOO_FORWARD_HW), dtype=np.float32))
    rec, nets, outs = {}, {}, {}
    for name, (cls, kw, params) in ZOO_NETS.items():
        t0 = time.perf_counter()
        net = getattr(models, cls)(**kw, device=dev)
        models.init_flax_default_(net, torch.Generator().manual_seed(SEED)).eval()
        cpu = getattr(models, cls)(**kw, device="cpu").eval()
        cpu.load_state_dict(net.state_dict())
        with torch.no_grad():
            got, want = _outputs(net(x.to(dev))), _outputs(cpu(x))
        rel = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-3))
                  for g, w in zip(got, want))
        n = count_params(net)
        if n != params or len(got) != len(want) or rel > 1e-3:
            raise AssertionError(f"zoo {name}: {n} parameters (want {params}), card fp32 forward "
                                 f"vs CPU max rel err {rel}")
        rec[name] = {"params": n, "outputs": [tuple(g.shape) for g in got], "forward_rel_err": rel,
                     "seconds": time.perf_counter() - t0}
        log(f"zoo {name}: {n} parameters; card fp32 forward == CPU on a {ZOO_FORWARD_HW}^2 image "
            f"(outputs {rec[name]['outputs']}, max rel err {rel:.3g} <= 1e-3)")
        nets[name], outs[name] = net, got
    return rec, nets, outs


def zoo_sppe_parse(dev, outs: dict) -> dict:
    """(2) ``sppe_parse`` on the card == on the CPU, exactly: on the SPPE
    networks' outputs and on a map of ties (an all-equal plane, two equal
    maxima, a tied row and a tied column), whose joints are also the first
    row-major maxima."""
    import torch

    from human_pose_tpu_torch.ops import sppe_parse

    ties = torch.zeros((2, 4, 7, 9))
    ties[0, 1, 4, 1] = ties[0, 1, 1, 5] = 9.0
    ties[1, 2, 2, :] = 9.0
    ties[1, 3, :, 6] = 9.0
    maps = {"ties": ties, **{name: outs[name][0].cpu() for name in ZOO_SPPE_ARCHS}}
    rec = {}
    for name, m in maps.items():
        got, want = sppe_parse(m.to(dev)).cpu(), sppe_parse(m)
        if not torch.equal(got, want):
            raise AssertionError(f"zoo sppe_parse on {name}: card != CPU")
        rec[name] = tuple(m.shape)
    first = torch.tensor([[0.0, 0.0, 0.0], [5.0, 1.0, 9.0]])
    if not torch.equal(sppe_parse(ties)[0, 0, :2], first):
        raise AssertionError("zoo sppe_parse: ties do not go to the first row-major maximum")
    log(f"zoo sppe_parse: card == CPU on {rec}")
    return rec


def zoo_ae_hourglass(net, dev, rng, counted, smi: str) -> dict:
    """(3) ``InferenceKeypointsModel`` on the full-width AE hourglass at
    ``SIZE`` with flip, as phase 6's (b): ``__call__`` on a seeded 480x640
    raw image with exactly one launch of the dense refine and of the
    grouping; each kernel's output on that call's inputs equal to its plain
    version's on the card; both kernels' times and bounds; ms an image of
    the device part (CUDA events) in float32 and bfloat16 and of
    ``__call__`` (host wall)."""
    import torch

    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    kw = dict(det_thr=DET_THR, tag_thr=TAG_THR, max_num_people=M, input_size=SIZE, use_flip=True)
    im = InferenceKeypointsModel(net, device=dev, **kw)
    raw = rng.integers(0, 256, (*INFER_RAW_HW, 3), dtype=np.uint8)
    want = {"match_by_tag": 1, "refine_argmax": 1}
    result, launches = counted(lambda: im(raw), "zoo AE hourglass __call__ (flip, E=2)", want)
    if not (np.isfinite(result.kpts_coords).all() and result.kpts_tags.shape[-1] == 2
            and result.kpts_heatmaps.shape[-1] == K):
        raise AssertionError("zoo AE hourglass: result malformed")
    seen = record_kernel_inputs(lambda: im(raw))
    hm, tg, prev, cnt = seen["refine_argmax"]
    cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
    refine_equal = torch.equal(cuda_decode.refine_argmax_batch(hm, tg, prev, cnt),
                               cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt))
    t0 = time.perf_counter()
    plain = cuda_match.match_by_tag_batched_plain(cand, det_thr, tag_thr, order, persons)
    torch.cuda.synchronize()
    match_plain_ms = (time.perf_counter() - t0) * 1e3
    got = cuda_match.match_by_tag_batched(cand, det_thr, tag_thr, order, persons)
    match_equal = all(torch.equal(a, b) for a, b in zip(got, plain))
    if not (refine_equal and match_equal):
        raise AssertionError(f"zoo AE hourglass: kernel vs plain on the call's inputs: refine "
                             f"{refine_equal}, grouping {match_equal}")
    rec = {"launches": launches, "persons": len(result.kpts_coords),
           "model_input_hw": im.model_input_shape, **path_kernel_times(lambda: im(raw)),
           "refine_plain_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt),
                                      iters=2),
           "match_plain_ms": match_plain_ms, "match_valid_rows": int((cand[..., 2] > DET_THR).sum())}
    xs, hw, valid_hw = infer_inputs(rng, INFER_CONFIGS["b"], dev)
    for dtype in (torch.float32, torch.bfloat16):
        im_t = im if dtype == torch.float32 else InferenceKeypointsModel(net, device=dev, dtype=dtype, **kw)
        fn = lambda: infer_device_part(im_t, xs, hw, valid_hw)  # noqa: E731
        warm_up(lambda: (fn(), torch.cuda.synchronize()), INFER_WARMUP_S)
        rec[f"ms_{str(dtype).split('.')[-1]}"] = cuda_ms(fn, iters=3, warmup=0, reps=3)
    rec["call_host_ms"] = host_ms(lambda: im(raw), iters=3)
    log(f"zoo AE hourglass (flip, {im.model_input_shape}): {rec['persons']} persons, one launch of "
        f"each kernel, each == plain on the call's inputs; refine {rec['refine_ms']:.4f} ms (bound "
        f"{rec['refine_bound_ms']:.4f}, plain {rec['refine_plain_ms']:.2f}), grouping "
        f"{rec['match_ms']:.4f} ms (plain {match_plain_ms:.0f}); an image {rec['ms_float32']:.3f} ms "
        f"float32, {rec['ms_bfloat16']:.3f} bfloat16 (events), __call__ {rec['call_host_ms']:.3f} "
        f"ms host wall  [{smi}]")
    return rec


def zoo_sppe_inference(nets: dict, dev, rng, counted, smi: str) -> dict:
    """(4) ``InferenceSPPEModel`` from the port's config (the architecture's
    default ``net.params``, float32 on the card) on a seeded 480x640 raw
    image, with the weights of (1) loaded: no decode kernel launched, the
    joints of the card's heatmaps equal to ``sppe_parse`` of them on the
    CPU; ms an image of ``forward_decode`` (CUDA events) and of
    ``__call__`` (host wall) in float32 and bfloat16."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.inference import InferenceSPPEModel
    from human_pose_tpu_torch.ops import sppe_parse

    raw = rng.integers(0, 256, (*INFER_RAW_HW, 3), dtype=np.uint8)
    out = {}
    for name, arch in ZOO_SPPE_ARCHS.items():
        cfg = KeypointsConfig.from_dict({"setup": {"architecture": arch},
                                         "trainer": {"accelerator": "gpu"},
                                         "inference": {"ckpt_path": None, "input_size": SIZE}})
        im = cfg.create_inference_model()
        if not (isinstance(im, InferenceSPPEModel) and im.device == dev and im.dtype == torch.float32):
            raise AssertionError(f"zoo {name}: config gave {type(im).__name__} on {im.device}")
        im.model.load_state_dict(nets[name].state_dict())
        result, _ = counted(lambda: im(raw), f"zoo {name} SPPE __call__", {})
        x = torch.from_numpy(im.prepare_input(raw)[0]).permute(0, 3, 1, 2).contiguous().to(dev)
        hw = tuple(x.shape[2:])
        avg, joints = im.forward_decode(x, hw)
        if not (torch.equal(joints.cpu(), sppe_parse(avg.cpu())) and result.kpts_coords.shape == (1, K, 2)
                and np.isfinite(result.kpts_coords).all()):
            raise AssertionError(f"zoo {name}: SPPE joints card != sppe_parse on the CPU, or malformed")
        rec = {"input_hw": hw, "obj_score": float(result.obj_scores[0])}
        for dtype in (torch.float32, torch.bfloat16):
            im_t = im if dtype == torch.float32 else InferenceSPPEModel(
                im.model, input_size=SIZE, dtype=dtype, device=dev)
            fn = lambda: im_t.forward_decode(x, hw)  # noqa: E731
            warm_up(lambda: (im_t(raw), torch.cuda.synchronize()), INFER_WARMUP_S)
            d = str(dtype).split(".")[-1]
            rec[f"ms_{d}"] = cuda_ms(fn, iters=3, warmup=0, reps=3)
            rec[f"call_host_ms_{d}"] = host_ms(lambda: im_t(raw), iters=ZOO_CALLS)
        log(f"zoo {name} SPPE at {hw}: joints card == CPU parse; an image {rec['ms_float32']:.3f} ms "
            f"float32, {rec['ms_bfloat16']:.3f} bfloat16 (events), __call__ "
            f"{rec['call_host_ms_float32']:.3f} / {rec['call_host_ms_bfloat16']:.3f} ms host wall  [{smi}]")
        out[name] = rec
    return out


def zoo_torchvision(dev, rng) -> dict:
    """(5) A torchvision-layout resnet50 state dict made here loads strictly
    (``load_torchvision_backbone``: ``fc`` dropped, ``num_batches_tracked``
    ignored) into ``SimpleBaseline``'s backbone on the card: every tensor
    equal, the forward finite."""
    import torch

    from human_pose_tpu_torch.models import SimpleBaseline
    from human_pose_tpu_torch.utils import load_torchvision_backbone

    t0 = time.perf_counter()
    sd = torchvision_resnet_state_dict("resnet50", rng)
    net = load_torchvision_backbone(SimpleBaseline(K, "resnet50", device=dev), sd).eval()
    loaded = net.backbone.state_dict()
    same = all(torch.equal(loaded[k].cpu(), v) for k, v in sd.items()
               if not k.startswith("fc.") and not k.endswith("num_batches_tracked"))
    with torch.no_grad():
        hms = net(torch.zeros((1, 3, 256, 192), device=dev))[0]
    if not (same and bool(torch.isfinite(hms).all())):
        raise AssertionError("zoo torchvision: the resnet50 state dict did not load into the backbone")
    rec = {"keys": len(sd), "heatmaps": tuple(hms.shape), "seconds": time.perf_counter() - t0}
    log(f"zoo torchvision: a resnet50 state dict of {len(sd)} keys into SimpleBaseline.backbone on "
        f"the card, strictly (fc dropped), every tensor equal; heatmaps {rec['heatmaps']}")
    return rec


def zoo_phase(dev, counted, smi: str) -> dict:
    """Phase 14: the model zoo on the card: ``zoo_forwards`` (1),
    ``zoo_sppe_parse`` (2), ``zoo_ae_hourglass`` (3), ``zoo_sppe_inference``
    (4) and ``zoo_torchvision`` (5). Raises on any miss; returns the phase's
    record."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    out = {"card": smi}
    out["forwards"], nets, outs = zoo_forwards(dev, rng)
    out["sppe_parse"] = zoo_sppe_parse(dev, outs)
    out["ae_hourglass"] = zoo_ae_hourglass(nets["AEHourglassNet"], dev, rng, counted, smi)
    out["launches"] = out["ae_hourglass"]["launches"]
    out["sppe"] = zoo_sppe_inference(nets, dev, rng, counted, smi)
    out["torchvision"] = zoo_torchvision(dev, rng)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 (model zoo): {out['seconds']:.1f}s")
    return out


def zoo_only(dev, smi: str) -> int:
    """Phase 14 alone: build the dense refine and the grouping, then the
    model zoo phase. Prints the phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"zoo": zoo_phase(dev, counted, smi)}), flush=True)
    return 0


# phase 15, zoo and data-parallel training: the AE hourglass from the
# keypoints yaml with architecture Hourglass and every target at 1/4 (its
# two stages' resolution), at the yaml's point (Adam 1e-3, batch 36, 512^2,
# 30 persons); its one-stage net card vs CPU; the training CLI on a
# synthesized corpus; the CLI at world size 1 through NCCL against the
# CLI without a process group
DP_AE_ARGV = ("--setup.architecture=Hourglass", "--dataloader.train_ds.hm_resolutions=[0.25,0.25]",
              "--dataloader.val_ds.hm_resolutions=[0.25,0.25]", "--transform.hm_resolutions=[0.25,0.25]")
AE_PARAMS = 6_795_396  # AEHourglassNet(17 joints, 2 stages)
AE_REDUCED_STAGES, AE_REDUCED_BATCH, AE_REDUCED_SIZE = 1, 2, 128
# the CLI runs: two training steps of 8 and one validation batch an epoch
DP_CLI_N_TRAIN, DP_CLI_N_VAL, DP_CLI_BATCH = 16, 8, 8
DP_CLI_ARGV = (*DP_AE_ARGV, f"--dataloader.batch_size={DP_CLI_BATCH}", "--trainer.max_epochs=1",
               "--setup.pretrained_ckpt_path=null")
DP_CLI_TIMEOUT_S = 300
# the CLI at world size 1 and without a group, bit for bit: cuDNN's
# deterministic algorithms, no autotuning (ROADMAP "Repeatability")
DP_DETERMINISTIC = ("--cudnn.deterministic=true", "--cudnn.benchmark=false")
# the mesh's cost at world size 1: steps of this batch, each way, in turns
AE_MESH_BATCH, AE_MESH_STEPS = 16, 3
# per-process BatchNorm statistics against BatchNorm2d: steps a turn
LOCAL_BN_STEPS = 2


def ae_hourglass_step_card_vs_cpu(dev) -> dict:
    """One float32 Adam step (lr 1e-3; TF32 and cuDNN off, as phases 10 and
    12 hold their steps) of the one-stage full-width AE hourglass
    (``AE_REDUCED_BATCH`` at ``AE_REDUCED_SIZE``^2, one heatmap target at
    1/4) on the card and on the CPU from the same ``init_keypoints_weights_``
    weights and a seeded batch (``step_card_vs_cpu`` with ReLU decisions).
    Its 55 BatchNorms in series amplify rounding (with weights drawn at
    std 1/sqrt(fan_in) an x86 CPU's float32 gradients missed float64 by up
    to 4.4e-3 of a tensor, ``tests/test_torch_port_zoo_train.py``; with this
    init by 7.6e-5, and 4.5e-5 over all). Held: every loss term within
    rel 1e-4 of the CPU's; each device's decisions that differ from
    float64's at an input within 1e-4 of that ReLU input's largest value;
    every gradient of the card and of the CPU within ||g - ref|| / ||ref||
    1e-3 of the float64 gradient with its own decisions, and 1e-3 over all
    parameters (a tensor whose float64 gradient is below 1e-6 of the whole
    gradient's norm, zero in exact arithmetic, below 1e-5 of it); each BN running statistic within 1e-3 of its tensor's
    largest value; the parameters after the step within 2e-6 + 1e-6 of the
    CPU's where both gradients reach 1e-5 with one sign (Adam's first
    update lr * g / (|g| + 1e-8) then moves by at most lr * 1e-8 / 1e-5 on
    each device) and within 2 * lr + 1e-6 elsewhere. Raises on a miss;
    returns the errors."""
    import torch

    from human_pose_tpu_torch.models import AEHourglassNet, init_keypoints_weights_
    from human_pose_tpu_torch.ops import prep_images
    from human_pose_tpu_torch.train import (
        TrainState, ae_keypoints_loss, create_optimizer, keypoints_train_step,
    )

    lr, cpu = 1e-3, torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 15)
    model = init_keypoints_weights_(AEHourglassNet(K, AE_REDUCED_STAGES, device=cpu), gen)
    batch = train_batch(AE_REDUCED_BATCH, AE_REDUCED_SIZE, 30, gen, cpu, strides=(4,) * AE_REDUCED_STAGES)

    def step(net, where):
        state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", lr), device=where)
        return keypoints_train_step(state, batch, lr)[1]

    def ref_loss(net):
        hms, tags = net(prep_images(batch["images"]).double())
        return ae_keypoints_loss(hms, tags, batch["heatmaps"], batch["masks"], batch["joints"])[0]

    run = step_card_vs_cpu(dev, model, step, ref_loss, cudnn=False, decisions=True)
    (m_c, m_g), (sd_c, sd_g), g, relu = run["metrics"], run["after"], run["grads"], run["relu"]

    def flat(grads):
        return torch.cat([grads[n].flatten() for n in g["ref"]])

    # a BatchNorm bias whose output a later train-mode BatchNorm centres
    # again has a zero gradient in exact arithmetic: such tensors (below
    # 1e-6 of the whole gradient's norm) are held against that norm
    total = float(flat(g["ref"]).norm())
    zero = [n for n, r in g["ref"].items() if float(r.norm()) < 1e-6 * total]
    held = [n for n in g["ref"] if n not in zero]
    grad_rel = {n: rel_gap(g["card"][n], g["ref_card"][n]) for n in held}
    cpu_rel = {n: rel_gap(g["cpu"][n], g["ref_cpu"][n]) for n in held}
    zero_rel = max((float(g[who][n].norm()) / total for n in zero for who in ("card", "cpu")), default=0.0)
    p_sure = p_any = 0.0
    for name in g["ref"]:
        gc, gg = g["cpu"][name], g["card"][name]
        diff = (sd_g[name] - sd_c[name]).abs()
        sure = (gc.abs() >= 1e-5) & (gg.abs() >= 1e-5) & (torch.sign(gc) == torch.sign(gg))
        p_sure = max(p_sure, float(diff[sure].max()) if bool(sure.any()) else 0.0)
        p_any = max(p_any, float(diff.max()))
    out = {"batch": AE_REDUCED_BATCH, "size": AE_REDUCED_SIZE, "stages": AE_REDUCED_STAGES,
           "loss_rel": max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c), "relu": relu,
           "grad_rel_max": max(grad_rel.values()), "grad_rel_worst": max(grad_rel, key=grad_rel.get),
           "cpu_grad_rel_max": max(cpu_rel.values()), "cpu_grad_rel_worst": max(cpu_rel, key=cpu_rel.get),
           "grad_rel_global": rel_gap(flat(g["card"]), flat(g["ref_card"])),
           "cpu_grad_rel_global": rel_gap(flat(g["cpu"]), flat(g["ref_cpu"])),
           "grad_rel_vs_cpu_max": max(rel_gap(g["card"][n], g["cpu"][n]) for n in g["ref"]),
           "no_grad_params": sum(1 for n, _ in model.named_parameters() if n not in g["ref"]),
           "zero_grad_tensors": len(zero), "zero_grad_rel_max": zero_rel,
           "bn_stats_rel_max": run["bn_stats_rel_max"], "bn_stats_moved": run["bn_stats_moved"],
           "params_sure_abs_max": p_sure, "params_abs_max": p_any, "metrics_card": m_g}
    log(f"AE hourglass step card vs CPU ({AE_REDUCED_BATCH} x {AE_REDUCED_SIZE}^2, "
        f"{AE_REDUCED_STAGES} stage, full width, Adam, float32, TF32 and cuDNN off): "
        + ", ".join(f"{k} {v}" for k, v in out.items()))
    decisions_ok = all(relu[who]["differ_input_rel_max"] <= 1e-4 for who in ("cpu", "card"))
    if not (out["loss_rel"] <= 1e-4 and decisions_ok and out["grad_rel_max"] <= 1e-3
            and out["cpu_grad_rel_max"] <= 1e-3 and out["grad_rel_global"] <= 1e-3
            and out["cpu_grad_rel_global"] <= 1e-3 and zero_rel <= 1e-5 and out["bn_stats_rel_max"] <= 1e-3
            and run["bn_stats_all_moved"] and p_sure <= 2e-6 + 1e-6 and p_any <= 2 * lr + 1e-6):
        raise AssertionError(f"AE hourglass step card vs CPU: {out}")
    return out


def ae_hourglass_steps(dev, smi: str) -> dict:
    """The AE hourglass (17 joints, 2 stages, full width) from ``TRAIN_YAML``
    with ``DP_AE_ARGV`` (``create_net``, ``init_keypoints_weights_``, the
    yaml's Adam and batch) on a batch made on the card with both heatmap
    targets at 1/4, in float32 (TF32 off) and in bfloat16 autocast
    (``timed_steps``: ms a step, img/s, peak memory, busy and idle share,
    losses finite). A batch that does not fit on the card is halved until
    it does, and the cut is recorded. Returns the record."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.models import AEHourglassNet, init_keypoints_weights_
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / TRAIN_YAML), list(DP_AE_ARGV)))
    cfg.check_trainable()
    opt_cfg = cfg.module.optimizers["optim"]
    opt_params = dict(opt_cfg["params"])
    base_lr = opt_params.pop("lr")
    n, size = cfg.dataloader.batch_size, cfg.dataloader.train_ds.out_size
    persons = cfg.dataloader.train_ds.max_num_people
    model = init_keypoints_weights_(cfg.create_net(device=dev), torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if not isinstance(model, AEHourglassNet) or n_params != AE_PARAMS:
        raise AssertionError(f"AE hourglass from {TRAIN_YAML}: {type(model).__name__}, {n_params} parameters")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    out = {"params": n_params, "yaml_batch": n, "size": size, "persons": persons,
           "optimizer": opt_cfg["name"], "lr": base_lr, "hm_resolutions": cfg.dataloader.train_ds.hm_resolutions}
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
    cfg.apply_cudnn()
    try:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            b, last = n, {}
            while True:
                model.load_state_dict(init)
                state = TrainState.create(
                    model, create_optimizer(model.parameters(), opt_cfg["name"], base_lr, **opt_params),
                    dtype=dtype, device=dev)
                batch = train_batch(b, size, persons, torch.Generator(device=dev).manual_seed(SEED), dev,
                                    strides=(4, 4))

                def step():
                    last.update(keypoints_train_step(state, batch, base_lr)[1])
                    torch.cuda.synchronize()
                    return last

                try:
                    out[name] = timed_steps(step, b, f"AE hourglass train {name} bs{b}", smi)
                    break
                except torch.cuda.OutOfMemoryError:
                    del state, batch, step
                    torch.cuda.empty_cache()
                    log(f"AE hourglass train {name}: batch {b} does not fit; halving it")
                    b //= 2
            out[name].update(batch=b, steps=state.step, metrics=sorted(last))
            del state, batch
            torch.cuda.empty_cache()
    finally:
        cudnn.benchmark, cudnn.deterministic, cudnn.enabled = saved
    if any(set(out[d]["metrics"]) != {"hm_0", "hm_1", "push", "pull", "loss"}
           for d in ("float32", "bfloat16")):
        raise AssertionError(f"AE hourglass train metrics {out['float32']['metrics']}")
    return out


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (``parallel/distributed.py::free_port``)."""
    from human_pose_tpu_torch.parallel.distributed import free_port as port

    return port()


@contextlib.contextmanager
def torchrun_env_of_one():
    """torchrun's environment for one rank in this process (``RANK=0
    WORLD_SIZE=1 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=<free>``),
    restored after."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def process_group_of_one(device_type: str = "cuda"):
    """A ``torch.distributed`` group of this process alone, joined as
    torchrun's one rank (``setup_distributed`` in ``torchrun_env_of_one``:
    NCCL on the card); yields ``make_mesh()``. The group is destroyed and
    the environment restored after."""
    from human_pose_tpu_torch.parallel import finalize_distributed, make_mesh, setup_distributed

    with torchrun_env_of_one():
        try:
            setup_distributed(device_type)
            yield make_mesh()
        finally:
            finalize_distributed()


def mesh_step_cost(dev, smi: str) -> dict:
    """What the data-parallel step adds at world size 1: the AE hourglass
    from ``TRAIN_YAML`` with ``DP_AE_ARGV`` in bfloat16 on a card batch
    (batch ``AE_MESH_BATCH``, 512^2) stepped without a mesh and through an
    NCCL group of one (gradients, BN statistics and metrics all-reduced),
    in turns plain, mesh, mesh, plain, ``AE_MESH_STEPS`` steps each by host
    wall to a sync; the medians and their difference. Returns the record."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.models import init_keypoints_weights_
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / TRAIN_YAML), list(DP_AE_ARGV)))
    model = init_keypoints_weights_(cfg.create_net(device=dev), torch.Generator().manual_seed(SEED))
    size = cfg.dataloader.train_ds.out_size
    batch = train_batch(AE_MESH_BATCH, size, cfg.dataloader.train_ds.max_num_people,
                        torch.Generator(device=dev).manual_seed(SEED), dev, strides=(4, 4))
    times = {"plain": [], "mesh": []}
    with process_group_of_one() as mesh:
        states = {name: TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                                          dtype=torch.bfloat16, device=dev, mesh=m)
                  for name, m in (("plain", None), ("mesh", mesh))}

        def step(name):
            keypoints_train_step(states[name], batch, 1e-3)
            torch.cuda.synchronize()

        for name in ("plain", "mesh"):
            step(name)  # cuDNN's autotuning, NCCL's first call
        for name in ("plain", "mesh", "mesh", "plain"):
            times[name] += [host_ms(lambda: step(name)) for _ in range(AE_MESH_STEPS)]
    rec = {"batch": AE_MESH_BATCH, "size": size, "dtype": "bfloat16", "world_size": mesh.world_size,
           "params": sum(p.numel() for p in model.parameters()),
           **{f"{k}_ms": float(np.median(v)) for k, v in times.items()},
           **{f"{k}_ms_all": v for k, v in times.items()}}
    rec["mesh_cost_ms"] = rec["mesh_ms"] - rec["plain_ms"]
    log(f"the data-parallel step at world size 1 (AE hourglass, bf16, bs{AE_MESH_BATCH} {size}^2): "
        f"{rec['plain_ms']:.1f} ms a step without a mesh, {rec['mesh_ms']:.1f} ms through an NCCL group "
        f"of one (medians of {2 * AE_MESH_STEPS} in turns): {rec['mesh_cost_ms']:+.1f} ms  [{smi}]")
    return rec


def local_bn_cost(dev, smi: str) -> dict:
    """What per-process BatchNorm statistics cost on one card: the AE
    hourglass from ``TRAIN_YAML`` with ``DP_AE_ARGV`` at the yaml's point
    (its batch at 512^2, cuDNN as the yaml sets it) with ``BatchNorm2d``
    and converted as one process of two under per-device statistics
    (``convert_batch_norm(net, 2, 2)``: ``LocalBatchNorm(1)``, JAX's two-pass
    moments; the steps without a mesh), in float32 and in bfloat16, in
    turns plain, local, local, plain, ``LOCAL_BN_STEPS`` steps each by host
    wall to a sync; the medians and their difference. Returns the record."""
    import copy

    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.models import init_keypoints_weights_
    from human_pose_tpu_torch.models.norm import convert_batch_norm
    from human_pose_tpu_torch.parallel import LocalBatchNorm
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / TRAIN_YAML), list(DP_AE_ARGV)))
    plain = init_keypoints_weights_(cfg.create_net(device=dev), torch.Generator().manual_seed(SEED))
    models = {"plain": plain, "local": convert_batch_norm(copy.deepcopy(plain), 2, 2)}
    n_local = sum(type(m) is LocalBatchNorm and m.num_groups == 1 for m in models["local"].modules())
    n, size = cfg.dataloader.batch_size, cfg.dataloader.train_ds.out_size
    batch = train_batch(n, size, cfg.dataloader.train_ds.max_num_people,
                        torch.Generator(device=dev).manual_seed(SEED), dev, strides=(4, 4))
    rec = {"batch": n, "size": size, "local_batch_norms": n_local}
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
    cfg.apply_cudnn()
    try:
        for dtype in (torch.float32, torch.bfloat16):
            states = {k: TrainState.create(m, create_optimizer(m.parameters(), "Adam", 1e-3), dtype=dtype,
                                           device=dev) for k, m in models.items()}
            times = {k: [] for k in states}

            def step(name):
                keypoints_train_step(states[name], batch, 1e-3)
                torch.cuda.synchronize()

            for name in states:
                step(name)  # cuDNN's autotuning
            for name in ("plain", "local", "local", "plain"):
                times[name] += [host_ms(lambda: step(name)) for _ in range(LOCAL_BN_STEPS)]
            d = str(dtype).split(".")[-1]
            rec[d] = {**{f"{k}_ms": float(np.median(v)) for k, v in times.items()},
                      **{f"{k}_ms_all": v for k, v in times.items()}}
            rec[d]["local_cost_ms"] = rec[d]["local_ms"] - rec[d]["plain_ms"]
            del states
            torch.cuda.empty_cache()
    finally:
        cudnn.benchmark, cudnn.deterministic, cudnn.enabled = saved
    if n_local != sum(isinstance(m, torch.nn.BatchNorm2d) for m in plain.modules()):
        raise AssertionError(f"convert_batch_norm(net, 2, 2): {n_local} LocalBatchNorm(1)")
    log(f"per-process BatchNorm statistics (AE hourglass bs{n} {size}^2, {n_local} BatchNorms as "
        f"LocalBatchNorm(1), medians of {2 * LOCAL_BN_STEPS} in turns): float32 "
        f"{rec['float32']['plain_ms']:.1f} ms a step with BatchNorm2d, {rec['float32']['local_ms']:.1f} "
        f"local ({rec['float32']['local_cost_ms']:+.1f}); bfloat16 {rec['bfloat16']['plain_ms']:.1f}, "
        f"{rec['bfloat16']['local_ms']:.1f} ({rec['bfloat16']['local_cost_ms']:+.1f})  [{smi}]")
    return rec


def _run_dir(workdir: Path) -> Path:
    """The one run directory the training CLI made under ``workdir``."""
    runs = [p.parent.parent for p in workdir.glob("results/**/checkpoints/last.pt")]
    if len(runs) != 1:
        raise AssertionError(f"{workdir}: {len(runs)} runs with a last.pt")
    return runs[0]


def ae_hourglass_cli(dev, counted, yaml_path: str, roots: list, workdir: Path) -> tuple:
    """``bin.train_keypoints.main`` with ``architecture: Hourglass`` on the
    synthesized corpus (``DP_CLI_ARGV``: one epoch of two steps and one
    validation batch, the yaml's bfloat16): FINISHED, the AE hourglass's
    parameter count and metrics, one launch of the dense refine and of the
    grouping (the validation's ``make_results``, counters zeroed before the
    run). Returns (the record, the trainer)."""
    from human_pose_tpu_torch.bin import train_keypoints
    from human_pose_tpu_torch.models import AEHourglassNet

    counters = {k: w for k, w in kernel_counters().items() if k in ("match_by_tag", "refine_argmax")}
    want = {"match_by_tag": 1, "refine_argmax": 1}
    t0 = time.perf_counter()
    with EngineProbe(workdir, counters) as probe:
        tr, launches = counted(lambda: train_keypoints.main([f"--config={yaml_path}", *roots, *DP_CLI_ARGV]),
                               "phase 15 (the AE hourglass through the training CLI)", want)
    run_s = time.perf_counter() - t0
    status = json.loads((workdir / tr.log_path / "tracker" / "run.json").read_text())["status"]
    module = tr.module
    n_params = sum(p.numel() for p in module.model.parameters())
    losses = engine_losses(tr)
    per_eval = [c for _, c in probe.evaluates]
    if (status != "FINISHED" or not isinstance(module.model, AEHourglassNet) or n_params != AE_PARAMS
            or module.device != dev or per_eval != [want] or tr.current_step != DP_CLI_N_TRAIN // DP_CLI_BATCH
            or set(losses["steps"]) != {"hm_0", "hm_1", "push", "pull", "loss"}
            or not all(np.isfinite(v) for k in losses["steps"].values() for v in k)):
        raise AssertionError(f"AE hourglass CLI: status {status}, {type(module.model).__name__} "
                             f"{n_params} on {module.device}, launches an evaluate {per_eval}, steps "
                             f"{tr.current_step}, losses {losses['steps']}")
    rec = {"seconds": run_s, "status": status, "steps": tr.current_step, "params": n_params,
           "dtype": str(module.state.dtype).split(".")[-1], "launches": launches,
           "launches_an_evaluate": per_eval, "loss_steps": losses["steps"]["loss"],
           "val_loss": losses["epochs"]["loss"]["val"]}
    log(f"AE hourglass CLI ({DP_CLI_N_TRAIN} train / {DP_CLI_N_VAL} val images, batch {DP_CLI_BATCH}, "
        f"{rec['dtype']}): {run_s:.1f}s, FINISHED, loss a step {[round(v, 6) for v in rec['loss_steps']]}, "
        f"one launch of each decode kernel in the validation's make_results")
    return rec, tr


def target_val_outputs(batch: dict, dev) -> tuple:
    """The AE hourglass's validation outputs as a net that had learnt its
    targets would give them on a host val batch: both 1/4 stages the
    batch's 1/4 heatmap targets (NCHW on ``dev``), the tags person p's
    value 2 (p + 1) in a 3x3 window about each of its visible joints (on the
    1/4 grid), 0 elsewhere. Every visible joint's peak clears det 0.1."""
    import torch

    hm = torch.from_numpy(np.ascontiguousarray(np.asarray(batch["heatmaps"][0]).transpose(0, 3, 1, 2)))
    n, k, h, w = hm.shape
    joints = np.asarray(batch["joints"])
    tags = np.zeros((n, k, h, w), np.float32)
    for i, p, j in zip(*np.nonzero(joints[..., 2] > 0)):
        x, y = int(joints[i, p, j, 0]), int(joints[i, p, j, 1])
        tags[i, j, max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = 2.0 * (p + 1)
    return [hm.to(dev)] * 2, torch.from_numpy(tags).to(dev)


def ae_hourglass_val_kernels(tr, smi: str) -> dict:
    """A val batch of the CLI run through ``make_results`` twice: on its
    module's ``validation_step`` outputs (two steps from the init: few or
    no candidates clear det 0.1) and on ``target_val_outputs`` (every
    person of the batch's first images a candidate). On both, each kernel's
    output on the inputs ``make_results`` gives it equals its plain
    version's, at the val thresholds (det 0.1, tag 1.0); the targets must
    give the grouping valid rows. The kernels' times (CUDA events), bounds
    and plain times on the targets' inputs; the valid rows of both."""
    import torch

    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    module = tr.module
    batch = next(iter(tr.datamodule.val_dl))
    _, outputs = module.validation_step(batch)
    rec, fns = {}, {}
    for name, outs in (("cli", outputs), ("targets", target_val_outputs(batch, module.device))):
        fns[name] = fn = (lambda o: lambda: module.make_results(batch, o))(outs)
        seen = record_kernel_inputs(fn)
        hm, tg, prev, cnt = seen["refine_argmax"]
        cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
        refine_equal = torch.equal(cuda_decode.refine_argmax_batch(hm, tg, prev, cnt),
                                   cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt))
        t1 = time.perf_counter()
        plain = cuda_match.match_by_tag_batched_plain(cand, det_thr, tag_thr, order, persons)
        torch.cuda.synchronize()
        match_plain_ms = (time.perf_counter() - t1) * 1e3
        match_equal = all(torch.equal(a, b) for a, b in
                          zip(cuda_match.match_by_tag_batched(cand, det_thr, tag_thr, order, persons), plain))
        valid = int((cand[..., 2] > det_thr).sum())
        rec[f"{name}_valid_rows"] = valid
        rec[f"{name}_active_persons"] = int(cnt.sum())
        if not (refine_equal and match_equal and (det_thr, tag_thr) == (0.1, 1.0)) \
                or (name == "targets" and valid == 0):
            raise AssertionError(f"AE hourglass make_results on the {name}' outputs: refine == plain "
                                 f"{refine_equal}, grouping == plain {match_equal}, thresholds {det_thr}, "
                                 f"{tag_thr}, {valid} valid rows")
    rec.update(thresholds=[det_thr, tag_thr], **path_kernel_times(fns["targets"]),
               refine_plain_ms=cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt),
                                       iters=2),
               match_plain_ms=match_plain_ms, match_valid_rows=valid)
    log(f"AE hourglass make_results: each kernel == plain on its inputs (det 0.1, tag 1.0) from the "
        f"CLI's outputs ({rec['cli_valid_rows']} valid rows, {rec['cli_active_persons']} active persons) "
        f"and from the batch's targets ({valid} valid rows); on the targets' refine "
        f"{rec['refine_ms']:.4f} ms ({rec['refine_shape']}, {rec['refine_active_persons']} active persons, "
        f"bound {rec['refine_bound_ms']:.4f}, plain {rec['refine_plain_ms']:.2f}), grouping "
        f"{rec['match_ms']:.4f} ms ({rec['match_shape']}, bound {rec['match_bound_ms']:.4f}, plain "
        f"{match_plain_ms:.0f})  [{smi}]")
    return rec


def start_world_one(yaml_path: str, roots: list, workdir: Path) -> dict:
    """Start the training CLI (``DP_CLI_ARGV`` with cuDNN deterministic, no
    autotuning) twice, side by side in processes of their own: "world1"
    with torchrun's environment for one rank (``RANK=0 WORLD_SIZE=1
    LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=<free>``: an NCCL group
    of one, the mesh, every collective of the steps) and "single" without.
    Returns the processes by name and their start time
    (``world_one_record`` waits for them)."""
    here = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [here, os.environ.get("PYTHONPATH")]))}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    runs = {"single": env, "world1": {**env, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                                      "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}}
    argv = [sys.executable, "-m", "human_pose_tpu_torch.bin.train_keypoints", f"--config={yaml_path}",
            *roots, *DP_CLI_ARGV, *DP_DETERMINISTIC]
    procs, t0 = {}, time.perf_counter()
    try:
        for name, run_env in runs.items():
            (workdir / name).mkdir(parents=True)
            procs[name] = subprocess.Popen(argv, cwd=workdir / name, env=run_env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    except BaseException:
        _stop(procs)
        raise
    return {"procs": procs, "t0": t0}


def _stop(procs: dict) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def world_one_record(started: dict, smi: str, workdir: Path) -> dict:
    """Wait for ``start_world_one``'s processes (``DP_CLI_TIMEOUT_S``,
    killed after). Held: both exit 0; the group's process reports NCCL and
    the mesh, the other no group; every step's and the validation's metrics
    and every tensor of last.pt's model and Adam state bit for bit equal. A
    failure to build the group fails the phase; it never falls back to
    gloo. Returns the record."""
    import torch

    procs = started["procs"]
    try:
        logs = {name: p.communicate(timeout=DP_CLI_TIMEOUT_S)[0] for name, p in procs.items()}
    finally:
        _stop(procs)
    seconds = time.perf_counter() - started["t0"]
    for name, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"the training CLI ({name}) exited {p.returncode}:\n{logs[name][-3000:]}")
    group_line = next((l for l in logs["world1"].splitlines() if "initialized torch.distributed" in l), "")
    backend = "gloo" if "--trainer.accelerator=cpu" in DP_CLI_ARGV else "nccl"
    if f"({backend})" not in group_line or "mesh={'data': 1}" not in logs["world1"] \
            or "initialized torch.distributed" in logs["single"]:
        raise AssertionError(f"world size 1: group line {group_line!r}; mesh logged "
                             f"{'mesh=' in logs['world1']}")
    ckpt = {name: torch.load(_run_dir(workdir / name) / "checkpoints" / "last.pt", map_location="cpu",
                             weights_only=True) for name in procs}
    model = {name: c["module"]["model"] for name, c in ckpt.items()}
    opt = {name: c["module"]["optimizers"]["optim"]["state"] for name, c in ckpt.items()}
    metrics_equal = ckpt["single"]["metrics"] == ckpt["world1"]["metrics"]
    model_equal = model["single"].keys() == model["world1"].keys() and all(
        torch.equal(v, model["world1"][k]) for k, v in model["single"].items())
    opt_equal = opt["single"].keys() == opt["world1"].keys() and all(
        torch.equal(t, opt["world1"][i][key]) for i, st in opt["single"].items()
        for key, t in st.items() if torch.is_tensor(t))
    rec = {"seconds": seconds, "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
           "group_line": group_line[group_line.index("initialized"):].replace("\x1b[0m", "").strip(),
           "metrics_equal": metrics_equal,
           "model_equal": model_equal, "optimizer_equal": opt_equal,
           "loss_steps": [r["value"] for r in ckpt["world1"]["metrics"]["metrics"]["loss"]["train"]],
           "model_tensors": len(model["world1"])}
    log(f"world size 1 through NCCL vs one process, the AE hourglass CLI side by side ({seconds:.1f}s): "
        f"NCCL {rec['nccl_version']}, '{rec['group_line']}'; metrics equal {metrics_equal}, last.pt model "
        f"equal {model_equal} ({rec['model_tensors']} tensors), Adam state equal {opt_equal}  [{smi}]")
    if not (metrics_equal and model_equal and opt_equal):
        raise AssertionError(f"world size 1 vs one process: {rec}")
    return rec


def dp_train_phase(dev, counted, smi: str) -> dict:
    """Phase 15: zoo and data-parallel training on the card: the reduced
    AE hourglass card vs CPU (``ae_hourglass_step_card_vs_cpu``), the
    full-width AE hourglass at the yaml's point (``ae_hourglass_steps``; no
    kernel launched), its step through an NCCL group of one against the
    plain step (``mesh_step_cost``), per-process BatchNorm statistics
    against ``BatchNorm2d`` (``local_bn_cost``), a synthesized COCO
    ``train2017`` (16 images) and ``val2017`` (8), the AE hourglass through
    the training CLI (``ae_hourglass_cli``, its kernels on the inputs
    ``make_results`` gives them from its outputs and from the val batch's
    targets, ``ae_hourglass_val_kernels``) and, meanwhile, the CLI at world size 1
    through NCCL beside one process without a group (``start_world_one``,
    ``world_one_record``). Raises on any miss; returns the phase's
    record."""
    import tempfile

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    yaml_path = str(Path(__file__).resolve().parent / TRAIN_YAML)
    out = {"card": smi}
    out["card_vs_cpu"] = ae_hourglass_step_card_vs_cpu(dev)
    out["steps"], out["steps_launches"] = counted(
        lambda: ae_hourglass_steps(dev, smi), "phase 15 (AE hourglass steps at the yaml's point)", {})
    out["mesh_cost"], out["mesh_cost_launches"] = counted(
        lambda: mesh_step_cost(dev, smi), "phase 15 (the step through a group of one)", {})
    out["local_bn_cost"], out["local_bn_cost_launches"] = counted(
        lambda: local_bn_cost(dev, smi), "phase 15 (per-process BatchNorm statistics)", {})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "coco"
        out["corpus"] = {split: make_eval_corpus(root, rng, split, n, TRAIN_DATA_PERSONS, TRAIN_DATA_CROWD_EVERY)
                         for split, n in (("train2017", DP_CLI_N_TRAIN), ("val2017", DP_CLI_N_VAL))}
        roots = [f"--dataloader.train_ds.root={root}", f"--dataloader.val_ds.root={root}"]
        (tmp / "cli").mkdir()
        # the two CLI processes run while this process runs the CLI too;
        # the kernels are timed after they have ended
        started = start_world_one(yaml_path, roots, tmp / "dp")
        try:
            out["cli"], tr = ae_hourglass_cli(dev, counted, yaml_path, roots, tmp / "cli")
        except BaseException:
            _stop(started["procs"])
            raise
        out["world1"] = world_one_record(started, smi, tmp / "dp")
        out["launches"] = out["cli"]["launches"]
        out["cli"].update(ae_hourglass_val_kernels(tr, smi))
        del tr
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 (zoo and data-parallel training): {out['seconds']:.1f}s")
    return out


def dp_train_only(dev, smi: str) -> int:
    """Phase 15 alone: build the dense refine and the grouping (the
    validation's decode), then the zoo and data-parallel training phase.
    Prints the phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"dp_train": dp_train_phase(dev, counted, smi)}), flush=True)
    return 0


# phase 16: distributed COCO evaluation and the last utilities: the
# evaluator sharded over an NCCL group of one (torchrun's environment, in
# this process and as a torchrun launch), the directory checkpoint backend
# on W32's Adam state beside the file backend, the card-memory monitor and
# the native RLE decode
SHARDED_BATCH = 8
SHARDED_TIMEOUT_S = 300
CKPT_BATCH, CKPT_SIZE = 2, 256  # the step that gives W32's Adam its state
RLE_HW, RLE_MASKS = (480, 640), 16


def _eval_cli(workdir: Path, argv: list) -> Path:
    """``bin.eval_keypoints.main(argv)`` in ``workdir`` (made here); its
    output directory."""
    from human_pose_tpu_torch.bin import eval_keypoints

    workdir.mkdir(parents=True)
    with contextlib.chdir(workdir):
        return workdir / eval_keypoints.main(argv)


def sharded_eval(dev, counted, smi: str, tmp: Path) -> dict:
    """(1) the sharded COCO evaluation on phase 8's synthesized corpus (W32
    from ``EVAL_YAML``, seeded weights, flip, 512), cuDNN deterministic
    without autotuning: ``bin.eval_keypoints --sharded=true
    --batch_size=8`` under ``torch.distributed.run --nproc_per_node=1``
    (NCCL) as a process of its own, started first; meanwhile in this
    process the same CLI without ``--sharded`` and with it under torchrun's
    environment for one rank, each with the launch counters zeroed: one
    launch of the dense refine and of the grouping a dispatched batch in
    both; the three results files hold the same detections bit for bit
    (the sharded runs' bytes equal; in image order, the one-process run's);
    each kernel on the sharded path's last batch equal to its plain
    version, its time and bound; then, the launch ended, img/s of
    ``evaluate_dataset_batched`` at batch 8 without a mesh and through an
    NCCL group of one, float32 and bfloat16, in turns."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.data import CocoKeypointsDataset
    from human_pose_tpu_torch.inference import BatchedKeypointsEvaluator, evaluate_dataset_batched
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match
    from human_pose_tpu_torch.parallel import gather_to_main
    from human_pose_tpu_torch.utils import load_yaml, save_yaml

    rng = np.random.default_rng(SEED + 8)  # phase 8's corpus
    out = {"card": smi, "batch_size": SHARDED_BATCH, "corpus": make_eval_corpus(tmp / "coco", rng)}
    cfg_dict = load_yaml(Path(__file__).resolve().parent / EVAL_YAML)
    cfg_dict["dataloader"]["val_ds"]["root"] = str(tmp / "coco")
    cfg_dict["inference"].update(ckpt_path=None, use_flip=True, input_size=SIZE)
    yaml_path = tmp / "eval.yaml"
    save_yaml(cfg_dict, yaml_path)
    argv = [f"--config={yaml_path}", f"--batch_size={SHARDED_BATCH}", *DP_DETERMINISTIC]
    here = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [here, os.environ.get("PYTHONPATH")]))}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    (tmp / "torchrun").mkdir()
    t_launch = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1", "--nnodes=1",
         "--master_addr=127.0.0.1", f"--master_port={free_port()}",
         "-m", "human_pose_tpu_torch.bin.eval_keypoints", *argv, "--sharded=true"],
        cwd=tmp / "torchrun", env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.enabled)
    try:
        cudnn.benchmark, cudnn.deterministic = False, True
        models = {}
        for dtype, extra in (("float32", ["--trainer.accelerator=gpu"]), ("bfloat16", [])):
            cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(str(yaml_path), extra))
            models[dtype] = cfg.create_inference_model()
        ds = CocoKeypointsDataset(str(tmp / "coco"), "val2017")
        probe = BatchedKeypointsEvaluator(models["bfloat16"], batch_size=SHARDED_BATCH)
        for i in range(len(ds)):
            probe.add(ds.load_image(i), i, None)
        probe.finish()
        n = probe.n_batches
        want = {"match_by_tag": n, "refine_argmax": n}
        one_dir, launches_one = counted(lambda: _eval_cli(tmp / "one", argv),
                                        "phase 16: eval CLI bs8, one process", want)

        def sharded_cli():
            with torchrun_env_of_one():
                return _eval_cli(tmp / "sharded", [*argv, "--sharded=true"])

        sharded_dir, launches = counted(sharded_cli, "phase 16: eval CLI bs8, --sharded=true under "
                                        "torchrun's environment (NCCL, world size 1)", want)
        if torch.distributed.is_initialized():
            raise AssertionError("phase 16: the sharded CLI left its process group")
        one = json.loads((one_dir / "val2017_results.json").read_text())
        sharded_text = (sharded_dir / "val2017_results.json").read_text()
        sharded = json.loads(sharded_text)
        # the sharded run's records come in dataset order, the corpus's ids in
        # file order: a stable sort by id puts the one-process run's there
        if not sharded or sharded != sorted(one, key=lambda d: d["image_id"]):
            raise AssertionError(f"phase 16: the sharded CLI's {len(sharded)} detections differ from "
                                 f"the one-process CLI's {len(one)} in image order")
        out.update(batches=n, launches=launches, launches_one_process=launches_one,
                   detections=len(sharded), equal_in_image_order=True,
                   same_order=sharded == one, ap_line=(sharded_dir / "coco_output.txt")
                   .read_text().splitlines()[0])

        # each kernel on the sharded path's last batch, against its plain version
        with process_group_of_one() as mesh:
            seen = record_kernel_inputs(lambda: evaluate_dataset_batched(
                models["bfloat16"], ds, SHARDED_BATCH, mesh=mesh, progress=False))
        hm, tg, prev, cnt = seen["refine_argmax"]
        cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
        refine_equal = torch.equal(cuda_decode.refine_argmax_batch(hm, tg, prev, cnt),
                                   cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt))
        got = cuda_match.match_by_tag_batched(cand, det_thr, tag_thr, order, persons)
        t0 = time.perf_counter()
        plain = cuda_match.match_by_tag_batched_plain(cand[:MATCH_PLAIN_IMAGES].cpu(), det_thr,
                                                      tag_thr, order, persons)
        match_plain_ms = (time.perf_counter() - t0) * 1e3
        match_equal = all(torch.equal(a[:MATCH_PLAIN_IMAGES].cpu(), b) for a, b in zip(got, plain))
        if not (refine_equal and match_equal):
            raise AssertionError(f"phase 16: kernel vs plain on the sharded path's inputs: refine "
                                 f"{refine_equal}, grouping {match_equal}")
        out["kernels"] = {
            "refine_shape": f"B{hm.shape[0]} K{K} HW{hm.shape[2]} E{tg.shape[2]} P{prev.shape[1]}",
            "refine_active_persons": int(cnt.sum()),
            "refine_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch(hm, tg, prev, cnt), iters=20),
            "refine_plain_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt),
                                       iters=2),
            "refine_bound_ms": refine_bound(hm, tg, prev, cnt)[0],
            "match_shape": f"B{cand.shape[0]} K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
            "match_valid_rows": int((cand[..., 2] > det_thr).sum()),
            "match_ms": cuda_ms(lambda: cuda_match.match_by_tag_batched(
                cand, det_thr, tag_thr, order, persons), iters=20),
            "match_plain_cpu_ms": match_plain_ms, "match_plain_images": MATCH_PLAIN_IMAGES,
            "match_bound_ms": match_bound(cand, persons)[0]}

        # the torchrun launch: its results file, group line and throughput
        try:
            log_text = proc.communicate(timeout=SHARDED_TIMEOUT_S)[0]
        finally:
            _stop({"torchrun": proc})
        launch_s = time.perf_counter() - t_launch
        if proc.returncode != 0:
            raise AssertionError(f"phase 16: the torchrun launch exited {proc.returncode}:\n{log_text[-3000:]}")
        runs = list((tmp / "torchrun" / "evaluation_results").iterdir())
        group_line = next((l for l in log_text.splitlines() if "initialized torch.distributed" in l), "")
        rate_line = next((l for l in log_text.splitlines() if "batched eval:" in l), "")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if len(runs) != 1 or f"({backend})" not in group_line or \
                (runs[0] / "val2017_results.json").read_text() != sharded_text:
            raise AssertionError(f"phase 16: torchrun launch: {len(runs)} output dirs, group line "
                                 f"{group_line!r}, or its results differ from the in-process run's")
        out["torchrun"] = {"seconds": launch_s, "results_bytes_equal": True,
                           "group_line": group_line[group_line.index("initialized"):]
                           .replace("\x1b[0m", "").strip(),
                           "rate_line": rate_line[rate_line.index("batched eval:"):]
                           .replace("\x1b[0m", "").strip()}
        log(f"phase 16 sharded eval: {n} batches, launches {launches} == one process's; "
            f"{len(sharded)} detections bit-equal (sharded in image order, the torchrun launch's "
            f"bytes equal); torchrun: '{out['torchrun']['group_line']}', "
            f"'{out['torchrun']['rate_line']}' ({launch_s:.1f}s)  [{smi}]")
        log(f"phase 16 kernels on the sharded path's last batch (== plain): refine "
            f"{out['kernels']['refine_ms']:.4f} ms ({out['kernels']['refine_shape']}, bound "
            f"{out['kernels']['refine_bound_ms']:.4f}), grouping {out['kernels']['match_ms']:.4f} ms "
            f"({out['kernels']['match_shape']}, {out['kernels']['match_valid_rows']} valid rows)  [{smi}]")

        # img/s at batch 8, without a mesh and through an NCCL group of one
        # (made once for both of its turns; its communicator set up by an
        # untimed gather before them)
        out["img_per_s"] = {}
        for dtype, model in models.items():
            evaluate_dataset_batched(model, ds, SHARDED_BATCH, progress=False)
            rates = {"plain": [], "mesh": []}

            def rate(mesh=None):
                return len(ds) / host_ms(lambda: evaluate_dataset_batched(
                    model, ds, SHARDED_BATCH, mesh=mesh, progress=False)) * 1e3

            rates["plain"].append(rate())
            with process_group_of_one() as mesh:
                gather_to_main(mesh, None)
                rates["mesh"] += [rate(mesh), rate(mesh)]
            rates["plain"].append(rate())
            out["img_per_s"][dtype] = rates
            log(f"phase 16 eval {dtype} bs8 img/s in turns plain, group, group, plain: plain "
                f"{rates['plain']}, NCCL group of one {rates['mesh']}  [{smi}]")
    finally:
        _stop({"torchrun": proc})
        cudnn.benchmark, cudnn.deterministic, cudnn.enabled = saved
    return out


def checkpoint_dir_cost(dev, tmp: Path, smi: str) -> dict:
    """(2) W32 from ``TRAIN_YAML`` with the yaml's Adam after one bfloat16
    step (batch ``CKPT_BATCH`` at ``CKPT_SIZE``^2) on the card: saved by the
    file backend (``save_checkpoint``; ``AsyncCheckpointWriter``: submit and
    write) and by the directory backend (``checkpoint_orbax``: synchronous;
    ``use_async``: submit and write, one more step taken before the write
    is waited for), each's ms and MB; each restored into a fresh W32 state
    on the card (ms, to a device sync), the model and Adam's state bit for
    bit the state of the save."""
    import torch

    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.models import init_keypoints_weights_
    from human_pose_tpu_torch.train import (
        AsyncCheckpointWriter, TrainState, checkpoint, checkpoint_orbax, create_optimizer,
        keypoints_train_step,
    )

    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        str(Path(__file__).resolve().parent / TRAIN_YAML), []))
    opt_params = dict(cfg.module.optimizers["optim"]["params"])
    lr = opt_params.pop("lr")

    def fresh(seed):
        model = init_keypoints_weights_(cfg.create_net(device=dev), torch.Generator().manual_seed(seed))
        opt = create_optimizer(model.parameters(), cfg.module.optimizers["optim"]["name"], lr, **opt_params)
        return TrainState.create(model, opt, dtype=torch.bfloat16, device=dev)

    state = fresh(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    keypoints_train_step(state, train_batch(CKPT_BATCH, CKPT_SIZE, 10, gen, dev), lr)
    torch.cuda.synchronize()
    want_model = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    want_opt = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                for i, s in state.optimizer.state_dict()["state"].items()}

    def size_mb(path: Path) -> float:
        files = [path] if path.is_file() else [p for p in path.rglob("*") if p.is_file()]
        return sum(p.stat().st_size for p in files) / 1e6

    def timed(fn) -> tuple:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    out = {"card": smi, "params": sum(p.numel() for p in state.model.parameters()),
           "adam_tensors": sum(len(s) for s in want_opt.values())}
    _, out["file_ms"] = timed(lambda: checkpoint.save_checkpoint(tmp / "file.pt", state, 0))
    writer = AsyncCheckpointWriter()
    _, out["file_async_submit_ms"] = timed(lambda: writer.submit(tmp / "file_async.pt", state, 0))
    _, wait_ms = timed(writer.wait)
    out["file_async_write_ms"] = out["file_async_submit_ms"] + wait_ms
    _, out["dir_ms"] = timed(lambda: checkpoint_orbax.save_checkpoint(tmp / "dir", state, 0))
    fut, out["dir_async_submit_ms"] = timed(lambda: checkpoint_orbax.save_checkpoint(
        tmp / "dir_async", state, 0, use_async=True))
    keypoints_train_step(state, train_batch(CKPT_BATCH, CKPT_SIZE, 10, gen, dev), lr)  # the next step
    _, wait_ms = timed(lambda: fut.result(timeout=300))
    out["dir_async_write_ms"] = out["dir_async_submit_ms"] + wait_ms
    out["file_mb"], out["dir_mb"] = size_mb(tmp / "file.pt"), size_mb(tmp / "dir")
    out["dir_files"] = sorted(str(p.relative_to(tmp / "dir")) for p in (tmp / "dir").rglob("*") if p.is_file())

    def restore(load):
        other = fresh(SEED + 1)
        _, ms = timed(lambda: load(other))
        equal = all(torch.equal(v, want_model[k]) for k, v in other.model.state_dict().items()) and all(
            torch.equal(v, want_opt[i][k]) if torch.is_tensor(v) else v == want_opt[i][k]
            for i, s in other.optimizer.state_dict()["state"].items() for k, v in s.items())
        return ms, equal and other.step == 1

    restores = {
        "file": lambda s: checkpoint.load_train_state(s, checkpoint.load_checkpoint(tmp / "file.pt")),
        "file_async": lambda s: checkpoint.load_train_state(
            s, checkpoint.load_checkpoint(tmp / "file_async.pt")),
        "dir": lambda s: checkpoint_orbax.load_train_state(s, checkpoint_orbax.load_checkpoint(tmp / "dir")),
        "dir_async": lambda s: checkpoint_orbax.load_train_state(
            s, checkpoint_orbax.load_checkpoint(tmp / "dir_async"))}
    for name, load in restores.items():
        out[f"{name}_restore_ms"], equal = restore(load)
        if not equal:
            raise AssertionError(f"phase 16: {name} checkpoint restored W32's state differently")
    log(f"phase 16 checkpoints, W32 ({out['params']} parameters) + Adam ({out['adam_tensors']} "
        f"tensors): file {out['file_ms']:.0f} ms, {out['file_mb']:.1f} MB (async submit "
        f"{out['file_async_submit_ms']:.0f}, write {out['file_async_write_ms']:.0f}), restore "
        f"{out['file_restore_ms']:.0f} ms; directory {out['dir_ms']:.0f} ms, {out['dir_mb']:.1f} MB "
        f"{out['dir_files']} (async submit {out['dir_async_submit_ms']:.0f}, write "
        f"{out['dir_async_write_ms']:.0f}), restore {out['dir_restore_ms']:.0f} ms; every restore bit "
        f"for bit the saved state, the async ones although a step followed the submit  [{smi}]")
    return out


def monitor_check(tmp: Path, smi: str) -> dict:
    """(3) ``GpuInfoMonitor``: one sample, its in-use and peak GB equal to
    ``memory_allocated``'s and ``max_memory_allocated``'s, its limit to
    ``mem_get_info``'s total, its in-use within what ``mem_get_info`` says
    the card uses; started, it writes its file."""
    import re

    import torch

    from human_pose_tpu_torch.loggers import GpuInfoMonitor

    mon = GpuInfoMonitor(str(tmp / "gpu.log"), interval_s=0.05)
    line = mon.sample().splitlines()[1]
    free, total = torch.cuda.mem_get_info(0)
    allocated, peak = torch.cuda.memory_allocated(0), torch.cuda.max_memory_allocated(0)
    m = re.fullmatch(r"  (.+) #0: ([\d.]+)/([\d.]+) GB \(peak ([\d.]+) GB\)", line)
    if not m or m.group(1) != torch.cuda.get_device_name(0) or float(m.group(2)) != round(allocated / 1e9, 2) \
            or float(m.group(3)) != round(total / 1e9, 2) or float(m.group(4)) != round(peak / 1e9, 2) \
            or allocated > total - free:
        raise AssertionError(f"phase 16: monitor line {line!r} against allocated {allocated}, peak "
                             f"{peak}, mem_get_info ({free}, {total})")
    mon.start()
    time.sleep(0.3)
    mon.stop()
    if not (tmp / "gpu.log").is_file():
        raise AssertionError("phase 16: the monitor wrote no file")
    log(f"phase 16 monitor: '{line.strip()}' (mem_get_info: {(total - free) / 1e9:.2f} GB used of "
        f"{total / 1e9:.2f})  [{smi}]")
    return {"line": line.strip(), "mem_get_info_used_gb": (total - free) / 1e9, "total_gb": total / 1e9}


def rle_check(rng) -> dict:
    """(4) the native RLE decode against its NumPy loop on ``RLE_MASKS``
    seeded run-length lists at ``RLE_HW`` (runs past h*w and an empty list
    among them): equal bytes; host ms a mask of each."""
    from human_pose_tpu_torch.data.rle import rle_to_mask, rle_to_mask_plain

    h, w = RLE_HW
    cases = [[]] + [[int(c) for c in rng.integers(0, h * w // int(rng.integers(4, 200)),
                                                    int(rng.integers(1, 400)))] for _ in range(RLE_MASKS - 1)]
    for counts in cases:
        if rle_to_mask(counts, h, w).tobytes() != rle_to_mask_plain(counts, h, w).tobytes():
            raise AssertionError(f"phase 16: native RLE decode differs from NumPy on {len(counts)} counts")
    out = {"masks": len(cases), "hw": RLE_HW,
           "native_ms": host_ms(lambda: [rle_to_mask(c, h, w) for c in cases]) / len(cases),
           "numpy_ms": host_ms(lambda: [rle_to_mask_plain(c, h, w) for c in cases]) / len(cases)}
    log(f"phase 16 RLE decode at {h}x{w}: native == NumPy on {len(cases)} masks; host ms a mask "
        f"native {out['native_ms']:.3f}, NumPy {out['numpy_ms']:.3f}")
    return out


def sharded_eval_phase(dev, counted, smi: str) -> dict:
    """Phase 16: distributed COCO evaluation (``sharded_eval``), the
    directory checkpoint backend (``checkpoint_dir_cost``), the
    card-memory monitor (``monitor_check``) and the native RLE decode
    (``rle_check``). Raises on any miss; returns the phase's record."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "eval").mkdir()
        (tmp / "ckpt").mkdir()
        out["eval"] = sharded_eval(dev, counted, smi, tmp / "eval")
        out["checkpoint"], out["checkpoint_launches"] = counted(
            lambda: checkpoint_dir_cost(dev, tmp / "ckpt", smi),
            "phase 16 (checkpoints of W32's Adam state)", {})
        out["monitor"] = monitor_check(tmp, smi)
    out["rle"] = rle_check(np.random.default_rng(SEED + 16))
    out["launches"] = out["eval"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 (distributed eval, checkpoint directories, monitor, RLE): {out['seconds']:.1f}s")
    return out


def sharded_eval_only(dev, smi: str) -> int:
    """Phase 16 alone: build the dense refine and the grouping, then the
    phase. Prints the phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"sharded_eval": sharded_eval_phase(dev, counted, smi)}), flush=True)
    return 0


# phase 17: model parallelism on one card: the 4-segment pipeline with
# every segment on cuda:0, the pipelined inference model, and the train
# step on (data, space) and (data, space, model) meshes of one rank
PAR_BATCH = 8  # W32 at 512^2: the pipeline's batch and the mesh step's
PAR_PERSONS = 30
PAR_STEPS = 3  # timed steps a turn (turns plain, 2-D, 3-D, 3-D, 2-D, plain)
# the JAX package's per-unit times on a v5e behind partition_for's table
# (ms an image: stem 0.45, stage1 0.22, stage2 0.23, stage3 1.22, stage4
# 1.13, head 1.0): its 4-segment split's segments and their max / mean
V5E_SEGMENT_MS = (0.90, 1.22, 1.13, 1.0)


def pipeline_timing(dev, model, smi: str) -> dict:
    """(1) ``PipelinedModel`` of the W32 model with ``DEFAULT_PARTITION``
    and ``cuda:0`` as each segment's device against the monolithic eval
    forward on a seeded batch of ``PAR_BATCH`` at ``SIZE``, float32 and
    bfloat16: the largest output difference (float32 within 1e-4 of the
    outputs' scale), ms a batch (CUDA events; microbatches of
    ``_pipeline_microbatch``) and img/s
    of each, and each segment's ms on the whole batch, against the v5e
    balance that ``partition_for`` assumed."""
    import contextlib

    import torch

    from human_pose_tpu_torch.inference.models import _pipeline_microbatch
    from human_pose_tpu_torch.parallel import DEFAULT_PARTITION, PipelinedModel

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn((PAR_BATCH, 3, SIZE, SIZE), generator=gen, device=dev)
    mb = _pipeline_microbatch(PAR_BATCH, len(DEFAULT_PARTITION))
    out = {"batch": PAR_BATCH, "size": SIZE, "microbatch": mb,
           "partition": [list(seg) for seg in DEFAULT_PARTITION],
           "v5e_segment_ms": list(V5E_SEGMENT_MS),
           "v5e_max_over_mean": max(V5E_SEGMENT_MS) / float(np.mean(V5E_SEGMENT_MS))}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        pipe = PipelinedModel(model, DEFAULT_PARTITION, [dev] * len(DEFAULT_PARTITION), dtype=dtype)
        compute = (contextlib.nullcontext if dtype == torch.float32
                   else lambda: torch.autocast("cuda", dtype=dtype))

        @torch.no_grad()
        def mono():
            with compute():
                return model(x)

        def flat(o):
            return [*o[0], o[1]]

        want, got = flat(mono()), flat(pipe(x, microbatch_size=mb))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        # float32 within 1e-4 of the outputs' scale: random W32's heatmaps
        # reach the thousands, where float32's spacing is 2.4e-4
        if not all(bool(torch.isfinite(g).all()) for g in got) or (
                dtype == torch.float32 and err > 1e-4 * scale):
            raise AssertionError(f"pipeline {name}: max |pipe - mono| {err} (scale {scale})")
        pipe_ms = cuda_ms(lambda: pipe(x, microbatch_size=mb), iters=3)
        mono_ms = cuda_ms(mono, iters=3)
        seg_ms, h = [], x
        for seg, _ in pipe.segments:
            @torch.no_grad()
            def run(seg=seg, h=h):
                with compute():
                    return seg(h)
            seg_ms.append(cuda_ms(run, iters=3))
            h = run()
        out[name] = {"max_abs_err": err, "out_scale": scale, "max_rel_err": err / scale,
                     "pipe_ms": pipe_ms, "mono_ms": mono_ms,
                     "pipe_img_s": PAR_BATCH / pipe_ms * 1e3, "mono_img_s": PAR_BATCH / mono_ms * 1e3,
                     "segment_ms": seg_ms,
                     "segment_ms_an_image": [t / PAR_BATCH for t in seg_ms],
                     "max_over_mean": max(seg_ms) / float(np.mean(seg_ms))}
        log(f"pipeline W32 {name} bs{PAR_BATCH} {SIZE}^2, 4 segments on {dev} (microbatch {mb}): "
            f"max |pipe - mono| {err:.3g} (outputs up to {scale:.3g}: {err / scale:.3g} of the "
            f"scale); {pipe_ms:.2f} ms a batch "
            f"({PAR_BATCH / pipe_ms * 1e3:.1f} img/s) vs monolithic {mono_ms:.2f} ms "
            f"({PAR_BATCH / mono_ms * 1e3:.1f} img/s); segments "
            + ", ".join(f"{t:.2f}" for t in seg_ms)
            + f" ms (max/mean {out[name]['max_over_mean']:.2f}; the v5e table's "
            f"{out['v5e_max_over_mean']:.2f})  [{smi}]")
    return out


def pipelined_inference(dev, model, counted, smi: str) -> dict:
    """(2) ``InferenceKeypointsModel(pipeline_devices=1)`` (the walk through
    ``partition_for(1)``) against ``pipeline_devices=0`` on the W32 model
    with flip, a seeded 480x640 raw image, cuDNN deterministic: exactly
    one launch of the dense refine and of the grouping, each kernel equal
    to its plain version on that call's inputs, the decisions equal; the
    kernels' times and bounds, and ``__call__``'s host ms of both."""
    import torch

    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    kw = dict(det_thr=DET_THR, tag_thr=TAG_THR, max_num_people=M, input_size=SIZE, use_flip=True)
    raw = np.random.default_rng(SEED + 17).integers(0, 256, (*INFER_RAW_HW, 3), dtype=np.uint8)
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        mono = InferenceKeypointsModel(model, device=dev, **kw)
        piped = InferenceKeypointsModel(model, pipeline_devices=1, device=dev, **kw)
        want = mono(raw)
        got, launches = counted(lambda: piped(raw), "phase 17 pipelined inference model (flip)",
                                {"match_by_tag": 1, "refine_argmax": 1})
        equal = (np.array_equal(got.kpts_coords, want.kpts_coords)
                 and np.array_equal(got.obj_scores, want.obj_scores))
        seen = record_kernel_inputs(lambda: piped(raw))
        hm, tg, prev, cnt = seen["refine_argmax"]
        cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
        refine_equal = torch.equal(cuda_decode.refine_argmax_batch(hm, tg, prev, cnt),
                                   cuda_decode.refine_argmax_batch_plain(hm, tg, prev, cnt))
        t0 = time.perf_counter()
        plain = cuda_match.match_by_tag_batched_plain(cand, det_thr, tag_thr, order, persons)
        torch.cuda.synchronize()
        match_plain_ms = (time.perf_counter() - t0) * 1e3
        match_equal = all(torch.equal(a, b) for a, b in zip(
            cuda_match.match_by_tag_batched(cand, det_thr, tag_thr, order, persons), plain))
        if not (equal and refine_equal and match_equal):
            raise AssertionError(f"pipelined inference: decisions equal {equal}, refine == plain "
                                 f"{refine_equal}, grouping == plain {match_equal}")
        rec = {"launches": launches, "persons": len(got.kpts_coords), "decisions_equal": equal,
               "model_input_hw": piped.model_input_shape,
               **path_kernel_times(lambda: piped(raw)),
               "refine_plain_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(
                   hm, tg, prev, cnt), iters=2),
               "match_plain_ms": match_plain_ms,
               "call_host_ms": {"pipeline_devices=1": host_ms(lambda: piped(raw), iters=3),
                                "monolithic": host_ms(lambda: mono(raw), iters=3)}}
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    log(f"pipelined inference model (pipeline_devices=1, flip, {rec['model_input_hw']}): "
        f"{rec['persons']} persons, decisions == pipeline_devices=0 (cuDNN deterministic), one "
        f"launch of each kernel, each == plain on the call's inputs; refine {rec['refine_ms']:.4f} "
        f"ms (bound {rec['refine_bound_ms']:.4f}), grouping {rec['match_ms']:.4f} ms; __call__ "
        f"{rec['call_host_ms']}  [{smi}]")
    return rec


def count_collectives():
    """A context that counts the ``torch.distributed`` collectives and
    point-to-point batches called in it; yields the counts."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "batch_isend_irecv")
    counts = dict.fromkeys(names, 0)
    originals = {n: getattr(dist, n) for n in names}

    def counting(n):
        def call(*args, **kwargs):
            counts[n] += 1
            return originals[n](*args, **kwargs)
        return call

    @contextlib.contextmanager
    def ctx():
        try:
            for n in names:
                setattr(dist, n, counting(n))
            yield counts
        finally:
            for n, f in originals.items():
                setattr(dist, n, f)
    return ctx()


def mesh_step(dev, smi: str) -> dict:
    """(3) One float32 Adam step of W32 at ``SIZE`` (batch ``PAR_BATCH``, a
    card batch) without a mesh and on the (1, 1) and (1, 1, 1) meshes of
    an NCCL group of one (``shard_state_tensor``: the mesh modules, a
    tensor axis of 1 sharding nothing; ``shard_batch_spatial``; the tag
    gather and the moment-group reductions), cuDNN deterministic: metrics,
    parameters and buffers bit for bit equal; then ``PAR_STEPS`` steps a
    turn in turns plain, 2-D, 3-D, 3-D, 2-D, plain (host wall to a sync):
    the ms each path adds, and the collectives of one mesh step. The two
    tensor operators, which that step no longer runs, are held to the
    identity on the group of one (``tensor_operators_of_one``)."""
    import copy

    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.parallel import (
        make_mesh_2d, make_mesh_3d, shard_batch_spatial, shard_state_tensor,
    )
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    net = init_flax_default_(HigherHRNet(num_kpts=K, C=32, device=dev),
                             torch.Generator().manual_seed(SEED + 17))
    batch = train_batch(PAR_BATCH, SIZE, PAR_PERSONS, torch.Generator(device=dev).manual_seed(SEED + 17),
                        dev)
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    times = {"plain": [], "2d": [], "3d": []}
    try:
        with process_group_of_one():
            meshes = {"plain": None, "2d": make_mesh_2d(1, 1), "3d": make_mesh_3d(1, 1, 1)}
            states, batches, first = {}, {}, {}
            for name, mesh in meshes.items():
                model = copy.deepcopy(net)
                if mesh is not None:
                    shard_state_tensor(mesh, model)
                states[name] = TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                                                 device=dev, mesh=mesh)
                batches[name] = batch if mesh is None else shard_batch_spatial(mesh, batch)
                if name == "3d":
                    with count_collectives() as calls:
                        metrics = keypoints_train_step(states[name], batches[name], 1e-3)[1]
                    calls = dict(calls)
                else:
                    metrics = keypoints_train_step(states[name], batches[name], 1e-3)[1]
                first[name] = ({k: float(v) for k, v in metrics.items()},
                               {k: v.cpu() for k, v in model.state_dict().items()})
            for name in ("2d", "3d"):
                same = first[name][0] == first["plain"][0] and all(
                    torch.equal(v, first["plain"][1][k]) for k, v in first[name][1].items())
                if not same:
                    raise AssertionError(f"the ({', '.join('1' * len(meshes[name].dims))}) mesh step "
                                         "differs from the plain step")

            def step(name):
                keypoints_train_step(states[name], batches[name], 1e-3)
                torch.cuda.synchronize()

            for name in ("plain", "2d", "3d", "3d", "2d", "plain"):
                times[name] += [host_ms(lambda: step(name)) for _ in range(PAR_STEPS)]
            busy = {name: profile_breakdown(lambda: step(name))[0] for name in ("plain", "3d")}
            one = collective_ms(meshes["3d"], dev)
            tensor_operators_of_one(meshes["3d"], dev)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    rec = {"batch": PAR_BATCH, "size": SIZE, "dtype": "float32", "bit_equal": True,
           "loss": first["plain"][0]["loss"], "collectives_3d_step": calls,
           **{f"{k}_ms": float(np.median(v)) for k, v in times.items()},
           **{f"{k}_ms_all": v for k, v in times.items()}}
    rec["spatial_adds_ms"] = rec["2d_ms"] - rec["plain_ms"]
    rec["tensor_adds_ms"] = rec["3d_ms"] - rec["2d_ms"]
    rec["device_busy_ms"] = busy
    rec["collective_ms"] = one
    log(f"mesh step W32 float32 bs{PAR_BATCH} {SIZE}^2 (cuDNN deterministic): the (1, 1) and "
        f"(1, 1, 1) meshes of an NCCL group of one == the plain step bit for bit (metrics, "
        f"parameters, buffers); {rec['plain_ms']:.1f} ms plain, {rec['2d_ms']:.1f} ms (1, 1) "
        f"(spatial path {rec['spatial_adds_ms']:+.1f}), {rec['3d_ms']:.1f} ms (1, 1, 1) (over "
        f"(1, 1): {rec['tensor_adds_ms']:+.1f}; {calls} a step); medians of {2 * PAR_STEPS} "
        f"in turns; device busy in one step {busy} ms; one collective of the tensor group on a "
        f"[{PAR_BATCH}, 32, {SIZE // 4}, {SIZE // 4}] activation: {one}  [{smi}]")
    return rec


def tensor_operators_of_one(mesh, dev) -> None:
    """``parallel/tensor.py``'s two operators (the input's identity with an
    all-reduce backward, the channel all-gather with a slicing backward) on
    ``mesh``'s tensor group of one, through NCCL, on a float32 ``[PAR_BATCH,
    32, SIZE/4, SIZE/4]`` activation: forward and backward the identity,
    bit for bit. Raises on a miss."""
    import torch

    from human_pose_tpu_torch.parallel.tensor import _CopyToTensorGroup, _GatherChannels

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn((PAR_BATCH, 32, SIZE // 4, SIZE // 4), generator=gen, device=dev, requires_grad=True)
    g = torch.randn(x.shape, generator=gen, device=dev)
    y = _GatherChannels.apply(_CopyToTensorGroup.apply(x, mesh.tensor_group), mesh)
    y.backward(g)
    torch.cuda.synchronize()
    if not (torch.equal(y, x) and torch.equal(x.grad, g)):
        raise AssertionError("the tensor operators over an NCCL group of one are not the identity")
    log(f"tensor operators over the NCCL tensor group of one on {tuple(x.shape)}: forward and "
        "backward the identity, bit for bit")


def collective_ms(mesh, dev, calls: int = 50) -> dict:
    """ms of one all-gather and of one all-reduce over ``mesh``'s tensor
    group on a float32 ``[PAR_BATCH, 32, SIZE/4, SIZE/4]`` activation (W32's
    widest branch): ``calls`` of each, host wall to a sync and CUDA events
    on the current stream, divided by ``calls``."""
    import torch
    import torch.distributed as dist

    y = torch.randn((PAR_BATCH, 32, SIZE // 4, SIZE // 4), device=dev)
    parts = [torch.empty_like(y) for _ in range(mesh.n_tensor)]
    ops = {"all_gather": lambda: dist.all_gather(parts, y, group=mesh.tensor_group),
           "all_reduce": lambda: dist.all_reduce(y, group=mesh.tensor_group)}
    out = {}
    for name, op in ops.items():
        def run(op=op):
            for _ in range(calls):
                op()
        out[f"{name}_host_ms"] = host_ms(lambda: (run(), torch.cuda.synchronize())) / calls
        out[f"{name}_event_ms"] = cuda_ms(run, iters=1) / calls
    return out


def parallel_phase(dev, model, counted, smi: str) -> dict:
    """Phase 17: the pipeline (``pipeline_timing``), the pipelined
    inference model (``pipelined_inference``) and the mesh step
    (``mesh_step``). Raises on any miss; returns the phase's record."""
    t_phase = time.perf_counter()
    out = {"card": smi, "pipeline": pipeline_timing(dev, model, smi),
           "inference": pipelined_inference(dev, model, counted, smi)}
    out["mesh_step"], out["mesh_step_launches"] = counted(lambda: mesh_step(dev, smi),
                                                          "phase 17 (the mesh steps)", {})
    out["launches"] = out["inference"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17 (pipeline, pipelined inference, mesh step): {out['seconds']:.1f}s")
    return out


def model_parallel_only(dev, smi: str) -> int:
    """Phase 17 alone: build the dense refine and the grouping, make the
    main path's W32 model, then the phase. Prints the phase's record as one
    JSON object last."""
    import torch

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    counted = make_counted(kernel_counters())
    print(json.dumps({"model_parallel": parallel_phase(dev, model.eval(), counted, smi)}), flush=True)
    return 0


# phase 18, the benchmark CLIs at their defaults: bench_decompose (W32, batch
# 8 at 512^2, 10 iterations a pass, a warm-up pass and a timed one) and
# bench_train (keypoints bs36 512^2 Adam, 5 + 5 steps; classification bs80
# 224^2 SGD, 10 + 10 steps)
BENCH_BATCH, BENCH_ITERS = 8, 10
BENCH_DECODE_STAGES = ("decode_sparse", "decode_noise", "e2e")  # a decode_batch call an iteration
# images of each map set whose grouping is held against the plain version:
# the whole batch of the sparse maps (~0.35 s an image plain), the first
# image of the noise maps (~4 s an image plain: every joint's 30 rows valid)
BENCH_MATCH_HELD = {"decode_sparse": BENCH_BATCH, "decode_noise": 1}


def bench_stage_kernels(stage: str, maps: tuple, counted, smi: str) -> dict:
    """One decode stage of ``bench_decompose`` on its batch of maps: one
    launch each of the dense refine and the grouping a ``decode_maps``
    call, with their inputs kept; on those inputs the refine equals its
    plain version on the whole batch, the grouping on the first
    ``BENCH_MATCH_HELD[stage]`` images, and no image holds more persons than
    the cap; the kernels' times and bounds on the batch's inputs, the plain
    refine's time, the plain grouping's on the held images; valid candidate
    rows and persons per image."""
    import torch

    from human_pose_tpu_torch.bin import bench_decompose
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    out = []
    seen, launches = counted(lambda: record_kernel_inputs(lambda: out.append(bench_decompose.decode_maps(
        *maps, SIZE))), f"bench {stage} (batch {BENCH_BATCH})", {"match_by_tag": 1, "refine_argmax": 1})
    joints, scores, valid = out[0]
    if not (bool(torch.isfinite(joints).all()) and bool(torch.isfinite(scores).all())):
        raise AssertionError(f"bench {stage}: non-finite joints or scores")
    ref_in = seen["refine_argmax"]
    cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
    refine_equal = torch.equal(cuda_decode.refine_argmax_batch(*ref_in),
                               cuda_decode.refine_argmax_batch_plain(*ref_in))
    held = BENCH_MATCH_HELD[stage]
    t0 = time.perf_counter()
    plain = cuda_match.match_by_tag_batched_plain(cand[:held], det_thr, tag_thr, order, persons)
    torch.cuda.synchronize()
    match_plain_ms = (time.perf_counter() - t0) * 1e3
    got = cuda_match.match_by_tag_batched(cand, det_thr, tag_thr, order, persons)
    match_equal = all(torch.equal(a[:held], b) for a, b in zip(got, plain))
    count = int(got[1].max())
    if not (refine_equal and match_equal and count <= persons):
        raise AssertionError(f"bench {stage}: refine == plain on the batch {refine_equal}, grouping "
                             f"== plain on {held} image(s) {match_equal}, {count} persons against a "
                             f"cap of {persons}")
    rec = {"launches": launches, "persons_per_image": valid.sum(1).tolist(),
           "valid_rows_per_image": (cand[..., 2] > DET_THR).sum((1, 2)).tolist(),
           "person_cap": persons, "refine_held_images": cand.shape[0], "match_held_images": held,
           **kernel_times(seen),
           "refine_plain_ms": cuda_ms(lambda: cuda_decode.refine_argmax_batch_plain(*ref_in), iters=2),
           "match_plain_ms_held_images": match_plain_ms,
           "match_bound_by": match_bound(cand, persons)[1],
           "refine_bound_by": refine_bound(*ref_in)[1]}
    log(f"bench {stage}: persons per image {rec['persons_per_image']}, valid candidate rows per "
        f"image {rec['valid_rows_per_image']} of {K * M}; refine == plain on all {cand.shape[0]} "
        f"images, grouping == plain on {held} (plain {match_plain_ms:.0f} ms), at most {count} "
        f"persons (cap {persons}); batch of {BENCH_BATCH}: refine {rec['refine_ms']:.4f} ms (bound "
        f"{rec['refine_bound_ms']:.4f}, plain {rec['refine_plain_ms']:.2f}), grouping "
        f"{rec['match_ms']:.4f} ms  [{smi}]")
    return rec


# a decode stage's trace is whole only if it holds the two kernels each
# decode_batch call launches once (a trace has been seen to lose them)
BENCH_TRACE_KERNELS = ("refine kernel", "grouping kernel")


def bench_busy(dev, smi: str) -> dict:
    """Each ``bench_decompose`` stage's one iteration at its defaults (the
    CLI's own stage functions): the host wall of a call ended by a sync
    (median of 3) and the card's busy time under the profiler (the sum of
    its kernels' time, ``profile_breakdown``), each an image, and the busy
    share. A decode stage is profiled again, up to 3 times in all, until
    its trace holds ``BENCH_TRACE_KERNELS``; ``trace_whole`` says if it
    did (None for the forward, which has no kernel to look for). Raises if
    the profiler saw no device time."""
    import torch

    from human_pose_tpu_torch.bin import bench_decompose

    out = {}
    for stage, fn in bench_decompose.stage_fns(BENCH_BATCH, SIZE, dev).items():
        wall = host_ms(lambda: (fn(0), torch.cuda.synchronize()), iters=3)
        want = () if stage == "forward" else BENCH_TRACE_KERNELS
        for attempt in range(1, 4):
            log(f"profile of one bench_decompose {stage} iteration (batch {BENCH_BATCH}), attempt {attempt}:")
            busy, groups = profile_breakdown(lambda: fn(0))
            if busy is None:
                raise AssertionError(f"bench {stage}: the profiler saw no device time")
            if all(g in groups for g in want):
                break
        whole = all(g in groups for g in want) if want else None
        out[stage] = {"wall_ms_per_img": wall / BENCH_BATCH, "busy_ms_per_img": busy / BENCH_BATCH,
                      "busy_share": busy / wall, "trace_whole": whole, "attempts": attempt,
                      "busy_groups_ms": groups}
        log(f"bench {stage}: {wall / BENCH_BATCH:.3f} ms an image host wall with a sync, the card "
            f"busy {busy / BENCH_BATCH:.3f} ms an image ({busy / wall:.1%}); trace whole: {whole} "
            f"after {attempt} attempt(s)  [{smi}]")
    torch.cuda.empty_cache()
    return out


def bench_phase(dev, counted, smi: str, phase9: dict | None = None,
                phase12: dict | None = None) -> dict:
    """Phase 18: the benchmark CLIs through their ``main``. (1)
    ``bench_decompose`` at its defaults with every counter zeroed: its four
    records in order, finite, and one launch each of the dense refine and
    the grouping per ``decode_batch`` call (three stages, two passes of
    ``BENCH_ITERS``); each stage's busy share (``bench_busy``); (2) its two
    map sets alone (``bench_stage_kernels``);
    (3) ``bench_train`` for keypoints and for classification at their
    defaults, no kernel launched: the records, finite losses, the peak
    memory, set beside phases 9 and 12's bfloat16 steps where this process
    ran them. Raises on any miss; returns the phase's record."""
    import torch

    from human_pose_tpu_torch.bin import bench_decompose, bench_train

    t_phase = time.perf_counter()
    calls = len(BENCH_DECODE_STAGES) * 2 * BENCH_ITERS
    records, launches = counted(
        lambda: bench_decompose.main([f"--batch={BENCH_BATCH}", f"--iters={BENCH_ITERS}",
                                      f"--size={SIZE}"]),
        f"bin.bench_decompose (W32 bs{BENCH_BATCH} {SIZE}^2, {BENCH_ITERS} iterations a pass)",
        {"match_by_tag": calls, "refine_argmax": calls})
    if ([r["stage"] for r in records] != list(bench_decompose.STAGES)
            or not all(np.isfinite(r[key]) and r[key] > 0 for r in records
                       for key in ("ms_per_img", "img_per_s", "stream_ms_per_img"))
            or any(r["platform"] != "gpu" for r in records)):
        raise AssertionError(f"bench_decompose records: {records}")
    out = {"card": smi, "decompose": {r["stage"]: r for r in records}, "launches": launches}
    log("bin.bench_decompose: " + "; ".join(
        f"{r['stage']} {r['ms_per_img']:.3f} ms an image host wall ({r['img_per_s']:.1f} img/s), "
        f"{r['stream_ms_per_img']:.3f} by events" for r in records) + f"  [{smi}]")
    out["busy"] = bench_busy(dev, smi)
    maps = bench_decompose.bench_maps(BENCH_BATCH, SIZE, dev)
    out["stages"] = {stage: bench_stage_kernels(stage, m, counted, smi) for stage, m in maps.items()}
    del maps

    ref = {"keypoints": (phase9 or {}).get("bfloat16", {}).get("ms"),
           "classification": ((phase12 or {}).get("steps") or {}).get("bfloat16", {}).get("ms")}
    out["train"] = {}
    for task in ("keypoints", "classification"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec, rec["launches"] = counted(lambda: bench_train.main([f"--task={task}"]),
                                       f"bin.bench_train {task}", {})
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["phase_step_ms"] = ref[task]
        if not (np.isfinite(rec["loss"]) and rec["value"] > 0 and rec["platform"] == "gpu"):
            raise AssertionError(f"bench_train {task}: {rec}")
        out["train"][task] = rec
        beside = "not run in this process" if ref[task] is None else f"{ref[task]:.1f} ms"
        log(f"bin.bench_train {task}: {rec['metric']}: {rec['value']:.2f} img/s, "
            f"{rec['ms_per_step']:.1f} ms a step, loss {rec['loss']:.6f}, peak {rec['peak_gib']:.2f} GiB; "
            f"phase {9 if task == 'keypoints' else 12}'s bfloat16 step: {beside}  [{smi}]")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 (the benchmark CLIs): {out['seconds']:.1f}s")
    return out


def bench_only(dev, smi: str) -> int:
    """Phase 18 alone: build the dense refine and the grouping, then the
    phase. Prints the phase's record as one JSON object last."""
    from human_pose_tpu_torch.ops import _build

    log(f"build: per kernel {_build.build_kernels(('refine_argmax', 'match_by_tag'))}")
    counted = make_counted(kernel_counters())
    print(json.dumps({"bench": bench_phase(dev, counted, smi)}), flush=True)
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


BN_BATCH = 36  # the W32 training point
BN_COLD_BYTES = 256 * 2**20  # inputs rotated through at least this many bytes: L2 (50 MB) cold
BN_CALLS = {"kernel": 10, "plain": 3, "library": 3}  # calls a device-ms reading
BN_STEP_ROUNDS = 2  # rounds of (pair, library, library, pair) timed steps
BN_HOST_CALLS = 500  # calls a host-cost reading


def bn_inputs(gen, shape, dtype, dev) -> tuple:
    """``(grad_y, x, weight, mean, invstd)`` of one BatchNorm backward: x
    with a mean and a scale of its own a channel, float32 moments of it."""
    import torch

    c = shape[1]
    kw = {"generator": gen, "device": dev}
    x = (torch.randn(shape, **kw) * (0.1 + 3 * torch.rand((1, c, 1, 1), **kw))
         + torch.randn((1, c, 1, 1), **kw)).to(dtype)
    gy = torch.randn(shape, **kw).to(dtype)
    mean = x.float().mean((0, 2, 3))
    invstd = torch.rsqrt((x.float() - mean[:, None, None]).square().mean((0, 2, 3)) + 1e-5)
    return gy, x, torch.linspace(0.5, 1.5, c, device=dev), mean, invstd


def bn_library(grad_y, x, weight, mean, invstd, need_x=True):
    """The route the kernel pair replaced, as one call: the library's
    ``native_batch_norm_backward`` for grad_x and four float32 passes for
    the parameter gradients (``models/norm.py`` before the pair)."""
    import torch

    grad_x = None
    if need_x:
        grad_x = torch.ops.aten.native_batch_norm_backward(
            grad_y, x, weight, None, None, mean, invstd, True, 1e-5, [True, False, False])[0]
    dims = (0, 2, 3)
    grad_b = grad_y.sum(dims, dtype=torch.float32)
    grad_w = (x - mean[:, None, None]).mul_(grad_y).sum(dims).mul_(invstd)
    return grad_x, grad_w, grad_b


def record_bn_inputs(fn) -> dict:
    """Run ``fn`` once with the kernel pair's launch (``cuda_norm._launch``,
    behind ``batch_norm_backward``'s counter) wrapped and a forward hook on
    every module: ``{"inputs": {(C, H, W): the arguments of the first launch
    at that shape}, "calls": {(C, H, W): launches of the pair}, "forwards":
    train-mode BatchNorm2d forwards of a bf16 or fp16 x}``. Restores both
    after."""
    import torch

    from human_pose_tpu_torch.models.norm import BatchNorm2d
    from human_pose_tpu_torch.ops import cuda_norm

    launch = cuda_norm._launch
    seen = {"inputs": {}, "calls": {}, "forwards": 0}

    def recorder(*args, **kwargs):
        key = tuple(args[1].shape[1:])
        seen["inputs"].setdefault(key, tuple(t.detach() for t in args[:5]))
        seen["calls"][key] = seen["calls"].get(key, 0) + 1
        return launch(*args, **kwargs)

    def hook(mod, inputs, out):
        if (isinstance(mod, BatchNorm2d) and mod.training
                and inputs[0].dtype in (torch.bfloat16, torch.float16)):
            seen["forwards"] += 1

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    cuda_norm._launch = recorder
    try:
        fn()
    finally:
        cuda_norm._launch = launch
        handle.remove()
    return seen


def bn_errors(got, args) -> dict:
    """The pair's result against float64 of the same formulas: grad_x's
    largest error beyond one rounding of its dtype, over its scale, and the
    parameter gradients' largest error over their scale."""
    import torch

    ulp = 2 ** -8 if args[1].dtype == torch.bfloat16 else 2 ** -11
    gy, x, weight, mean, invstd = (t.double() for t in args)
    c = (None, slice(None), None, None)
    n = x.numel() / x.shape[1]
    sum_b = gy.sum((0, 2, 3))
    sum_w = (gy * (x - mean[c])).sum((0, 2, 3)) * invstd
    want = (weight * invstd)[c] * (gy - sum_b[c] / n - (x - mean[c]) * invstd[c] * sum_w[c] / n)
    excess = ((got[0].double() - want).abs() - ulp * want.abs()).max() / want.abs().max()
    return {"dx_excess_over_one_rounding": float(excess),
            "grad_w_rel": float((got[1].double() - sum_w).abs().max() / sum_w.abs().max()),
            "grad_b_rel": float((got[2].double() - sum_b).abs().max() / sum_b.abs().max())}


def bn_parity(got, plain) -> dict:
    """The pair's result against ``batch_norm_backward_plain``'s on the same
    inputs: grad_x's largest difference beyond two roundings of its dtype
    (each side rounds once from float32), over its scale, and the parameter
    gradients' largest difference over their scale."""
    import torch

    ulp = 2 ** -8 if got[0].dtype == torch.bfloat16 else 2 ** -11
    want = plain[0].float()
    excess = ((got[0].float() - want).abs() - 2 * ulp * want.abs()).max() / want.abs().max()
    return {"dx_excess_vs_plain": float(excess),
            "grad_w_rel_vs_plain": float((got[1] - plain[1]).abs().max() / plain[1].abs().max()),
            "grad_b_rel_vs_plain": float((got[2] - plain[2]).abs().max() / plain[2].abs().max())}


BN_SLEEP_TRIES = 4  # doublings of the sleep ahead of a device-ms reading


def device_ms(fn, calls: int) -> float:
    """Device ms of one ``fn()``: CUDA events around ``calls`` calls queued
    behind a sleep kernel that outlasts their launches, so that the events
    time the card's work and not the host's launches. (The profiler's kernel
    records lose rows in a long process.) Raises if the host still drained
    the queue after ``BN_SLEEP_TRIES`` doublings of the sleep."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    cycles_per_ms = 10**7 / start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_ms = 2 * calls * (time.perf_counter() - t0) * 1e3 + 1.0  # the host's launches, twice over
    for _ in range(BN_SLEEP_TRIES):
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        launched_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if launched_ms < 0.5 * sleep_ms:
            return start.elapsed_time(end) / calls
        sleep_ms *= 2
    raise AssertionError(f"device_ms: {calls} calls took {launched_ms:.1f} ms to launch, "
                         f"behind a sleep of {sleep_ms / 2:.1f} ms")


def bn_bound(x, l2_bytes: int) -> tuple:
    """The BatchNorm backward's device-memory bound of one call: ``(ms,
    bytes an element)``. The reduce reads x and grad_y, the apply reads them
    again and writes grad_x: 10 B an element in bf16, less the part of the
    second read the L2 can serve (up to its size): 6 B where x and grad_y fit
    in it together."""
    n, size = x.numel(), x.element_size()
    nbytes = 2 * (2 * size * n) + size * n - min(2 * size * n, l2_bytes)
    return nbytes / PEAK_BYTES_S * 1e3, nbytes / n


def bn_rows(dev, cases: list, smi: str) -> tuple:
    """Each ``(args, layers)`` of ``cases`` (one BatchNorm backward's
    ``(grad_y, x, weight, mean, invstd)`` and the step's layers of that
    shape, 0 for a check outside the step): the pair against its plain
    version on the card (``bn_parity``) and against float64
    (``bn_errors``), two calls bit-equal; its split and load width; device
    ms of the pair, the plain version and the library route on inputs
    rotated through ``BN_COLD_BYTES`` and at least two copies (CUDA events,
    ``device_ms``); the bound
    (``bn_bound``). Returns the rows and the step's totals (each ms times
    its layers) with the largest errors. Raises where the pair misses its
    tolerances."""
    import torch

    from human_pose_tpu_torch.ops import cuda_norm

    props = torch.cuda.get_device_properties(dev)
    l2_bytes = props.L2_cache_size
    rows = []
    totals = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "elements": 0,
              "layers": 0, "l2_bytes": l2_bytes}
    for args, layers in cases:
        x = args[1]
        n, c, h, w = x.shape
        got = cuda_norm.batch_norm_backward(*args)
        err = {**bn_parity(got, cuda_norm.batch_norm_backward_plain(*args)), **bn_errors(got, args)}
        if not (all(err[k] <= 1e-5 for k in ("dx_excess_vs_plain", "dx_excess_over_one_rounding"))
                and all(v <= 1e-4 for k, v in err.items() if k.startswith("grad_"))):
            raise AssertionError(f"bn backward {tuple(x.shape)} {x.dtype}: {err}")
        if not all(torch.equal(a, b) for a, b in zip(got, cuda_norm.batch_norm_backward(*args))):
            raise AssertionError(f"bn backward {tuple(x.shape)} {x.dtype}: two calls differ")
        copies = [args] + [tuple(t.clone() for t in args) for _ in range(
            max(1, -(-BN_COLD_BYTES // (2 * x.numel() * x.element_size())) - 1))]
        turn = iter(range(10**9))

        def rotated(fn):
            return lambda: fn(*copies[next(turn) % len(copies)])

        vec = cuda_norm.vector_width(h * w, x, args[0])
        bound_ms, per = bn_bound(x, l2_bytes)
        rec = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1], "layers": layers,
               "splits": cuda_norm.splits(c, n * h * w // vec, props.multi_processor_count),
               "vec": vec, "copies": len(copies),
               "kernel_ms": device_ms(rotated(cuda_norm.batch_norm_backward), BN_CALLS["kernel"]),
               "plain_ms": device_ms(rotated(cuda_norm.batch_norm_backward_plain), BN_CALLS["plain"]),
               "library_ms": device_ms(rotated(bn_library), BN_CALLS["library"]),
               "bound_ms": bound_ms, "bound_bytes_an_element": per, **err}
        rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
        rows.append(rec)
        log(f"bn backward {tuple(x.shape)} {rec['dtype']} x{layers}: pair {rec['kernel_ms']:.4f} ms "
            f"(S={rec['splits']}, vec {vec}), bound {bound_ms:.4f} ({per:.2f} B an element, "
            f"{100 * rec['bound_share']:.1f}%), plain {rec['plain_ms']:.4f}, library "
            f"{rec['library_ms']:.4f}; {err}  [{smi}]")
        totals["elements"] += layers * x.numel()
        totals["layers"] += layers
        for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms"):
            totals[key] += layers * rec[key]
        del copies, got
    for key in ("dx_excess_vs_plain", "grad_w_rel_vs_plain", "grad_b_rel_vs_plain",
                "dx_excess_over_one_rounding", "grad_w_rel", "grad_b_rel"):
        totals[key] = max(r[key] for r in rows)
    totals["bound_share"] = totals["bound_ms"] / totals["kernel_ms"] if totals["kernel_ms"] else None
    log(f"bn backward, the step's {totals['layers']} layers: {totals}  [{smi}]")
    return rows, totals


def bn_step_cases(seen: dict) -> list:
    """``bn_rows``' cases from ``record_bn_inputs``: each shape the step
    gave the pair, its inputs and its layers, the most elements first."""
    order = sorted(seen["inputs"], key=lambda k: -seen["calls"][k] * k[0] * k[1] * k[2])
    return [(seen["inputs"][key], seen["calls"][key]) for key in order]


def bn_step(dev, smi: str) -> tuple:
    """The W32 bs36 512^2 bfloat16 Adam step: one step with the pair's
    counter zeroed just before, 2 launches for each train-mode BatchNorm
    forward of the step required, its BatchNorm inputs kept
    (``record_bn_inputs``); ms a step by host wall with the pair and with the
    library route (``bn_library`` patched in, 0 launches of the pair) in
    turns, and each route's device ms a step in kernels named
    ``batch_norm_backward`` (profiler). Returns (record, the kept inputs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.ops import cuda_norm
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    model = HigherHRNet(num_kpts=K, C=32, device=dev)
    init_flax_default_(model, torch.Generator().manual_seed(SEED))
    state = TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                              dtype=torch.bfloat16, device=dev)
    batch = train_batch(BN_BATCH, SIZE, M, torch.Generator(device=dev).manual_seed(SEED), dev)
    pair = cuda_norm.batch_norm_backward
    counted = make_counted({"batch_norm_backward": pair})

    def step():
        metrics = keypoints_train_step(state, batch, 1e-3)[1]
        torch.cuda.synchronize()
        return metrics

    step()  # cuDNN's autotuning
    seen = {}
    _, counts = counted(lambda: seen.update(record_bn_inputs(step)), "W32 bs36 bf16 step, the pair",
                        lambda _: {"batch_norm_backward": 2 * seen["forwards"]})
    out = {"layers": seen["forwards"], "launches_a_step": {"pair": counts["batch_norm_backward"]},
           "ms": {"pair": [], "library": []}, "bn_backward_device_ms": {}}
    try:
        for route in ("pair", "library"):
            cuda_norm.batch_norm_backward = pair if route == "pair" else bn_library
            if route == "library":
                _, counts = counted(step, "W32 bs36 bf16 step, the library route",
                                    {"batch_norm_backward": 0})
                out["launches_a_step"][route] = counts["batch_norm_backward"]
            warm_up(step, 2.0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
            out["bn_backward_device_ms"][route] = sum(
                ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
                if ev.device_type == DeviceType.CUDA and "batch_norm_backward" in ev.name)
        for _ in range(BN_STEP_ROUNDS):
            for route in ("pair", "library", "library", "pair"):
                cuda_norm.batch_norm_backward = pair if route == "pair" else bn_library
                out["ms"][route].append(host_ms(step, iters=3))
    finally:
        cuda_norm.batch_norm_backward = pair
    out["img_per_s"] = {r: BN_BATCH / float(np.median(v)) * 1e3 for r, v in out["ms"].items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"bn backward W32 bs{BN_BATCH} bf16 step: {out}  [{smi}]")
    return out, seen


def bn_backward_only(dev, smi: str) -> int:
    """The short loop for the BatchNorm backward pair (module doc). Prints
    one JSON object last."""
    import torch

    from human_pose_tpu_torch.ops import _build, cuda_norm

    secs = _build.build_kernels(("batch_norm_backward",))
    log(f"build: {secs}")
    log_build(_build)
    step, seen = bn_step(dev, smi)
    cases = bn_step_cases(seen)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # fp16 at the two shapes with the most elements (not in the bf16 step)
    cases += [(bn_inputs(gen, tuple(args[1].shape), torch.float16, dev), 0) for args, _ in cases[:2]]
    rows, totals = bn_rows(dev, cases, smi)
    del seen, cases
    # host cost of a call where the card waits on the host: a small layer
    small = bn_inputs(gen, (2, 32, 8, 8), torch.bfloat16, dev)
    host_us = {}
    for name, fn in (("pair", cuda_norm.batch_norm_backward), ("library", bn_library)) * 2:
        host_us[name] = host_ms(lambda: ([fn(*small) for _ in range(BN_HOST_CALLS)],
                                         torch.cuda.synchronize())) / BN_HOST_CALLS * 1e3
    log(f"bn backward host us a call (2x32x8x8): {host_us}  [{smi}]")
    print(json.dumps({"bn_backward_only": {"card": smi, "build_s": secs, "shapes": rows,
                                           "step_totals": totals, "host_us_a_call": host_us,
                                           "step": step}}), flush=True)
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
                        help="run the training phase alone (it builds no decode kernel)")
    parser.add_argument("--train-data-only", action="store_true",
                        help="build the decode's kernels and run the training input pipeline's "
                             "phase alone")
    parser.add_argument("--train-engine-only", action="store_true",
                        help="build the decode's kernels and run the training engine's phase alone "
                             "(the W32 run through the training CLI, its resume, inference from its "
                             "last.pt, the engine's timing, the reduced run card vs CPU)")
    parser.add_argument("--classification-only", action="store_true",
                        help="run the ImageNet classification phase alone (it builds no decode "
                             "kernel)")
    parser.add_argument("--serve-only", action="store_true",
                        help="build the decode's kernels and run the serving and export phase alone")
    parser.add_argument("--zoo-only", action="store_true",
                        help="build the decode's two kernels and run phase 14 (the model zoo) alone")
    parser.add_argument("--dp-train-only", action="store_true",
                        help="build the decode's two kernels and run phase 15 (zoo and data-parallel "
                             "training) alone")
    parser.add_argument("--sharded-eval-only", action="store_true",
                        help="build the decode's two kernels and run phase 16 (distributed eval, "
                             "checkpoint directories, the memory monitor, the RLE decode) alone")
    parser.add_argument("--model-parallel-only", action="store_true",
                        help="build the decode's two kernels and run phase 17 (the pipeline, the "
                             "pipelined inference model, the mesh step) alone")
    parser.add_argument("--bn-backward-only", action="store_true",
                        help="build, check and time the BatchNorm backward pair alone, and the "
                             "W32 bs36 bfloat16 step with it and with the library route")
    parser.add_argument("--bench-only", action="store_true",
                        help="build the decode's two kernels and run phase 18 (bench_decompose and "
                             "bench_train through their main) alone")
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
    if args.train_engine_only:
        return train_engine_only(dev, smi)
    if args.classification_only:
        return classification_only(dev, smi)
    if args.serve_only:
        return serve_only(dev, smi)
    if args.zoo_only:
        return zoo_only(dev, smi)
    if args.dp_train_only:
        return dp_train_only(dev, smi)
    if args.sharded_eval_only:
        return sharded_eval_only(dev, smi)
    if args.model_parallel_only:
        return model_parallel_only(dev, smi)
    if args.bench_only:
        return bench_only(dev, smi)
    if args.bn_backward_only:
        return bn_backward_only(dev, smi)

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

    dense_want = {"match_by_tag": 1, "refine_argmax": 1, "batch_norm_backward": 0}
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
    # (bfloat16 alone: the yaml's dtype; --train-data-only runs float32 too)
    train_data_rec = train_data_phase(dev, counted, smi, train_rec, float32=False)

    # 11. the training engine
    train_engine_rec = train_engine_phase(dev, counted, smi, train_data_rec)

    # 12. ImageNet classification
    cls_rec = classification_phase(dev, counted, smi)

    # 13. serving and export
    serve_rec = serve_phase(dev, counted, smi)

    # 14. the model zoo
    zoo_rec = zoo_phase(dev, counted, smi)

    # 15. zoo and data-parallel training
    dp_rec = dp_train_phase(dev, counted, smi)

    # 16. distributed eval, checkpoint directories, the monitor, the RLE decode
    sharded_rec = sharded_eval_phase(dev, counted, smi)

    # 17. model parallelism: the pipeline, the pipelined inference model, the mesh step
    parallel_rec = parallel_phase(dev, model, counted, smi)

    # 18. the benchmark CLIs
    bench_rec = bench_phase(dev, counted, smi, train_rec, cls_rec)

    # each kernel on the exact inputs its path gave it
    main_in = record_kernel_inputs(lambda: infer(images))
    dense_in = record_kernel_inputs(decode_dense)
    fused_in = record_kernel_inputs(lambda: fused(hms, [tags]))
    paths = {"main": launches, "dense_scene": launches_dense, "fused": launches_fused,
             "fused_scene": launches_fused_scene, "per_image": launches_per_image,
             "w32_blocks": launches_blocks,
             **{f"infer_{key}": rec["launches"] for key, rec in infer_rec["configs"].items()},
             **{f"eval_bs{bs}": c for bs, c in eval_rec["launches"].items()},
             "train_data_val": train_data_rec["launches"],
             "train_engine": train_engine_rec["launches"],
             "classification": cls_rec["launches"],
             "serve": serve_rec["launches"],
             "zoo": zoo_rec["launches"],
             "zoo_train_val": dp_rec["launches"],
             "sharded_eval": sharded_rec["launches"],
             "pipeline": parallel_rec["launches"],
             "bench_decompose": bench_rec["launches"],
             # the training paths (bfloat16 steps launch the BatchNorm backward pair)
             "train": train_rec["launches"],
             "train_step": train_rec["step_launches"],
             "zoo_train_steps": dp_rec["steps_launches"],
             "zoo_train_mesh_cost": dp_rec["mesh_cost_launches"],
             "zoo_train_local_bn": dp_rec["local_bn_cost_launches"],
             "checkpoint": sharded_rec["checkpoint_launches"],
             "mesh_step": parallel_rec["mesh_step_launches"],
             **{f"bench_train_{task}": rec["launches"] for task, rec in bench_rec["train"].items()}}

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
        eval_bs8={k_: v for k_, v in eval_rec["kernels"].items() if k_.startswith("refine")},
        zoo_ae_hourglass={k_: v for k_, v in zoo_rec["ae_hourglass"].items() if k_.startswith("refine")},
        zoo_train_val={k_: v for k_, v in dp_rec["cli"].items() if k_.startswith("refine")},
        sharded_eval={k_: v for k_, v in sharded_rec["eval"]["kernels"].items() if k_.startswith("refine")},
        pipeline={k_: v for k_, v in parallel_rec["inference"].items() if k_.startswith("refine")},
        bench={stage: {k_: v for k_, v in r.items() if k_.startswith("refine")}
               for stage, r in bench_rec["stages"].items()}))
    cand, _, _, order, persons = main_in["match_by_tag"]
    # the plain grouping runs one image after another (~4 s an image on the
    # card): timed on the first MATCH_PLAIN_IMAGES images, the kernel too
    cand_p = cand[:MATCH_PLAIN_IMAGES]
    kernels.append(row(
        "match_by_tag", "main", "exact joints and count",
        cuda_ms(lambda: cuda_match.match_by_tag_batched(cand, DET_THR, TAG_THR, order, persons), iters=20),
        host_ms(lambda: (cuda_match.match_by_tag_batched_plain(cand_p, DET_THR, TAG_THR, order, persons),
                         torch.cuda.synchronize())),
        match_bound(cand, persons), None,
        plain_images=MATCH_PLAIN_IMAGES,
        ms_plain_images=cuda_ms(lambda: cuda_match.match_by_tag_batched(
            cand_p, DET_THR, TAG_THR, order, persons), iters=20),
        ms_dense_scene=cuda_ms(lambda: cuda_match.match_by_tag_batched(*dense_in["match_by_tag"]), iters=20),
        ms_fused=cuda_ms(lambda: cuda_match.match_by_tag_batched(*fused_in["match_by_tag"]), iters=20),
        shape=f"B{BATCH} K{K} M{cand.shape[2]} E{cand.shape[3] - 3} P{persons}",
        valid_rows=int((cand[..., 2] > DET_THR).sum()),
        ms_infer_e2={key: r["match_ms"] for key, r in infer_rec["e2_kernels"].items()},
        infer_e2={key: {k_: v for k_, v in r.items() if k_.startswith("match")}
                  for key, r in infer_rec["e2_kernels"].items()},
        eval_bs8={k_: v for k_, v in eval_rec["kernels"].items() if k_.startswith("match")},
        zoo_ae_hourglass={k_: v for k_, v in zoo_rec["ae_hourglass"].items() if k_.startswith("match")},
        zoo_train_val={k_: v for k_, v in dp_rec["cli"].items() if k_.startswith("match")},
        sharded_eval={k_: v for k_, v in sharded_rec["eval"]["kernels"].items() if k_.startswith("match")},
        pipeline={k_: v for k_, v in parallel_rec["inference"].items() if k_.startswith("match")},
        bench={stage: {k_: v for k_, v in r.items() if k_.startswith("match")}
               for stage, r in bench_rec["stages"].items()}))
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
    bn = train_rec["bn_backward"]
    errs["batch_norm_backward"] = bn["totals"]["dx_excess_vs_plain"]
    kernels.append(row(
        "batch_norm_backward", "train_step",
        "grad_x within two roundings of the plain version (each rounds once from float32), "
        "grad_w and grad_b within 1e-4 of their scale; float64 too; two calls bit-equal",
        bn["totals"]["kernel_ms"], bn["totals"]["plain_ms"],
        (bn["totals"]["bound_ms"], "bytes: 10 B an element less what the L2 serves of the second read"),
        bn["totals"]["library_ms"], library="native_batch_norm_backward and four float32 sums, as one",
        shape=f"the phase 9 W32 bfloat16 step's {bn['layers']} BatchNorm layers at "
              f"{train_rec['batch']}x{train_rec['size']}^2, ms summed over them; each shape in "
              "per_shape",
        totals=bn["totals"], per_shape=bn["rows"]))
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
    print(json.dumps({"train_engine": train_engine_rec}), flush=True)
    print(json.dumps({"classification": cls_rec}), flush=True)
    print(json.dumps({"serve": serve_rec}), flush=True)
    print(json.dumps({"zoo": zoo_rec}), flush=True)
    print(json.dumps({"dp_train": dp_rec}), flush=True)
    print(json.dumps({"sharded_eval": sharded_rec}), flush=True)
    print(json.dumps({"model_parallel": parallel_rec}), flush=True)
    print(json.dumps({"bench": bench_rec}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
