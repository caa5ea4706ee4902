"""One run of one benchmark cell.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``harness.Layout``), makes its weights and inputs from the
seed on the card and warms up its shapes (set-up), runs its units back to
back for ``--seconds`` seconds (the window), and with ``--trace 1`` profiles
a few more units for the per-layer metrics. Then it frees the program's
state, runs the reference check, and prints each compared number beside its
limit on standard error and, last on standard output, one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks``.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when JAX, flax or the JAX package is loaded in
the process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent / ".cache"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import torch  # noqa: E402

from gpubench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": peak}


def run(args, layout=None, device=None, t_start=T_START) -> dict:
    """One run; returns the result record. ``device`` None means the card,
    which must be there; a test passes the CPU to drive the rest."""
    layout = layout or harness.Layout()
    cell = layout.cell(args.workload)
    chips = cell["entry"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"gpubench: the cell needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             "available. No result.")
        device = torch.device("cuda", 0)
    ctx = harness.Context.make(cell, args.seed, args.seconds, device)
    kind = layout.kind(cell["workload"]["kind"])
    t_cell = time.perf_counter()
    work = kind.Cell(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: {t_cell - t_start:.3f} s to the cell's set-up (interpreter, "
          f"imports, the card), {setup_s - t_cell + t_start:.3f} s in it", file=sys.stderr)
    harness.run_window(work, ctx)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    if args.trace:
        work.trace(ctx)
        for m in cell["per_layer"]:
            value = layout.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = work.end_to_end(ctx)
        values.update({"setup_s": setup_s, "peak_mem_gib": peak / 2**30})
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    attempted, failed = work.attempted, work.failed
    work.release()
    checks = work.check(ctx)
    record = {"correct": harness.judge(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(device, chips, peak)}
    if args.trace:
        if ctx.trace is not None:
            record["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
            record["breakdown"] = ctx.trace.breakdown()
    # a value that is not finite is written as text: the line stays JSON
    record["checks"] = {name: {"value": v if math.isfinite(v) else repr(v), "limit": lim}
                        for name, v, lim in checks}
    return record


def main(argv=None) -> int:
    args = parse(argv)
    record = run(args)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: loaded in this process: {', '.join(found)}. No result.",
              file=sys.stderr, flush=True)
        return 4
    for name, c in record["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {record['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
