"""``torch.profiler`` capture of a window of training steps (port of
``StepWindowProfiler``, ``trace`` and ``step_trace`` of
human_pose_tpu/utils/profiling.py).

``Trainer`` captures steps ``[start, start + steps)`` of the first epoch,
counted from the first step this run executes, when ``trainer.profile_dir``
is set; each step is annotated with ``record_function`` so the trace viewer
groups work per training step. The trace is a Chrome trace (Perfetto or
``chrome://tracing``) written into the directory. The JAX module has these
three; all three are here, and ``span`` besides.

Standalone use:

    with step_trace("train", step_num=i):      # annotate (cheap when no
        metrics = module.training_step(batch)   # profiler is active)

    with trace("/tmp/trace"):                   # capture a window
        ...

``span(name)`` marks a stage of the program (the inference model's
``infer.*``, the networks' ``net.*``, the decode's ``decode.*``, the train
steps' ``train.*``) in whatever ``torch.profiler`` trace is being taken, on
the same clock as the card's kernels. With no profiler running it reads one
flag and records nothing. Under a profiler a stage appears in three forms:

* a ``_RecordFunctionFast`` range ``hp:<name>`` around its body, exported
  with category ``cpu_op``: the bar an operator sees in Perfetto;
* two instant marks, empty ``record_function`` blocks ``hp:<name>`` at its
  entry and ``hp:<name>:end`` at its exit, exported as ``user_annotation``.

A trace reader that charges each device operation to the innermost
``user_annotation`` open at its launch (as ``gpubench/trace.py`` does) keeps
charging every operation to the caller's own spans: no launch happens inside
an empty mark, and it does not read ``cpu_op`` ranges. A ``record_function``
range around the body would take those launches over. The marks still give
the stage's host interval (from the entry mark to the exit mark).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(trace_dir: str | Path):
    """Profile the block (CPU, and the card's kernels when there is one)
    and write its Chrome trace into ``trace_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _mark(name: str) -> None:
    with torch.profiler.record_function(name):
        pass


class span:
    """A stage of the program, ``hp:<name>`` in a profiler trace (see the
    module's docstring); a context manager or a decorator. Free when no
    profiler is running: the profiler's flag is read at each entry."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            name = "hp:" + self.name
            _mark(name)
            self._range = torch._C._profiler._RecordFunctionFast(name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(*exc)
            _mark(f"hp:{self.name}:end")

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def step_trace(name: str, step_num: int):
    """``record_function`` range named ``{name}_step_{step_num}``."""
    return torch.profiler.record_function(f"{name}_step_{step_num}")


class StepWindowProfiler:
    """Capture a ``steps``-long window of training steps into ``trace_dir``,
    beginning ``start`` steps after the first step this run executes
    (skipping the first step's one-off costs; resume-safe). Driven by
    ``on_step(global_step)`` calls; inactive (and free) when ``trace_dir``
    is falsy."""

    def __init__(self, trace_dir: str | None, start: int = 2, steps: int = 5):
        self.trace_dir = trace_dir
        self.start = start
        self.steps = steps
        self._exit: contextlib.ExitStack | None = None
        self._first: int | None = None
        self.done = trace_dir is None or not trace_dir

    def on_step(self, global_step: int) -> None:
        if self.done:
            return
        if self._first is None:
            # ``start`` is an offset from the first step THIS RUN executes
            # (resumed runs begin at an arbitrary global step)
            self._first = global_step
            self.start = global_step + self.start
        if self._exit is None and global_step >= self.start:
            self._exit = contextlib.ExitStack()
            self._exit.enter_context(trace(self.trace_dir))
        elif self._exit is not None and global_step >= self.start + self.steps:
            self.stop()

    def closing(self, global_step: int) -> bool:
        """True when the next ``on_step(global_step)`` will close the trace:
        callers with deferred device work (the trainer's one-step-lagged
        metric fetch) sync on it first, so the profiled steps' device work is
        complete when the window ends."""
        return self._exit is not None and global_step >= self.start + self.steps

    @contextlib.contextmanager
    def annotate(self, global_step: int):
        if self.done or not (self.start <= global_step < self.start + self.steps):
            yield
            return
        with step_trace("train", step_num=global_step):
            yield

    def stop(self) -> None:
        if self._exit is not None:
            self._exit.close()
            self._exit = None
        self.done = True
