"""Trainer callback system (port of human_pose_tpu/train/callbacks.py).

Counterpart of reference src/base/callbacks.py: a hook protocol
(on_fit_start / on_epoch_start / on_epoch_end / on_validation_start /
on_validation_end / on_step_end / on_failure) with per-callback state_dict for
resume, dispatched rank-0-only, plus the concrete callbacks of the reference
default list. The jpg plots are drawn with cv2 (``train/visualization.py``).
"""

from __future__ import annotations


import cv2
import numpy as np

from ..loggers.loggers import Status
from ..loggers.monitoring import SystemMetricsMonitor
from ..loggers.pylogger import log
from ..utils.files import save_yaml
from ..utils.utils import is_main_process
from .html_plots import plot_metrics_html, plot_system_monitoring_html
from .visualization import plot_metrics, plot_system_monitoring


class BaseCallback:
    #: run this callback on the primary process only (reference gates all
    #: callbacks to rank 0, callbacks.py:78-82). Callbacks that trigger
    #: COLLECTIVE work — e.g. checkpoint saves, which under the orbax backend
    #: write array shards from every host and barrier — must set this False
    #: or the primary deadlocks waiting for peers that never make the call.
    main_process_only = True

    def on_fit_start(self, trainer) -> None: ...
    def on_epoch_start(self, trainer) -> None: ...
    def on_epoch_end(self, trainer) -> None: ...
    def on_validation_start(self, trainer) -> None: ...
    def on_validation_end(self, trainer) -> None: ...
    def on_step_end(self, trainer) -> None: ...
    def on_failure(self, trainer, status: Status) -> None: ...
    def state_dict(self) -> dict:
        return {}
    def load_state_dict(self, state: dict) -> None: ...


class Callbacks:
    """Rank-0-gated dispatcher (reference callbacks.py:77-124)."""

    def __init__(self, callbacks: list[BaseCallback]):
        if is_main_process():
            self.callbacks = callbacks
        else:
            # non-primary processes keep only collective-participating
            # callbacks (checkpoint saves are all-process under orbax and
            # barrier under flax — trainer.save_checkpoint gates the writes)
            self.callbacks = [cb for cb in callbacks if not cb.main_process_only]

    def __getattr__(self, hook: str):
        if not hook.startswith("on_"):
            raise AttributeError(hook)

        def dispatch(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, hook)(*args, **kwargs)

        return dispatch

    def overrides_step_end(self) -> bool:
        """True if any callback implements on_step_end. Such callbacks read
        meters/storage at step granularity, so the trainer disables its
        one-step-deferred metric fetch to keep the hook contract (metrics of
        step N visible inside step N's on_step_end)."""
        return any(
            type(cb).on_step_end is not BaseCallback.on_step_end
            for cb in self.callbacks
        )

    def state_dict(self) -> dict:
        return {type(cb).__name__: cb.state_dict() for cb in self.callbacks}

    def load_state_dict(self, state: dict) -> None:
        for cb in self.callbacks:
            if type(cb).__name__ in state:
                cb.load_state_dict(state[type(cb).__name__])


class SaveModelCheckpoint(BaseCallback):
    """best.pt (min/max of a monitored metric) + last.pt each epoch
    (reference callbacks.py:155-217).

    Runs on EVERY process: the monitored value comes from replicated metrics
    (identical across processes), so all processes reach the same improved/
    last decisions and jointly enter trainer.save_checkpoint — required
    because the orbax save is collective and the flax save barriers."""

    main_process_only = False

    def __init__(self, name: str = "best", monitor: str = "loss", split: str = "val",
                 mode: str = "min", save_last: bool = True):
        self.name = name
        self.monitor = monitor
        self.split = split
        self.mode = mode
        self.save_last = save_last
        self.best = np.inf if mode == "min" else -np.inf

    def on_epoch_end(self, trainer) -> None:
        metrics = trainer.epoch_metrics.get(self.split, {})
        value = metrics.get(self.monitor)
        if value is not None:
            improved = value < self.best if self.mode == "min" else value > self.best
            if improved:
                self.best = float(value)
                trainer.save_checkpoint(trainer.ckpt_dir / f"{self.name}.pt")
                if is_main_process():
                    log.info(
                        f"new best {self.split}/{self.monitor}={value:.5g} -> {self.name}.pt"
                    )
        if self.save_last:
            trainer.save_checkpoint(trainer.ckpt_dir / "last.pt")

    def state_dict(self) -> dict:
        return {"best": float(self.best)}

    def load_state_dict(self, state: dict) -> None:
        self.best = float(state["best"])


class MetricsPlotterCallback(BaseCallback):
    """Saves the jpg + interactive html metric plots (reference
    callbacks.py:258-261 saves matplotlib jpg + plotly html)."""

    def on_epoch_end(self, trainer) -> None:
        epochs = trainer.storage.aggregate_over_key("epoch")
        plot_metrics(epochs, trainer.log_path / "epoch_metrics.jpg", "epoch")
        plot_metrics_html(epochs, trainer.log_path / "epoch_metrics.html", "epoch")

    on_validation_end = on_epoch_end


class MetricsSaverCallback(BaseCallback):
    def on_epoch_end(self, trainer) -> None:
        save_yaml(
            trainer.storage.aggregate_over_key("epoch").to_dict(),
            trainer.log_path / "epoch_metrics.yaml",
        )


class MetricsLogger(BaseCallback):
    def on_epoch_end(self, trainer) -> None:
        for split, metrics in trainer.epoch_metrics.items():
            trainer.logger.log_metrics(metrics, trainer.current_epoch, split)


class ModelSummary(BaseCallback):
    """Writes param-count table (reference callbacks.py:337-351): the
    model's ``named_parameters()`` grouped by their first ``depth`` dotted
    parts."""

    def __init__(self, depth: int = 2):
        self.depth = depth

    def on_fit_start(self, trainer) -> None:
        lines = ["parameter summary", "=" * 60]
        total = 0
        groups: dict[str, int] = {}
        for name, p in trainer.module.model.named_parameters():
            group = "/".join(name.split(".")[: self.depth])
            groups[group] = groups.get(group, 0) + p.numel()
            total += p.numel()
        for g, n in sorted(groups.items()):
            lines.append(f"{g:<50} {n:>12,}")
        lines += ["=" * 60, f"{'TOTAL':<50} {total:>12,}"]
        path = trainer.log_path / "model" / "model_summary.txt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines))
        log.info(f"model has {total:,} parameters")


class SystemMetricsMonitoringCallback(BaseCallback):
    def __init__(self, interval_s: float = 10.0):
        self.monitor = SystemMetricsMonitor(interval_s)

    def on_fit_start(self, trainer) -> None:
        self.monitor.start()

    def on_epoch_end(self, trainer) -> None:
        plot_system_monitoring(
            self.monitor.storage, trainer.log_path / "system_monitoring.jpg"
        )
        plot_system_monitoring_html(
            self.monitor.storage, trainer.log_path / "system_monitoring.html"
        )

    def on_failure(self, trainer, status: Status) -> None:
        self.monitor.stop()


class ArtifactsLoggerCallback(BaseCallback):
    """Uploads run artifacts (logs, plots, config) to the tracker backends
    (reference callbacks.py:127-152)."""

    def on_epoch_end(self, trainer) -> None:
        for name in ("epoch_metrics.jpg", "epoch_metrics.yaml", "system_monitoring.jpg", "config.yaml"):
            trainer.logger.log_artifact(trainer.log_path / name)

    def on_failure(self, trainer, status: Status) -> None:
        self.on_epoch_end(trainer)


class DatasetExamplesCallback(BaseCallback):
    """Dumps grids of (augmented) samples at fit start
    (reference callbacks.py:354-379)."""

    def __init__(self, idxs=(0, 1, 2), n: int = 3):
        self.idxs = idxs
        self.n = n

    def on_fit_start(self, trainer) -> None:
        ds = getattr(trainer.datamodule, "train_ds", None)
        if ds is None or not hasattr(ds, "plot") or len(ds) == 0:
            return
        out_dir = trainer.log_path / "data_examples"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in self.idxs[: self.n]:
            if i >= len(ds):
                break
            try:
                img = ds.plot(i)
                cv2.imwrite(str(out_dir / f"sample_{i}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            except Exception as e:  # plotting must never kill training
                log.warning(f"dataset example plot failed: {e}")
                return


class ResultsPlotterCallback(BaseCallback):
    """Renders the held-out validation results each epoch
    (reference callbacks.py:220-245)."""

    def on_validation_end(self, trainer) -> None:
        results = trainer.val_results
        if not results:
            return
        out_dir = trainer.log_path / "eval_examples"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, result in enumerate(results[:8]):
            try:
                plots = result.plot()
            except Exception as e:
                log.warning(f"result plot failed: {e}")
                return
            for name, img in plots.items():
                cv2.imwrite(
                    str(out_dir / f"epoch{trainer.current_epoch}_{i}_{name}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                )


def default_callbacks() -> list[BaseCallback]:
    """Reference default list (src/base/config.py:269-283)."""
    return [
        ModelSummary(),
        DatasetExamplesCallback(),
        MetricsPlotterCallback(),
        MetricsSaverCallback(),
        MetricsLogger(),
        SaveModelCheckpoint(monitor="loss", split="val", mode="min"),
        SystemMetricsMonitoringCallback(),
        ArtifactsLoggerCallback(),
        ResultsPlotterCallback(),
    ]
