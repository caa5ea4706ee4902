"""The host-side training loop (port of human_pose_tpu/train/trainer.py).

Counterpart of reference src/base/trainer.py (Trainer.fit / single_epoch /
evaluate / sanity_check / checkpoint orchestration): epochs, meters, metric
storage, callbacks, checkpoints (``train/checkpoint.py``, saved on a
background thread; or directories, ``train/checkpoint_orbax.py``),
``limit_batches`` debug mode and failure finalization.
The steps are ``KeypointsModule``'s; the train loader runs through
``DevicePrefetcher``. Over several processes (``parallel``) each trains on
its shard; only the main process shows progress bars and logs, under a
data-parallel mesh the validation meters are combined over its processes
after an evaluate, and
the main process writes each checkpoint file while the others wait at a
barrier (every process takes part in a directory's), as the JAX package.
"""

from __future__ import annotations

import random
import traceback
from pathlib import Path

from tqdm.auto import tqdm

from ..loggers.loggers import Loggers, Status
from ..loggers.pylogger import log
from ..parallel.mesh import barrier
from ..utils.profiling import StepWindowProfiler
from ..utils.utils import is_main_process, process_count
from . import checkpoint_orbax
from .callbacks import Callbacks
from .checkpoint import (
    AsyncCheckpointWriter, check_ckpt_backend, load_checkpoint, load_params_partial, load_train_state,
    save_checkpoint,
)
from .meters import Meters
from .module import BaseModule, metrics_to_host
from .prefetch import DevicePrefetcher
from .storage import MetricsStorage


class DataModule:
    """Train and val loaders and the train loader's resumable state
    (reference src/base/datamodule.py)."""

    def __init__(self, train_dl=None, val_dl=None, train_ds=None, val_ds=None):
        self.train_dl = train_dl
        self.val_dl = val_dl
        self.train_ds = train_ds if train_ds is not None else getattr(train_dl, "dataset", None)
        self.val_ds = val_ds if val_ds is not None else getattr(val_dl, "dataset", None)

    def state_dict(self) -> dict:
        return self.train_dl.state_dict() if self.train_dl is not None else {}

    def load_state_dict(self, state: dict) -> None:
        if self.train_dl is not None and state:
            self.train_dl.load_state_dict(state)


class Trainer:
    def __init__(
        self,
        logger: Loggers,
        callbacks: list,
        max_epochs: int = 100,
        limit_batches: int = -1,
        log_every_n_steps: int = 50,
        run_sanity_check: bool = False,
        log_path: str | Path = "results/run",
        ckpt_backend: str = "flax",
        profile_dir: str | None = None,
        profile_steps: int = 5,
        device_prefetch: int = 1,
        async_ckpt: bool = True,
    ):
        check_ckpt_backend(ckpt_backend)
        self.logger = logger
        self.callbacks = Callbacks(callbacks)
        self.max_epochs = max_epochs
        self.limit_batches = limit_batches
        self.log_every_n_steps = log_every_n_steps
        self.run_sanity_check = run_sanity_check
        self.device_prefetch = device_prefetch
        self.async_ckpt = async_ckpt
        self._ckpt_writer = AsyncCheckpointWriter()
        self.log_path = Path(log_path)
        self.ckpt_backend = ckpt_backend
        # torch.profiler window (utils/profiling.py): captures a few early
        # steps into profile_dir when set; no-op otherwise
        self.profiler = StepWindowProfiler(profile_dir, steps=profile_steps)
        self.ckpt_dir = self.log_path / "checkpoints"
        self.storage = MetricsStorage()
        self.meters = {"train": Meters(), "val": Meters()}
        self.current_epoch = 0
        self.current_step = 0
        self.epoch_metrics: dict[str, dict] = {}
        self.val_results: list = []
        self.module: BaseModule | None = None
        self.datamodule: DataModule | None = None

    # -- loops ---------------------------------------------------------------
    def _n_batches(self, loader) -> int:
        n = len(loader)
        return min(n, self.limit_batches) if self.limit_batches > 0 else n

    def _limit(self, loader):
        n = self._n_batches(loader)
        for i, batch in enumerate(loader):
            if i >= n:
                break
            yield batch

    def single_epoch(self, train_dl) -> dict:
        meters = self.meters["train"]
        meters.reset()
        pbar = tqdm(self._limit(train_dl), total=self._n_batches(train_dl),
                    desc=f"epoch {self.current_epoch} [train]", disable=not is_main_process())

        # One-step deferred metric fetch: ``metrics_to_host`` (``.item()``)
        # blocks until the step that made the metrics has finished on the
        # card. Holding step N's metrics as device tensors until step N+1 is
        # launched lets the host stage batch N+1 and launch step N+1 while
        # step N still runs. The meters, storage and logs hold the same
        # values; only the moment of the host sync moves.
        def consume(dev_metrics, step_idx: int) -> None:
            metrics = metrics_to_host(dev_metrics)
            meters.update(metrics)
            self.storage.append(metrics, step_idx, self.current_epoch, "train")
            if (step_idx + 1) % self.log_every_n_steps == 0:
                pbar.set_postfix({k: f"{v:.4g}" for k, v in metrics.items()})
                self.logger.log_metrics(metrics, step_idx + 1, "step")

        # a callback that overrides on_step_end reads the meters and storage
        # at step granularity: the fetch is serial then
        defer = not self.callbacks.overrides_step_end()
        pending = None
        for batch in pbar:
            if pending is not None and self.profiler.closing(self.current_step):
                # the profiler window ends at this step: fetch the pending
                # metrics first, so every profiled step has finished on the
                # device before the trace closes
                consume(*pending)
                pending = None
            self.profiler.on_step(self.current_step)
            with self.profiler.annotate(self.current_step):
                dev_metrics = self.module.training_step(batch)
            if pending is not None:
                consume(*pending)
            pending = (dev_metrics, self.current_step)
            if not defer:
                consume(*pending)
                pending = None
            self.current_step += 1
            self.callbacks.on_step_end(self)
        if pending is not None:
            consume(*pending)
        return meters.to_dict()

    def evaluate(self, val_dl, split: str = "val") -> dict:
        meters = self.meters["val"]
        meters.reset()
        self.val_results = []
        self.callbacks.on_validation_start(self)
        n_batches = self._n_batches(val_dl)
        # deterministic in the epoch: a resumed run plots the same batches
        plot_batch = random.Random(self.current_epoch).randint(0, max(0, n_batches - 1))
        # the same one-step deferred metric fetch as single_epoch
        pending = None
        for i, batch in enumerate(tqdm(self._limit(val_dl), total=n_batches,
                                       desc=f"epoch {self.current_epoch} [{split}]",
                                       disable=not is_main_process())):
            metrics, outputs = self.module.validation_step(batch)
            if pending is not None:
                meters.update(metrics_to_host(pending))
            pending = metrics
            # with several processes a batch is this process's share: plots
            # are cosmetic, skip them (reference plots on rank 0)
            if i == plot_batch and hasattr(self.module, "make_results") and process_count() == 1:
                try:
                    self.val_results = self.module.make_results(batch, outputs)
                except Exception as e:
                    log.warning(f"make_results failed: {e}")
        if pending is not None:
            meters.update(metrics_to_host(pending))
        # under a mesh each process validated its shard: the global means
        # on every process (SaveModelCheckpoint's decisions must agree)
        if self.module.state.mesh is not None:
            meters.all_reduce(self.module.state.mesh)
        avg = meters.to_dict()
        self.storage.append(avg, self.current_step, self.current_epoch, split)
        self.callbacks.on_validation_end(self)
        return avg

    def sanity_check(self, val_dl, n_batches: int = 2) -> None:
        log.info("running sanity-check validation")
        for i, batch in enumerate(val_dl):
            if i >= n_batches:
                break
            self.module.validation_step(batch)

    # -- fit -----------------------------------------------------------------
    def fit(self, module: BaseModule, datamodule: DataModule, pretrained_ckpt_path: str | None = None,
            ckpt_path: str | None = None) -> None:
        self.module = module
        self.datamodule = datamodule

        if pretrained_ckpt_path:
            load_params_partial(module.model, pretrained_ckpt_path)
            log.info(f"loaded pretrained weights from {pretrained_ckpt_path}")

        start_epoch = 0
        if ckpt_path:
            start_epoch = self.load_checkpoint(ckpt_path)

        self.callbacks.on_fit_start(self)
        if self.run_sanity_check and datamodule.val_dl is not None:
            self.sanity_check(datamodule.val_dl)

        # batches staged on the card ahead of the running step, on a side
        # stream (train/prefetch.py)
        train_dl = datamodule.train_dl
        if self.device_prefetch > 0 and train_dl is not None:
            train_dl = DevicePrefetcher(train_dl, module.batch_to_device, buffer=self.device_prefetch,
                                        device=module.device)

        try:
            for epoch in range(start_epoch, self.max_epochs):
                self.current_epoch = epoch
                if hasattr(datamodule.train_dl, "set_epoch"):
                    datamodule.train_dl.set_epoch(epoch)
                self.callbacks.on_epoch_start(self)

                train_metrics = self.single_epoch(train_dl)
                val_metrics = (self.evaluate(datamodule.val_dl, "val")
                               if datamodule.val_dl is not None else {})
                self.epoch_metrics = {"train": train_metrics, "val": val_metrics}
                self.epoch_metrics["lr"] = {"optim": module.lr}

                module.on_epoch_end(val_metrics)
                self.callbacks.on_epoch_end(self)
                log.info(f"epoch {epoch}: " + " ".join(
                    f"{s}/{k}={v:.5g}" for s, m in self.epoch_metrics.items()
                    if isinstance(m, dict) for k, v in m.items()))
            # join the last background write before the run is FINISHED: a
            # failed last.pt write marks the run FAILED
            self._ckpt_writer.wait()
            self.logger.finalize(Status.FINISHED)
        except KeyboardInterrupt:
            log.warning("KeyboardInterrupt -> KILLED")
            self.callbacks.on_failure(self, Status.KILLED)
            self.logger.finalize(Status.KILLED)
            raise
        except Exception:
            log.error(f"training failed:\n{traceback.format_exc()}")
            self.callbacks.on_failure(self, Status.FAILED)
            self.logger.finalize(Status.FAILED)
            raise
        finally:
            # close an unfinished profiler window (short runs, failures)
            self.profiler.stop()
            # join any in-flight write so the run dir is complete when fit
            # returns; on a failure only log the write's error, never
            # replace the exception in flight
            try:
                self._ckpt_writer.wait()
            except Exception:
                log.error(f"background checkpoint write failed:\n{traceback.format_exc()}")

    # -- checkpointing ---------------------------------------------------------
    def save_checkpoint(self, path: str | Path) -> None:
        """``path`` with the module's state and schedulers, the loader's
        state, the storage, the callbacks' and the logger's. A directory
        (``ckpt_backend`` "orbax") is written by every process here, as the
        JAX package's; a file on the background writer when ``async_ckpt``
        is set (one process), else here by the main process. Every process
        then waits at a barrier until the checkpoint exists."""
        kwargs = dict(
            lr_schedulers=self.module.schedulers_state_dict(),
            datamodule_state=self.datamodule.state_dict() if self.datamodule else {},
            metrics_state=self.storage.state_dict(),
            callbacks_state=self.callbacks.state_dict(),
            logger_state=self.logger.state_dict(),
        )
        if self.ckpt_backend == "orbax":
            checkpoint_orbax.save_checkpoint(path, self.module.state, self.current_epoch, **kwargs)
        elif self.async_ckpt and process_count() == 1:
            self._ckpt_writer.submit(path, self.module.state, self.current_epoch, **kwargs)
            return
        elif is_main_process():
            save_checkpoint(path, self.module.state, self.current_epoch, **kwargs)
        barrier("save_checkpoint")

    def load_checkpoint(self, path: str | Path) -> int:
        """Restore a port checkpoint, a file or a directory (told apart
        whatever the backend, as the JAX package), into the module, the
        loader, the storage, the callbacks and the logger; returns the epoch
        to start."""
        self._ckpt_writer.wait()  # never read a file mid-background-write
        if checkpoint_orbax.is_orbax_checkpoint(path):
            ckpt = checkpoint_orbax.load_checkpoint(path)
            checkpoint_orbax.load_train_state(self.module.state, ckpt)
            schedulers = ckpt.get("lr_schedulers")
        else:
            ckpt = load_checkpoint(path)
            load_train_state(self.module.state, ckpt)
            schedulers = ckpt["module"].get("lr_schedulers")
        self.module.load_schedulers_state_dict(schedulers or {})
        if self.datamodule is not None:
            self.datamodule.load_state_dict(ckpt.get("datamodule") or {})
        if ckpt.get("metrics"):
            self.storage.load_state_dict(ckpt["metrics"])
        if ckpt.get("callbacks"):
            self.callbacks.load_state_dict(ckpt["callbacks"])
        if ckpt.get("logger"):
            self.logger.load_state_dict(ckpt["logger"])
        self.current_step = int(ckpt.get("step", 0))
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        log.info(f"resumed from {path}: epoch {start_epoch}, step {self.current_step}")
        return start_epoch
