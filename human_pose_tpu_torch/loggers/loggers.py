"""Experiment tracking loggers (port of human_pose_tpu/loggers/loggers.py).

Counterpart of reference src/logger/loggers.py: a rank-0-gated ``Loggers``
fan-out over backends, each creating the run directory layout
``checkpoints/ logs/ model/ eval_examples/ data_examples/`` and logging
metrics/params/artifacts with a terminal Status (FINISHED/FAILED/KILLED).

Backends:
* ``TerminalLogger`` — local-only (reference loggers.py:212-225)
* ``FileTrackerLogger`` — an MLFlow-equivalent local tracker: params yaml,
  metrics jsonl per split, artifact copies under ``tracker/``
* ``MlflowFileLogger`` — MLflow's FileStore layout written directly, without
  the ``mlflow`` package

The files each backend writes are the JAX package's, byte for byte apart from
times and run ids.
"""

from __future__ import annotations

import enum
import json
import shutil
import time
import uuid
from pathlib import Path

from ..utils.files import save_yaml
from ..utils.utils import is_main_process
from .pylogger import log


class Status(str, enum.Enum):
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    KILLED = "KILLED"


class BaseLogger:
    def __init__(self, log_path: str | Path, experiment_name: str = "exp", run_name: str = "run"):
        self.log_path = Path(log_path)
        self.experiment_name = experiment_name
        self.run_name = run_name
        self.ckpt_dir = self.log_path / "checkpoints"
        self.logs_dir = self.log_path / "logs"
        self.model_dir = self.log_path / "model"
        self.eval_examples_dir = self.log_path / "eval_examples"
        self.data_examples_dir = self.log_path / "data_examples"
        for d in (
            self.ckpt_dir,
            self.logs_dir,
            self.model_dir,
            self.eval_examples_dir,
            self.data_examples_dir,
        ):
            d.mkdir(parents=True, exist_ok=True)

    def log_metrics(self, metrics: dict, step: int, split: str = "train") -> None:
        pass

    def log_params(self, params: dict) -> None:
        pass

    def log_config(self, cfg_dict: dict) -> None:
        save_yaml(cfg_dict, self.log_path / "config.yaml")

    def log_artifact(self, path: str | Path, dst_subdir: str = "") -> None:
        pass

    def finalize(self, status: Status) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class TerminalLogger(BaseLogger):
    def log_metrics(self, metrics: dict, step: int, split: str = "train") -> None:
        parts = ", ".join(f"{k}={v:.5g}" for k, v in metrics.items())
        log.info(f"[{split} @ step {step}] {parts}")

    def finalize(self, status: Status) -> None:
        log.info(f"run finalized with status {status.value}")


class FileTrackerLogger(BaseLogger):
    """Local tracker with the information content of the reference's MLFlow
    backend (metrics/params/artifacts/status per run)."""

    def __init__(self, log_path, experiment_name="exp", run_name="run", run_id: str | None = None):
        super().__init__(log_path, experiment_name, run_name)
        self.tracker_dir = self.log_path / "tracker"
        self.tracker_dir.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id or f"{experiment_name}-{run_name}-{int(time.time())}"
        self._metrics_files: dict[str, object] = {}
        (self.tracker_dir / "run.json").write_text(
            json.dumps({"run_id": self.run_id, "status": Status.RUNNING.value})
        )

    def log_metrics(self, metrics: dict, step: int, split: str = "train") -> None:
        f = self._metrics_files.get(split)
        if f is None:
            f = open(self.tracker_dir / f"metrics_{split}.jsonl", "a")
            self._metrics_files[split] = f
        f.write(json.dumps({"step": int(step), "ts": time.time(), **{k: float(v) for k, v in metrics.items()}}) + "\n")
        f.flush()

    def log_params(self, params: dict) -> None:
        save_yaml(params, self.tracker_dir / "params.yaml")

    def log_artifact(self, path: str | Path, dst_subdir: str = "") -> None:
        src = Path(path)
        if not src.exists():
            return
        dst = self.tracker_dir / "artifacts" / dst_subdir
        dst.mkdir(parents=True, exist_ok=True)
        if src.is_dir():
            shutil.copytree(src, dst / src.name, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst / src.name)

    def finalize(self, status: Status) -> None:
        (self.tracker_dir / "run.json").write_text(
            json.dumps({"run_id": self.run_id, "status": status.value})
        )
        for f in self._metrics_files.values():
            f.close()
        self._metrics_files.clear()

    def state_dict(self) -> dict:
        return {"run_id": self.run_id}

    def load_state_dict(self, state: dict) -> None:
        self.run_id = state.get("run_id", self.run_id)


class MlflowFileLogger(BaseLogger):
    """MLFlow backend without the mlflow package: writes the MLflow FileStore
    on-disk format directly, so a real ``mlflow ui --backend-store-uri
    <store_dir>`` can browse the runs as-is.

    Counterpart of the reference's MLFlowLogger (src/logger/loggers.py:231-371)
    with the same capabilities mapped to the file store:
    * experiment by name, created on first use (reference start_run,
      loggers.py:285-292)
    * resume-by-run-name: reattaches to an existing run with the same
      ``mlflow.runName`` tag instead of starting a new one (reference
      loggers.py:296-305 search_runs path)
    * metrics as ``metrics/<name>`` append files (one ``ts_ms value step``
      line per point — the FileStore wire format), params/tags as one file
      per key, artifacts copied under ``artifacts/``
    * terminal status recorded in the run meta (RUNNING/FINISHED/FAILED/
      KILLED, reference loggers.py finalize)

    The reference needs a live tracking server and warns it cannot even check
    one is up (loggers.py:266-283); the file store has no such failure mode.
    """

    # MLflow RunStatus enum values used by the FileStore meta.yaml
    _STATUS = {"RUNNING": 1, "FINISHED": 3, "FAILED": 4, "KILLED": 5}

    def __init__(
        self,
        log_path: str | Path,
        experiment_name: str = "exp",
        run_name: str = "run",
        store_dir: str | Path | None = None,
        run_id: str | None = None,
        resume: bool = True,
        description: str = "",
    ):
        super().__init__(log_path, experiment_name, run_name)
        self.store_dir = Path(store_dir) if store_dir else self.log_path / "mlruns"
        exp_id = self._ensure_experiment(experiment_name)
        self.experiment_id = exp_id
        if run_id is None and resume:
            run_id = self._find_run_by_name(run_name)
        self.run_id = run_id or uuid.uuid4().hex
        self.run_dir = self.store_dir / exp_id / self.run_id
        # captured once so every meta.yaml rewrite (incl. finalize) carries the
        # run's true start time as an int — the FileStore sorts/lists runs by
        # it; a resumed run keeps its original start time (mlflow semantics)
        self.start_time_ms = self._read_existing_start_time() or self._now_ms()
        for d in ("metrics", "params", "tags", "artifacts"):
            (self.run_dir / d).mkdir(parents=True, exist_ok=True)
        self._write_run_meta(Status.RUNNING)
        (self.run_dir / "tags" / "mlflow.runName").write_text(run_name)
        if description:
            (self.run_dir / "tags" / "mlflow.note.content").write_text(description)

    def _now_ms(self) -> int:
        return int(time.time() * 1000)

    def _read_existing_start_time(self) -> int | None:
        meta = self.run_dir / "meta.yaml"
        if not meta.exists():
            return None
        for line in meta.read_text().splitlines():
            if line.startswith("start_time:"):
                value = line.split(":", 1)[1].strip()
                if value.isdigit():
                    return int(value)
        return None

    def _ensure_experiment(self, name: str) -> str:
        # experiment ids are numeric strings in the FileStore; scan for an
        # existing meta.yaml with this name, else allocate the next id
        self.store_dir.mkdir(parents=True, exist_ok=True)
        ids = []
        for d in self.store_dir.iterdir():
            if not d.is_dir() or not d.name.isdigit():
                continue
            ids.append(int(d.name))
            meta = d / "meta.yaml"
            # exact-line match: substring matching would wrongly reattach
            # experiment "pose" to an existing "pose-v2" (prefix collision)
            if meta.exists() and any(
                line.strip() == f"name: {name}" for line in meta.read_text().splitlines()
            ):
                return d.name
        exp_id = str(max(ids) + 1 if ids else 0)
        exp_dir = self.store_dir / exp_id
        exp_dir.mkdir(parents=True, exist_ok=True)
        now = self._now_ms()
        (exp_dir / "meta.yaml").write_text(
            f"artifact_location: {exp_dir.resolve().as_uri()}\n"
            f"creation_time: {now}\n"
            f"experiment_id: '{exp_id}'\n"
            f"last_update_time: {now}\n"
            "lifecycle_stage: active\n"
            f"name: {name}\n"
        )
        return exp_id

    def _find_run_by_name(self, run_name: str) -> str | None:
        exp_dir = self.store_dir / self.experiment_id
        for d in sorted(exp_dir.iterdir()) if exp_dir.exists() else []:
            tag = d / "tags" / "mlflow.runName"
            if tag.exists() and tag.read_text() == run_name:
                return d.name
        return None

    def _write_run_meta(self, status: Status, end_time: int | None = None) -> None:
        (self.run_dir / "meta.yaml").write_text(
            f"artifact_uri: {(self.run_dir / 'artifacts').resolve().as_uri()}\n"
            f"end_time: {end_time if end_time is not None else 'null'}\n"
            "entry_point_name: ''\n"
            f"experiment_id: '{self.experiment_id}'\n"
            "lifecycle_stage: active\n"
            f"run_id: {self.run_id}\n"
            f"run_name: {self.run_name}\n"
            f"run_uuid: {self.run_id}\n"
            "source_name: ''\n"
            "source_type: 4\n"
            "source_version: ''\n"
            f"start_time: {self.start_time_ms}\n"
            f"status: {self._STATUS[status.value]}\n"
            "user_id: ''\n"
        )

    def log_metrics(self, metrics: dict, step: int, split: str = "train") -> None:
        ts = self._now_ms()
        for name, value in metrics.items():
            # FileStore forbids path separators in metric keys; mirror
            # mlflow's own convention of flat "<split>_<name>" keys
            key = f"{split}_{name}".replace("/", "_")
            with open(self.run_dir / "metrics" / key, "a") as f:
                f.write(f"{ts} {float(value)} {int(step)}\n")

    def log_params(self, params: dict) -> None:
        def flat(d, prefix=""):
            for k, v in d.items():
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    yield from flat(v, f"{key}.")
                else:
                    yield key, v

        for key, value in flat(params):
            (self.run_dir / "params" / key.replace("/", "_")).write_text(str(value))

    def log_artifact(self, path: str | Path, dst_subdir: str = "") -> None:
        src = Path(path)
        if not src.exists():
            return
        dst = self.run_dir / "artifacts" / dst_subdir
        dst.mkdir(parents=True, exist_ok=True)
        if src.is_dir():
            shutil.copytree(src, dst / src.name, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst / src.name)

    def finalize(self, status: Status) -> None:
        self._write_run_meta(status, end_time=self._now_ms())

    def state_dict(self) -> dict:
        return {"run_id": self.run_id}

    def load_state_dict(self, state: dict) -> None:
        self.run_id = state.get("run_id", self.run_id)


class Loggers:
    """Rank-0-gated fan-out (reference loggers.py:152-209)."""

    def __init__(self, loggers: list[BaseLogger], log_path: str | Path):
        self.loggers = loggers if is_main_process() else []
        self.log_path = Path(log_path)

    def log_metrics(self, metrics: dict, step: int, split: str = "train") -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step, split)

    def log_params(self, params: dict) -> None:
        for lg in self.loggers:
            lg.log_params(params)

    def log_config(self, cfg_dict: dict) -> None:
        for lg in self.loggers:
            lg.log_config(cfg_dict)

    def log_artifact(self, path, dst_subdir: str = "") -> None:
        for lg in self.loggers:
            lg.log_artifact(path, dst_subdir)

    def finalize(self, status: Status) -> None:
        for lg in self.loggers:
            lg.finalize(status)

    def state_dict(self) -> dict:
        return {"run_ids": [lg.state_dict() for lg in self.loggers]}

    def load_state_dict(self, state: dict) -> None:
        for lg, st in zip(self.loggers, state.get("run_ids", [])):
            lg.load_state_dict(st)
