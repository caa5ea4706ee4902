"""Config dataclasses + factory methods (port of human_pose_tpu/configs/base.py).

Counterpart of reference src/base/config.py: yaml -> dict -> recursive
``--a.b.c=v`` CLI overrides -> nested dataclasses -> factories. The
dataclasses, their fields and defaults are the JAX package's, so one yaml
and one argv structure into the same config in both packages. Debug-mode
rename (limit_batches > 0 -> experiment "debug"), ``ckpt_path: auto`` and
the run-dir layout ``results/<exp>/<run>/<timestamp>`` are kept. The
keypoints config builds the training datamodule and module, the callbacks,
the logger and the trainer, and sets up the run's file logging; under
torchrun, the data-parallel mesh of the process group and the BatchNorm
scope of the reference's per-device statistics.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from ..loggers.loggers import FileTrackerLogger, Loggers, MlflowFileLogger, TerminalLogger
from ..loggers.pylogger import add_file_handler, log, set_device_tag
from ..utils.files import load_yaml
from ..utils.utils import (
    get_rank, is_main_process, process_count, process_group_initialized, seed_everything,
)
from .cli import update_config
from .structured import structure, unstructure

NOW = time.strftime("%Y-%m-%d_%H-%M-%S")
RESULTS_PATH = Path("results")


def find_last_checkpoint(experiment_dir: Path, run_name: str | None = None):
    """Newest ``last.pt`` under ``experiment_dir[/run_name]/*/checkpoints``
    (the run-dir layout every trainer run writes), or None when the
    experiment has never checkpointed."""
    root = experiment_dir / run_name if run_name else experiment_dir
    candidates = [p for p in root.glob("**/checkpoints/last.pt") if p.exists()]
    if not candidates:
        return None
    latest = max(candidates, key=lambda p: p.stat().st_mtime)
    log.info(f"auto-resume: found {latest}")
    return str(latest)


@dataclass
class TransformConfig:
    mean: list = field(default_factory=lambda: [0.485, 0.456, 0.406])
    std: list = field(default_factory=lambda: [0.229, 0.224, 0.225])
    out_size: Any = 224


@dataclass
class DatasetConfig:
    root: str = "data"
    split: str = "train"
    out_size: int = 512
    hm_resolutions: list = field(default_factory=lambda: [0.25, 0.5])
    num_kpts: int = 17
    max_num_people: int = 30
    sigma: float = 2.0
    mosaic_probability: float = 0.0


@dataclass
class DataloaderConfig:
    batch_size: int = 32
    pin_memory: bool = True
    num_workers: int = 4
    # uint8 images, fp16 targets and bool masks on the host, normalized on
    # the device
    compact_batches: bool = False
    train_ds: DatasetConfig = field(default_factory=DatasetConfig)
    val_ds: DatasetConfig = field(default_factory=DatasetConfig)


@dataclass
class NetConfig:
    params: dict = field(default_factory=dict)


@dataclass
class TrainerConfig:
    # "cpu" runs the port on the CPU, anything else on the card; "tpu" (the
    # repo's yamls) also selects the bf16 forward, as in the JAX package
    accelerator: str = "tpu"
    max_epochs: int = 100
    limit_batches: int = -1
    use_DDP: bool = True
    sync_batchnorm: bool = False
    use_compile: bool = False
    # "flax" (the JAX package's single file) is one torch.save file here;
    # "orbax" a directory written by torch.distributed.checkpoint
    # (train/checkpoint_orbax.py)
    ckpt_backend: str = "flax"
    # a torch.profiler trace of a few early training steps into this
    # directory (utils/profiling.py)
    profile_dir: str | None = None
    profile_steps: int = 5
    # batches staged on the device ahead of the running step
    # (train/prefetch.DevicePrefetcher); 0 disables
    device_prefetch: int = 1
    # checkpoint writes on a background thread (one process)
    async_ckpt: bool = True


@dataclass
class SetupConfig:
    seed: int = 42
    experiment_name: str = "exp"
    architecture: str = ""
    dataset: str = ""
    run_name: str | None = None
    is_train: bool = True
    ckpt_path: str | None = None
    pretrained_ckpt_path: str | None = None
    # no TF32 in matmuls or cuDNN, deterministic cuDNN algorithms
    deterministic: bool = False
    tracker: str = "file"
    # accepted for the yamls' sake: XLA's persistent compilation cache has no
    # counterpart in eager PyTorch, so nothing applies it
    compilation_cache_dir: str | None = None


@dataclass
class CUDNNConfig:
    """The reference's cuDNN switches; the CLIs apply them to
    ``torch.backends.cudnn`` (``BaseConfig.apply_cudnn``)."""

    benchmark: bool = True
    deterministic: bool = False
    enabled: bool = True


@dataclass
class OptimizerConfig:
    name: str = "Adam"
    params: dict = field(default_factory=dict)


@dataclass
class LRSchedulerConfig:
    name: str = "ConstantLR"
    interval: str = "epoch"
    params: dict = field(default_factory=dict)


@dataclass
class ModuleConfig:
    optimizers: dict = field(default_factory=dict)
    lr_schedulers: dict = field(default_factory=dict)
    accumulate_grad_batches: int = 1


@dataclass
class InferenceConfig:
    input_size: int = 512
    ckpt_path: str | None = None
    det_thr: float = 0.05
    tag_thr: float = 0.5
    use_flip: bool = False
    # multi-scale TTA, e.g. [0.5, 1, 2]; None = single scale
    scales: list | None = None
    # the pipeline-parallel forward comes with module 14; 0 = one device
    pipeline_devices: int = 0
    # uint8 pixels to the device, normalized there
    compact_inputs: bool = False
    # shape-bucket size: 64 = the reference's exact 64-alignment; larger
    # values zero-pad into coarser buckets (the decode masks the pad);
    # "auto" = 128
    pad_multiple: int | str = 64


@dataclass
class BaseConfig:
    setup: SetupConfig = field(default_factory=SetupConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    cudnn: CUDNNConfig = field(default_factory=CUDNNConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    transform: TransformConfig = field(default_factory=TransformConfig)
    module: ModuleConfig = field(default_factory=ModuleConfig)
    net: NetConfig = field(default_factory=NetConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_yaml_to_dict(cls, path: str, argv: list[str] | None = None) -> dict:
        cfg = load_yaml(path)
        allowed = set(cfg) | {
            "setup", "trainer", "cudnn", "dataloader", "transform", "module",
            "net", "inference",
        }
        return update_config(cfg, argv if argv is not None else sys.argv[1:], allowed)

    @classmethod
    def from_dict(cls, cfg_dict: dict) -> "BaseConfig":
        cfg = structure(cfg_dict, cls)
        cfg.__post_init_config__()
        return cfg

    def __post_init_config__(self) -> None:
        """Debug mode, ``ckpt_path: auto``, the run name and log path (as the
        JAX package), and ``setup.deterministic`` applied to torch."""
        # debug mode: limited batches reroute results (reference config.py:180-185)
        self.is_debug = self.trainer.limit_batches > 0
        if self.is_debug:
            self.setup.experiment_name = "debug"
        # ckpt_path="auto": the newest last.pt of this experiment (this
        # run_name if set), or a fresh start when there is none, so one
        # command line serves the first launch and every restart
        if self.setup.ckpt_path == "auto":
            self.setup.ckpt_path = find_last_checkpoint(
                RESULTS_PATH / self.setup.experiment_name, self.setup.run_name
            )
        if self.setup.run_name is None:
            if self.setup.ckpt_path:
                self.setup.run_name = Path(self.setup.ckpt_path).parts[-4] \
                    if len(Path(self.setup.ckpt_path).parts) >= 4 else NOW
            else:
                self.setup.run_name = NOW
        self.log_path = RESULTS_PATH / self.setup.experiment_name / self.setup.run_name / NOW
        if self.setup.deterministic:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True

    def to_dict(self) -> dict:
        return unstructure(self)

    def resolved_pad_multiple(self) -> int:
        """``inference.pad_multiple`` as an int: "auto" is a fixed alias for
        128 (coarse zero-pad buckets), so one config always gives the same
        numerics; the default 64 is the reference's exact alignment."""
        pm = self.inference.pad_multiple
        if isinstance(pm, str):
            if pm != "auto":
                raise ValueError(f"inference.pad_multiple must be an int or 'auto', got {pm!r}")
            pm = 128
            log.info(
                "inference.pad_multiple=auto -> 128 (coarse zero-pad buckets; pass "
                "--inference.pad_multiple=64 for exact reference 64-alignment)"
            )
        return int(pm)

    # -- runtime helpers --------------------------------------------------------
    def compute_dtype(self) -> torch.dtype:
        """The JAX package's rule for the same yaml: bfloat16 where
        ``trainer.accelerator`` is "tpu" (every yaml of the repo), else
        float32."""
        return torch.bfloat16 if self.trainer.accelerator == "tpu" else torch.float32

    def target_device(self) -> str:
        """The CPU only when ``trainer.accelerator`` is "cpu"; the card
        otherwise (under torchrun the current card, ``cuda:LOCAL_RANK``,
        which ``parallel.setup_distributed`` selects)."""
        return "cpu" if self.trainer.accelerator == "cpu" else "cuda"

    def initialize_logging(self) -> None:
        """Tag the console log with the device (``GPU:{rank}`` on the card,
        ``CPU:{rank}`` on the CPU) and add this process's file log
        ``logs/device_{rank}.log`` in the run directory."""
        rank = get_rank()
        tag = f"{'CPU' if self.trainer.accelerator == 'cpu' else 'GPU'}:{rank}"
        set_device_tag(log, tag)
        if is_main_process():
            self.log_path.mkdir(parents=True, exist_ok=True)
        add_file_handler(log, self.log_path / "logs" / f"device_{rank}.log", tag)

    def apply_cudnn(self) -> None:
        """Set ``torch.backends.cudnn`` from the ``cudnn`` section, as the
        reference does; ``setup.deterministic`` keeps cuDNN deterministic
        whatever the section says."""
        torch.backends.cudnn.enabled = self.cudnn.enabled
        torch.backends.cudnn.benchmark = self.cudnn.benchmark
        torch.backends.cudnn.deterministic = self.cudnn.deterministic or self.setup.deterministic

    def seed(self) -> None:
        """Seed python, numpy and torch per rank, as the reference does
        (src/base/bin/train.py:44-49)."""
        seed_everything(self.setup.seed + get_rank())

    def make_mesh(self):
        """The data-parallel mesh (``parallel.make_mesh``) when
        ``trainer.use_DDP`` is set and the process runs in a
        ``torch.distributed`` group (torchrun, world size 1 too); None
        otherwise: one process trains alone."""
        if not (self.trainer.use_DDP and process_group_initialized()):
            return None
        from ..parallel import make_mesh

        return make_mesh()

    def bn_groups(self, mesh=None) -> int:
        """BatchNorm statistics scope for training, the JAX package's rule:
        one group with ``trainer.sync_batchnorm`` (global batch moments),
        else one a device under data parallelism (the reference's
        per-device statistics): the mesh's world size (one device a
        process); 1 without a mesh, where a process trains alone on one
        device."""
        if self.trainer.sync_batchnorm or mesh is None:
            return 1
        return mesh.world_size

    # -- factories (overridden per task) ------------------------------------------
    def check_trainable(self) -> None:
        """Raise for targets the task's network cannot train on (the
        keypoints config checks their resolutions); called before a run
        directory is made."""

    def create_net(self):
        raise NotImplementedError

    def create_inference_model(self):
        raise NotImplementedError

    def create_datamodule(self):
        raise NotImplementedError

    def create_module(self, mesh=None):
        raise NotImplementedError

    def create_callbacks(self) -> list:
        from ..train.callbacks import default_callbacks

        return default_callbacks()

    def create_logger(self) -> Loggers:
        tracker_cls = MlflowFileLogger if self.setup.tracker == "mlflow" else FileTrackerLogger
        return Loggers(
            [TerminalLogger(self.log_path),
             tracker_cls(self.log_path, self.setup.experiment_name, str(self.setup.run_name))],
            self.log_path,
        )

    def create_trainer(self, logger: Loggers | None = None):
        """The ``Trainer`` from the ``trainer`` section with the default
        callbacks; the config is logged to the run directory. An unknown
        checkpoint backend refuses here, before any run starts."""
        from ..train.checkpoint import check_ckpt_backend
        from ..train.trainer import Trainer

        check_ckpt_backend(self.trainer.ckpt_backend)
        logger = logger if logger is not None else self.create_logger()
        logger.log_config(self.to_dict())
        return Trainer(
            logger=logger,
            callbacks=self.create_callbacks(),
            max_epochs=self.trainer.max_epochs,
            limit_batches=self.trainer.limit_batches,
            log_path=self.log_path,
            ckpt_backend=self.trainer.ckpt_backend,
            profile_dir=self.trainer.profile_dir,
            profile_steps=self.trainer.profile_steps,
            device_prefetch=self.trainer.device_prefetch,
            async_ckpt=self.trainer.async_ckpt,
        )
