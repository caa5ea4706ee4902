"""The directory checkpoint backend (port of
human_pose_tpu/train/checkpoint_orbax.py), on ``torch.distributed.checkpoint``.

The JAX package's alternative to its single file writes an orbax directory;
here ``torch.distributed.checkpoint`` (DCP) writes the arrays, in the JAX
package's layout::

    <path>/state/            the arrays: "step", "model.<state-dict key>",
                             "optim.<parameter id>.<state key>" (DCP's
                             ``.metadata`` and one ``__<rank>_0.distcp`` a
                             writing process)
    <path>/host_state.pkl    the host states: loader, metrics, callbacks,
                             logger, schedulers, the optimizer's parameter
                             groups, epoch, step and "backend": "orbax"
                             (``torch.save``, read back with
                             ``weights_only=True``)

Every process of a group calls ``save_checkpoint``, as in the JAX package:
DCP splits the writes of the (replicated) tensors over the processes, and
rank 0 alone prepares the directory and writes the host state, with
barriers between. A directory that orbax itself wrote (the JAX package's,
OCDBT/zarr arrays) has no DCP ``.metadata`` and is refused with a pointer to
the flat npz exporter.

Select with ``trainer.ckpt_backend: orbax``; the trainer's checkpoint paths
(``checkpoints/last.pt``, ``best.pt``) then name directories.
"""

from __future__ import annotations

import contextlib
import copy
import shutil
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from ..loggers.pylogger import log
from ..parallel.mesh import barrier
from ..parallel.tensor import whole_state_dicts
from ..utils.utils import get_rank, process_group_initialized
from .state import TrainState

HOST_STATE = "host_state.pkl"
ITEM = "state"
DCP_METADATA = ".metadata"


def is_orbax_checkpoint(path: str | Path) -> bool:
    """A checkpoint directory, the JAX package's rule: a directory holding
    ``host_state.pkl`` (the port's or orbax's own)."""
    return Path(path).is_dir() and (Path(path) / HOST_STATE).exists()


def is_port_directory(path: str | Path) -> bool:
    """A checkpoint directory whose arrays DCP wrote (its ``.metadata``)."""
    return is_orbax_checkpoint(path) and (Path(path) / ITEM / DCP_METADATA).is_file()


def check_port_directory(path: str | Path) -> None:
    """Raise for a directory that is not the port's: orbax's own (the JAX
    package's ``checkpoint_orbax``) cannot be read without orbax and
    tensorstore."""
    path = Path(path)
    if is_port_directory(path):
        return
    if is_orbax_checkpoint(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory written by the JAX package (its arrays are "
            f"OCDBT/zarr, no {ITEM}/{DCP_METADATA} of torch.distributed.checkpoint); the port "
            "reads neither: export its weights as a flat npz with the JAX package's "
            "utils/export.py::export_weights_npz and load that")
    raise ValueError(f"{path} is not a checkpoint directory (no {HOST_STATE})")


@contextlib.contextmanager
def _one_process_quiet():
    """DCP warns at every call without a process group that it assumes one
    process: that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled, unavailable or "
                                "uninitialized", category=UserWarning)
        yield


def _arrays(state: TrainState) -> tuple[dict, dict]:
    """The state's tensors under flat keys (a tensor-sharded state's
    gathered whole, ``parallel/tensor.py::whole_state_dicts``: every rank
    holds them all), and the optimizer's state that is not a tensor (its
    parameter groups, scalars)."""
    arrays = {"step": torch.tensor(int(state.step), dtype=torch.int64)}
    model_sd, opt = whole_state_dicts(state)
    arrays.update({f"model.{k}": v for k, v in model_sd.items()})
    host_opt = {"param_groups": opt["param_groups"], "state": {}}
    for pid, entries in opt["state"].items():
        for key, value in entries.items():
            if torch.is_tensor(value):
                arrays[f"optim.{pid}.{key}"] = value
            else:
                host_opt["state"].setdefault(pid, {})[key] = value
    return arrays, host_opt


def _write(path: Path, arrays: dict, host: dict, primary: bool) -> None:
    with _one_process_quiet():
        dcp.save(arrays, checkpoint_id=str(path / ITEM))
    if primary:
        tmp = path / (HOST_STATE + ".tmp")
        torch.save(host, tmp)
        tmp.replace(path / HOST_STATE)  # last: the directory counts as written from here on
    log.info(f"saved orbax-layout checkpoint to {path} (epoch {host['epoch']})")


def save_checkpoint(path: str | Path, state: TrainState, epoch: int, lr_schedulers: dict | None = None,
                    datamodule_state: dict | None = None, metrics_state: dict | None = None,
                    callbacks_state: dict | None = None, logger_state: dict | None = None,
                    use_async: bool = False) -> Future | None:
    """Write the checkpoint directory ``path``; every process of a group
    calls it. With ``use_async`` (one process, no group) the call returns
    once every tensor is copied to host memory (so the next step may
    overwrite the state) and the files are written on a background thread:
    the returned future completes when the directory is whole."""
    path = Path(path).absolute()
    primary = get_rank() == 0
    if use_async and process_group_initialized():
        raise ValueError("use_async: a background save runs in one process; under a process "
                         "group every process saves synchronously, as the trainer does")
    if primary:
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.is_dir():
            shutil.rmtree(path)
        elif path.exists():
            path.unlink()
    barrier("orbax_dir_prepared")  # nobody writes into a directory being removed
    arrays, host_opt = _arrays(state)
    host = {"datamodule": datamodule_state, "metrics": metrics_state, "callbacks": callbacks_state,
            "logger": logger_state, "lr_schedulers": lr_schedulers or {}, "optimizer": host_opt,
            "epoch": int(epoch), "step": int(state.step), "backend": "orbax"}
    if not use_async:
        _write(path, arrays, host, primary)
        return None
    # a snapshot on the host: the step updates parameters and Adam's moments
    # in place, so the thread must not read the live tensors
    arrays = {k: v.detach().to("cpu", copy=True) for k, v in arrays.items()}
    host = copy.deepcopy(host)
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-dir-writer")
    try:
        return pool.submit(_write, path, arrays, host, primary)
    finally:
        pool.shutdown(wait=False)


def load_checkpoint(path: str | Path) -> dict:
    """The host-state payload of a port directory, with ``_orbax_path``;
    the arrays are read by ``load_train_state``."""
    path = Path(path).absolute()
    check_port_directory(path)
    payload = torch.load(path / HOST_STATE, map_location="cpu", weights_only=True)
    payload["_orbax_path"] = path
    return payload


def read_arrays(path: str | Path, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of a port directory whose keys start with ``prefix``, on
    the CPU. Each process reads them itself (no collective)."""
    path = Path(path)
    check_port_directory(path)
    reader = dcp.FileSystemReader(str(path / ITEM))
    meta = reader.read_metadata().state_dict_metadata
    arrays = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()
              if isinstance(m, TensorStorageMetadata) and k.startswith(prefix)}
    with _one_process_quiet():
        dcp.load(arrays, storage_reader=dcp.FileSystemReader(str(path / ITEM)), no_dist=True)
    return arrays


def read_model_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The model's state dict in a port directory, on the CPU."""
    return {k[len("model."):]: v for k, v in read_arrays(path, "model.").items()}


def load_train_state(state: TrainState, ckpt: dict) -> TrainState:
    """Restore the model (strictly), the optimizer's state and the step of
    ``load_checkpoint``'s payload into ``state``, on its device."""
    arrays = read_arrays(ckpt["_orbax_path"])
    state.model.load_state_dict({k[len("model."):]: v for k, v in arrays.items()
                                 if k.startswith("model.")}, strict=True)
    host_opt = ckpt["optimizer"]
    opt_state = {pid: dict(entries) for pid, entries in host_opt["state"].items()}
    for key, value in arrays.items():
        if key.startswith("optim."):
            _, pid, name = key.split(".", 2)
            opt_state.setdefault(int(pid), {})[name] = value
    state.optimizer.load_state_dict({"state": opt_state, "param_groups": host_opt["param_groups"]})
    state.step = int(arrays["step"])
    return state


def load_params_partial(model: torch.nn.Module, ckpt_path: str | Path) -> int:
    """Name-intersection partial load of the parameters in a port directory
    (``train.checkpoint.load_params_partial``, which reads directories
    too); returns the count of tensors loaded."""
    from .checkpoint import load_params_partial as load_partial

    check_port_directory(ckpt_path)
    return load_partial(model, ckpt_path)
