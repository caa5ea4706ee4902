"""Full-state checkpoint save and load (port of
human_pose_tpu/train/checkpoint.py).

One ``torch.save`` file in the reference's trainer-state layout (SURVEY.md
§3.5)::

    {"module": {"model": state_dict, "optimizers": {"optim": ...},
                "lr_schedulers": {...}, "step": int},
     "datamodule": loader state, "metrics": ..., "callbacks": ...,
     "logger": ..., "epoch": int, "step": int}

The JAX package reads this layout as it is (``utils/torch_interop.py``'s
``load_torch_state_dict`` through ``module.model``, and so its
``load_params_partial``), and so does the port's ``load_inference_weights``.
Everything in it is a tensor or a plain Python value, so ``load_checkpoint``
reads it with ``torch.load(weights_only=True)``.

``load_train_state`` restores the model, the optimizer state and the step
into an existing state, on its device. A tensor-sharded state
(``parallel/tensor.py``) is saved whole, as a one-process state of the
same model. ``load_params_partial`` is the
name-intersection load of pretrained weights. The directory backend
(``trainer.ckpt_backend: orbax``) is ``train/checkpoint_orbax.py``.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..loggers.pylogger import log
from ..parallel.tensor import whole_state_dicts
from ..utils.weights import read_state_dict
from .state import TrainState


CKPT_BACKENDS = ("flax", "orbax")


def check_ckpt_backend(name: str) -> None:
    """The JAX package's backends: "flax" (one file) is one ``torch.save``
    file here, "orbax" a directory (``train/checkpoint_orbax.py``)."""
    if name not in CKPT_BACKENDS:
        raise ValueError(f"trainer.ckpt_backend {name!r}: 'flax' (one torch.save file) or "
                         "'orbax' (a directory of torch.distributed.checkpoint)")


def _map_tensors(obj, fn):
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _tensor_sharded(state: TrainState) -> bool:
    return state.mesh is not None and state.mesh.n_tensor > 1


def _module_payload(state: TrainState, lr_schedulers: dict | None = None) -> dict:
    """The ``module`` entry: the model's and the optimizer's state dicts
    (tensors shared with the live ones; a tensor-sharded state's gathered
    whole, ``parallel/tensor.py::whole_state_dicts``), the schedulers' and
    the step."""
    model_sd, optim_sd = whole_state_dicts(state)
    return {
        "model": model_sd,
        "optimizers": {"optim": optim_sd},
        "lr_schedulers": lr_schedulers or {},
        "step": int(state.step),
    }


def _write(path: str | Path, module: dict, epoch: int, datamodule_state=None, metrics_state=None,
           callbacks_state=None, logger_state=None) -> None:
    payload = {
        "module": _map_tensors(module, lambda t: t.detach().cpu()),
        "datamodule": datamodule_state,
        "metrics": metrics_state,
        "callbacks": callbacks_state,
        "logger": logger_state,
        "epoch": int(epoch),
        "step": int(module["step"]),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    log.info(f"saved checkpoint to {path} (epoch {epoch})")


def save_checkpoint(path: str | Path, state: TrainState, epoch: int, lr_schedulers: dict | None = None,
                    datamodule_state: dict | None = None, metrics_state: dict | None = None,
                    callbacks_state: dict | None = None, logger_state: dict | None = None) -> None:
    """Write everything to ``path`` (through a ``.tmp`` file and a rename).
    A tensor-sharded state is gathered whole: every rank of its mesh calls
    this, and rank 0 writes."""
    module = _module_payload(state, lr_schedulers)
    if _tensor_sharded(state) and state.mesh.rank != 0:
        return
    _write(path, module, epoch, datamodule_state, metrics_state, callbacks_state, logger_state)


class AsyncCheckpointWriter:
    """Checkpoint saves on a background thread.

    A step updates the parameters and Adam's ``exp_avg``/``exp_avg_sq`` in
    place (``optimizer.step()``), so the tensors at ``submit`` time would be
    overwritten by the next step while the thread still reads them.
    ``submit`` therefore clones every tensor of the model's and the
    optimizer's state on the caller thread, on the current stream, and on a
    card records an event after the clones; the thread waits on that event
    before it copies the clones to the host and writes. Host-side state
    (loader, storage, callbacks, schedulers) is deep-copied on the caller
    thread.

    One save is in flight at a time: ``submit`` and ``wait`` join the
    previous one first, so writes to best.pt and last.pt never interleave. A
    background error is raised by the next ``submit`` or ``wait``.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._future = None

    def wait(self) -> None:
        if self._future is not None:
            fut, self._future = self._future, None
            fut.result()

    def submit(self, path: str | Path, state: TrainState, epoch: int, lr_schedulers: dict | None = None,
               **host_state) -> None:
        if _tensor_sharded(state):
            raise ValueError("a tensor-sharded state saves synchronously (save_checkpoint): "
                             "its gather is a collective of every rank")
        self.wait()
        module = _map_tensors(_module_payload(state, copy.deepcopy(lr_schedulers)),
                              lambda t: t.detach().clone())
        ready = None
        if state.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(state.device))
        host_state = copy.deepcopy(host_state)

        def write():
            if ready is not None:
                ready.synchronize()
            _write(path, module, epoch, **host_state)

        self._future = self._pool.submit(write)


def load_checkpoint(path: str | Path) -> dict:
    """The payload of a port checkpoint, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_train_state(state: TrainState, ckpt: dict) -> TrainState:
    """Restore the model (strictly), the optimizer's state and the step from
    a checkpoint payload into ``state``, on its device."""
    module = ckpt["module"]
    state.model.load_state_dict(module["model"], strict=True)
    state.optimizer.load_state_dict(module["optimizers"]["optim"])
    state.step = int(module["step"])
    return state


@torch.no_grad()
def load_params_partial(model: torch.nn.Module, ckpt_path: str | Path) -> int:
    """Name-intersection partial load of pretrained weights (reference
    src/base/model.py:104-129): each parameter of ``model`` whose name is in
    the checkpoint (any format ``read_state_dict`` reads, a checkpoint
    directory too) with the same shape is copied from it, the rest keep
    their fresh initialization. Parameters only, as the JAX package's (its
    ``params``): BatchNorm running statistics keep theirs. Returns the count
    of tensors loaded."""
    src = read_state_dict(ckpt_path)
    params = dict(model.named_parameters())
    n_loaded = 0
    for name, p in params.items():
        value = src.get(name)
        if value is not None and tuple(value.shape) == tuple(p.shape):
            p.copy_(value.to(p.dtype))
            n_loaded += 1
    log.info(f"partial load: {n_loaded}/{len(params)} tensors matched from {ckpt_path}")
    return n_loaded
