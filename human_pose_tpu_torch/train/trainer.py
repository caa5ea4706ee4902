"""The training loop's data side (port of ``DataModule`` of
human_pose_tpu/train/trainer.py). ``Trainer`` (epochs, meters, callbacks,
checkpoints) comes with the port's training engine, ROADMAP module 10d."""

from __future__ import annotations


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
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the Trainer (epochs, meters, callbacks, checkpoints) comes with "
                                  "the port's training engine, ROADMAP module 10d")
