"""The worker of ``tests/test_torch_port_checkpoint_dir.py``'s gloo
processes, in a module of its own that imports only torch and the port (no
JAX), so a process starts in half the time. It holds no tests.
"""

from __future__ import annotations

import torch

from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.parallel import finalize_distributed, setup_distributed
from human_pose_tpu_torch.train import TrainState, checkpoint_orbax

K = 17
SHALLOW = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1, num_deconv_resid_blocks=1)


def stepped_state(seed: int = 0, steps: int = 2) -> TrainState:
    """The shallow C=8 HigherHRNet from ``seed`` after ``steps`` Adam steps
    on a seeded batch at 64^2: parameters, BatchNorm statistics and Adam's
    moments all moved."""
    torch.manual_seed(seed)
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW).train()
    opt = torch.optim.Adam(net.parameters(), 1e-3)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(seed))
    for _ in range(steps):
        opt.zero_grad()
        hms, tags = net(x)
        (sum(h.square().mean() for h in hms) + tags.square().mean()).backward()
        opt.step()
    return TrainState(net, opt, steps, torch.device("cpu"))


def fresh_state() -> TrainState:
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    return TrainState(net, torch.optim.Adam(net.parameters(), 1e-3), 0, torch.device("cpu"))


def worker(ckpt_dir: str, out_path: str) -> None:
    """One process of a gloo group: save the stepped state into
    ``ckpt_dir`` (every rank), then load it into a fresh state; the loaded
    model and optimizer state and the files this rank saw to
    ``out_path``."""
    torch.set_num_threads(1)
    rank = setup_distributed("cpu")
    try:
        state = stepped_state()
        checkpoint_orbax.save_checkpoint(ckpt_dir, state, epoch=4, metrics_state={"rank": rank})
        loaded = fresh_state()
        ckpt = checkpoint_orbax.load_checkpoint(ckpt_dir)
        checkpoint_orbax.load_train_state(loaded, ckpt)
        torch.save({"model": loaded.model.state_dict(), "optim": loaded.optimizer.state_dict(),
                    "step": loaded.step, "epoch": ckpt["epoch"], "metrics": ckpt["metrics"]},
                   out_path)
    finally:
        finalize_distributed()
