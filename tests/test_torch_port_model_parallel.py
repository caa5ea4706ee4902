"""The port's (data, space, model) mesh against one process and against the
JAX package, on the CPU (human_pose_tpu_torch/parallel/tensor.py, spatial.py,
dryrun.py vs human_pose_tpu/parallel/tensor.py, spatial.py and
``__graft_entry__.dryrun_multichip``).

* ``tensor_spec`` shards exactly the leaves JAX's rule shards, leaf by leaf
  through ``utils/weights.py::flax_path_for``: the shallow C=8 net at t = 2,
  4 and 17, and HigherHRNet-W32 at t = 2 (its 34-channel
  ``init_heatmaps_head`` sharded, the 17-channel final conv not);
* ``shard_batch_spatial``'s placement and refusals; ``make_mesh_3d``'s
  refusal of more ranks than the world; (1, 1) and (1, 1, 1) meshes of a
  gloo group of one (the spatial code path; a tensor axis of 1 shards
  nothing) equal to the plain step bit for bit;
* one gloo launch of 8 processes (tests/test_torch_port_model_parallel_worker.py)
  steps the shallow net once on the (1, 1, 2), (1, 2, 1), (4, 1, 2) and
  (2, 2, 2) meshes: the metrics within rtol 1e-5 of the one-process step
  (JAX's own bound between strategies) on every rank, and the gradients of
  every leaf, sharded ones gathered whole, within 1e-5 of its scale. The
  gradients are taken in float64: in float32 a ReLU input within rounding
  of 0 flips between summation orders, which moves a leaf's gradient by up
  to 1e-2 of its scale on this batch at four data shards in the 1-D
  data-parallel step too; in float64 every mesh agrees to ~1e-10. The
  optimizer state holds 1/t of each sharded leaf. The (2, 2, 2) metrics
  against JAX's ``keypoints_train_step`` under JAX's ``make_mesh_3d(2, 2,
  2)`` on the same batch and weights (rtol 1e-5); its eval forward,
  gathered, against the one-process forward within 1e-5; a (4, 1, 2)
  state through both checkpoint backends into a fresh one-process state:
  saved before any step, equal to the unsharded net bit for bit; saved
  after a float64 step, each rank's slices equal to the restored whole
  ones bit for bit and the whole ones within 1e-5 of the one-process
  step's parameters and Adam moments;
* ``dryrun_multichip(8)`` prints its three "ok" lines.

Every process gets a free port from the OS and a hard timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.parallel import make_mesh_3d as jax_make_mesh_3d
from human_pose_tpu.parallel import shard_batch_spatial as jax_shard_batch_spatial
from human_pose_tpu.parallel import shard_state_tensor as jax_shard_state_tensor
from human_pose_tpu.parallel import tensor_spec as jax_tensor_spec
from human_pose_tpu_torch.inference import BatchedKeypointsEvaluator, InferenceKeypointsModel
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.parallel import (
    Mesh, gather_to_main, make_mesh_2d, make_mesh_3d, replicate_global, shard_batch_spatial,
    shard_state_tensor, tensor_spec,
)
from human_pose_tpu_torch.parallel.distributed import launch_local
from human_pose_tpu_torch.parallel.dryrun import LR, dryrun_batch
from human_pose_tpu_torch.parallel.spatial import _NO_SPACE_LEAVES
from human_pose_tpu_torch.parallel.tensor import _CopyToTensorGroup, _GatherChannels
from human_pose_tpu_torch.train import TrainState, checkpoint, checkpoint_orbax, create_optimizer
from human_pose_tpu_torch.train import keypoints_train_step
from human_pose_tpu_torch.utils import weights
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)
from tests.test_spatial import TINY as JAX_TINY, _tiny_batch
from tests.test_tensor import _metrics as jax_metrics
from tests.test_torch_port_model_parallel_worker import (
    CKPT_MESH, FORWARD_MESH, MESHES, WORLD, make_net, moments, plain_step,
)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


# -- tensor_spec against JAX's rule -----------------------------------------------------

def _sharded_leaves(net, t: int) -> dict:
    """{state-dict key: sharded?} by the port's rule, every leaf but
    ``num_batches_tracked``."""
    modules = dict(net.named_modules())
    out = {}
    for key in net.state_dict():
        prefix, _, leaf = key.rpartition(".")
        if leaf != "num_batches_tracked":
            out[key] = tensor_spec(modules[prefix], leaf, t) is not None
    return out


def _jax_sharded_leaves(variables: dict, t: int) -> dict:
    """{port state-dict key: sharded?} by JAX's rule on the flax tree."""
    out = {}
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}

    def visit(path, leaf, value):
        prefix, _ = weights.torch_key_for(path)
        out[f"{prefix}.{leaf_names[leaf]}"] = jax_tensor_spec(value, t) != jax.sharding.PartitionSpec()
        return value

    for col in ("params", "batch_stats"):
        weights._walk(variables[col], visit)
    return out


@pytest.mark.parametrize("t", [2, 4, 17])
def test_tensor_spec_matches_jax_leaf_by_leaf(t):
    net = make_net()
    variables = weights.variables_from_state_dict(net.state_dict())
    ours = _sharded_leaves(net, t)
    for key in ours:  # every port leaf maps to a flax path
        weights.flax_path_for(key.rpartition(".")[0])
    assert ours == _jax_sharded_leaves(variables, t)
    assert any(ours.values()) and not all(ours.values())


def test_tensor_spec_w32_matches_jax():
    """HigherHRNet-W32 at t = 2: the flax tree's shapes from ``eval_shape``."""
    net = HigherHRNet(num_kpts=17, C=32, device="meta")
    shapes = jax.eval_shape(lambda: JaxHigherHRNet(num_kpts=17, C=32, s2d=False).init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3)), train=False))
    ours = _sharded_leaves(net, 2)
    assert ours == _jax_sharded_leaves(shapes, 2)
    assert ours["init_heatmaps_head.weight"] and ours["init_heatmaps_head.bias"]
    assert not ours["deconv_layers.0.final_layer.weight"]
    assert not ours["deconv_layers.0.final_layer.bias"]
    assert tensor_spec(net.deconv_layers[0].deconv[0], "weight", 2) == 1  # ConvTranspose2d: Cout


# -- placement, refusals, and one process ----------------------------------------------

def _fake_mesh(dims: tuple, coords: tuple) -> Mesh:
    """A mesh record for placement only (no groups)."""
    return Mesh(rank=0, world_size=1, device=torch.device("cpu"), dims=dims, coords=coords)


def test_shard_batch_spatial_placement():
    """Rows over space for [N, C, H, W] and [N, H, W]; joints over data
    only (JAX's ``_NO_SPACE_LEAVES``); uneven splits and images whose bands
    are not multiples of 32 rows raise."""
    assert _NO_SPACE_LEAVES == ("joints", "labels", "image_ids")
    batch = dryrun_batch(WORLD)
    part = shard_batch_spatial(_fake_mesh((2, 2, 2), (1, 1, 0)), batch)
    assert torch.equal(part["images"], batch["images"][4:, :, 32:])
    assert torch.equal(part["heatmaps"][1], batch["heatmaps"][1][4:, :, 16:])
    assert torch.equal(part["masks"][0], batch["masks"][0][4:, 8:])
    assert torch.equal(part["joints"], batch["joints"][4:])
    with pytest.raises(ValueError, match="bands of a multiple of 32 rows"):
        shard_batch_spatial(_fake_mesh((1, 4), (0, 0)), batch)
    with pytest.raises(ValueError, match="does not split over 3 data shards"):
        shard_batch_spatial(_fake_mesh((3, 1), (0, 0)), batch)
    with pytest.raises(ValueError, match="no space axis"):
        shard_batch_spatial(Mesh(rank=0, world_size=1, device=torch.device("cpu")), batch)


def test_data_mesh_apis_refuse_an_nd_mesh():
    """``replicate_global``, ``gather_to_main`` and the batched evaluator
    work over the 1-D data mesh's group; an n-D mesh's group is the moment
    group, so they refuse it before any collective."""
    mesh = _fake_mesh((1, 1, 2), (0, 0, 1))
    with pytest.raises(ValueError, match="replicate_global takes the data-parallel mesh"):
        replicate_global(mesh, make_net())
    with pytest.raises(ValueError, match="gather_to_main takes the data-parallel mesh"):
        gather_to_main(mesh, [1])
    im = InferenceKeypointsModel(make_net(), input_size=64, device="cpu")
    with pytest.raises(ValueError, match="the batched evaluator takes the data-parallel mesh"):
        BatchedKeypointsEvaluator(im, batch_size=2, mesh=mesh)


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo group of this process alone, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_is_the_plain_step(group_of_one):
    """``make_mesh_3d`` refuses more ranks than the world; on a (1, 1)
    mesh (the spatial code path: band bookkeeping, the tag gather, the
    BatchNorms over a group of one, the reductions) and on a (1, 1, 1)
    mesh (a tensor axis of 1 shards nothing, so it is the (1, 1) step) the
    step equals the plain step bit for bit; the two tensor operators over
    the group of one are the identity, forward and backward; a net with a
    layer that has no mesh version is refused."""
    with pytest.raises(ValueError, match="only 1 devices"):
        make_mesh_3d(2, 1, 1)
    plain = plain_step()
    for mesh in (make_mesh_2d(1, 1), make_mesh_3d(1, 1, 1)):
        assert mesh.shape == dict(zip(("data", "space", "model"), mesh.dims)) and mesh.dims in (
            (1, 1), (1, 1, 1))
        net = shard_state_tensor(mesh, make_net())
        sharded = [m.sharded for m in net.modules() if hasattr(m, "sharded")]
        assert sharded and not any(sharded)
        state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), device="cpu",
                                  mesh=mesh)
        state, metrics = keypoints_train_step(state, shard_batch_spatial(mesh, dryrun_batch(WORLD)), LR)
        assert {k: float(v) for k, v in metrics.items()} == plain["metrics"]
        for key, value in net.state_dict().items():
            assert torch.equal(value, plain["state"][key]), key
    x = torch.randn((2, 6, 8, 8), generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    y = _GatherChannels.apply(_CopyToTensorGroup.apply(x, mesh.tensor_group), mesh)
    y.backward(g)
    assert torch.equal(y, x) and torch.equal(x.grad, g)
    with pytest.raises(ValueError, match="MaxPool2d"):
        shard_state_tensor(mesh, torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.MaxPool2d(2)))


# -- the 8-process launch and the dry run ----------------------------------------------

@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The worker launch and ``dryrun_multichip(8)`` as a process, started
    together; whatever still runs after the module is killed."""
    tmp = tmp_path_factory.mktemp("mp")
    procs = launch_local(WORLD, "from tests.test_torch_port_model_parallel_worker import worker; "
                                f"worker({str(tmp)!r})")
    dryrun = subprocess.Popen(
        [sys.executable, "-c", "from human_pose_tpu_torch.parallel.dryrun import dryrun_multichip; "
         "dryrun_multichip(8)"], cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield tmp, procs, dryrun
    for p in (*procs, dryrun):
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def references(launched):
    """While the processes run: the one-process steps (float32 and float64)
    and forward, and JAX's step on its (2, 2, 2) mesh from the same
    weights."""
    plain = plain_step()
    plain64 = plain_step(torch.float64)
    net = make_net().eval()
    with torch.no_grad():
        hms, tags = net(dryrun_batch(WORLD)["images"][:4])
    model = JaxHigherHRNet(s2d=False, **JAX_TINY)
    variables = weights.variables_from_state_dict(make_net().state_dict())
    jax_3d = jax_metrics(model, jax_make_mesh_3d(2, 2, 2), jax_shard_batch_spatial,
                         jax_shard_state_tensor, _tiny_batch(), variables)
    return {"plain": plain, "plain64": plain64, "forward": [*hms, tags], "jax_3d": jax_3d}


@pytest.fixture(scope="module")
def runs(launched, references):
    """Every rank's results, {rank: {mesh dims: record}}."""
    tmp, procs, _ = launched
    logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {r: torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)}


def test_worker_batch_is_jax_batch():
    batch, want = dryrun_batch(WORLD), _tiny_batch()
    assert np.array_equal(batch["images"].numpy().transpose(0, 2, 3, 1), want["images"])
    for a, b in zip(batch["heatmaps"], want["heatmaps"]):
        assert np.array_equal(a.numpy().transpose(0, 2, 3, 1), b)
    assert np.array_equal(batch["joints"].numpy(), want["joints"])


@pytest.mark.parametrize("dims", MESHES)
def test_mesh_step_matches_one_process(runs, references, dims):
    plain = references["plain"]
    ranks = [r for r in range(WORLD) if dims in runs[r]]
    assert len(ranks) == int(np.prod(dims))
    rec = runs[0][dims]
    assert rec["shape"] == {"data": dims[0], "space": dims[1], "model": dims[2]}
    for r in ranks:
        got = runs[r][dims]["metrics"]
        assert got.keys() == plain["metrics"].keys()
        for key, want in plain["metrics"].items():
            np.testing.assert_allclose(got[key], want, rtol=1e-5, err_msg=f"rank {r} {key}")
    for key, want in references["plain64"]["grads"].items():
        got = rec["grads"][key]
        assert got.shape == want.shape and got.dtype == torch.float64, key
        err = float((got - want).abs().max() / want.abs().max().clamp(min=1e-12))
        assert err <= 1e-5, (key, err)


def test_optimizer_state_is_sharded(runs):
    """Adam's two moments hold 1/t of every sharded leaf on each rank."""
    net = make_net()
    for dims in MESHES:
        t = dims[2]
        mods = dict(net.named_modules())
        want = 2 * sum(p.numel() // t if tensor_spec(mods[n.rpartition(".")[0]], n.rpartition(".")[2], t)
                       is not None else p.numel() for n, p in net.named_parameters())
        assert all(runs[r][dims]["opt_numel"] == want for r in range(WORLD) if dims in runs[r])
    full = 2 * sum(p.numel() for p in net.parameters())
    assert runs[0][CKPT_MESH]["opt_numel"] < 0.51 * full


def test_3d_mesh_matches_jax(runs, references):
    """The (2, 2, 2) step against JAX's on its (2, 2, 2) mesh."""
    got, want = runs[0][(2, 2, 2)]["metrics"], references["jax_3d"]
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_spatial_forward_matches_one_process(runs, references):
    """The eval forward on the (2, 2, 2) mesh (halo exchanges, channel
    gathers), rank 0's data shard gathered over its space group."""
    got = runs[0][FORWARD_MESH]["forward"]
    for g, w in zip(got, references["forward"]):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5


def _restore(path: Path, backend: str, dtype: torch.dtype) -> TrainState:
    """A fresh one-process state of ``dtype`` restored from ``path``."""
    net = make_net().to(dtype)
    state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), device="cpu")
    if backend == "file":
        checkpoint.load_train_state(state, checkpoint.load_checkpoint(path.with_suffix(".pt")))
    else:
        checkpoint_orbax.load_train_state(state, checkpoint_orbax.load_checkpoint(
            path.with_name(path.name + "_dir")))
    return state


@pytest.mark.parametrize("backend", ["file", "directory"])
def test_tensor_sharded_checkpoint_round_trip(launched, runs, references, backend):
    """The (4, 1, 2) state saved by every rank restores into a fresh
    one-process state. Saved freshly sharded, before any step: the
    parameters and statistics equal the unsharded net's bit for bit.
    Saved after a float64 step: each tensor rank's slice of every
    parameter and of Adam's moments (taken by name on that rank) equals its
    slice of the restored whole one bit for bit, and the whole moments and
    parameters match the one-process float64 step within the gradients'
    1e-5 of each leaf's scale; the step counts."""
    tmp = launched[0]
    fresh = _restore(tmp / "fresh", backend, torch.float32)
    assert fresh.step == 0
    want = make_net().state_dict()
    got = fresh.model.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key

    stepped = _restore(tmp / "step64", backend, torch.float64)
    assert stepped.step == 1
    params = dict(stepped.model.named_parameters())
    whole = {"params": {n: p.detach() for n, p in params.items()}, "moments": moments(stepped)}
    dims = runs[0][CKPT_MESH]["slices64"]["dims"]
    assert any(name in dims for name in params)
    t = CKPT_MESH[2]
    for r in (0, 1):  # tensor indices 0 and 1 of data shard 0
        rank = runs[r][CKPT_MESH]
        t_index, live = rank["coords"][2], rank["slices64"]
        for name, value in whole["params"].items():
            part = value.chunk(t, dims[name])[t_index] if name in dims else value
            assert torch.equal(part, live["params"][name]), (r, name)
            for key, moment in whole["moments"][name].items():
                part = moment.chunk(t, dims[name])[t_index] if name in dims else moment
                assert torch.equal(part, live["moments"][name][key]), (r, name, key)
    plain = references["plain64"]
    for name, value in whole["params"].items():
        for got_v, want_v, what in [(value, plain["state"][name], "param"),
                                    *[(whole["moments"][name][k], plain["moments"][name][k], k)
                                      for k in ("exp_avg", "exp_avg_sq")]]:
            err = float((got_v - want_v).abs().max() / want_v.abs().max().clamp(min=1e-12))
            assert err <= 1e-5, (name, what, err)


def test_dryrun_multichip_prints_three_ok_lines(launched, runs):
    dryrun = launched[2]
    log = dryrun.communicate(timeout=TIMEOUT_S)[0]
    assert dryrun.returncode == 0, log[-4000:]
    ok = [line for line in log.splitlines() if line.startswith("dryrun_multichip(8): ok")]
    assert len(ok) == 3, log[-4000:]
    assert "mesh2=(data=2, space=2, model=2)" in ok[1] and "pipeline segments=4" in ok[2]
