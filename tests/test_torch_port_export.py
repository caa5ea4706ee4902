"""The port's export and model info (utils/export.py, bin/export.py,
utils/model_info.py, utils/argv.py, the inverse key map of utils/weights.py)
against the JAX package's, on the CPU.

* ``parse_flags`` against JAX's on the same argv cases, errors included;
* ``export_program``: the loaded ``.pt2`` equals the module's forward bit
  for bit (float32, and bfloat16 under autocast), and the JAX model's
  ``apply`` on the same weights within the port's forward tolerance (max
  relative error 2e-4, tests/test_torch_port_models.py);
* ``export_weights_npz``: the same keys, dtypes and arrays as JAX's
  ``export_weights_npz`` of the same variables (HigherHRNet and
  ClassificationHRNet at C=8); ``flax_path_for`` total over both W32s;
* ``bin.export.main`` end to end on the CPU: the program, and the npz read
  back through ``load_flax_npz`` into a new net, strictly, bit for bit;
* ``count_params`` and ``param_table``'s total equal to JAX's;
  ``model_cost``'s flops equal to 2 multiply-adds per weight use of the
  convolutions, transposed convolutions and matmuls worked out from shapes.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from human_pose_tpu.models import ClassificationHRNet as JaxClassificationHRNet
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.utils import count_params as jax_count_params
from human_pose_tpu.utils import model_cost as jax_model_cost
from human_pose_tpu.utils import param_table as jax_param_table
from human_pose_tpu.utils.argv import parse_flags as jax_parse_flags
from human_pose_tpu.utils.export import export_weights_npz as jax_export_weights_npz
from human_pose_tpu_torch.bin import export as export_cli
from human_pose_tpu_torch.models import ClassificationHRNet, HigherHRNet, init_flax_default_
from human_pose_tpu_torch.utils import (
    count_params, export_program, export_weights_npz, flax_path_for, load_flax_npz, model_cost,
    param_table, parse_flags, variables_from_state_dict, variables_to_torch,
)
from tests.test_torch_port_models import SHALLOW, _randomize

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs: the suite runs several workers on a few cores, where
    torch's default thread pool spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the flag parser ---------------------------------------------------------------------------

DEFAULTS = {"port": 8000, "wait": 5.0, "tiny": False, "name": "x", "ckpt": None}
ARGV_CASES = {
    "typed": (["--port=9", "--tiny", "--wait=0.5", "--inference.ckpt_path=a.pt"], True),
    "bool_false": (["--tiny=false"], True),
    "bool_forms": (["--tiny=YES", "--name=a=b", "--ckpt=c.pt"], False),
    "positional_passthrough": (["serve", "--port=1", "-v"], True),
    "unknown_flag": (["--max_bath=8"], False),
    "bad_bool": (["--tiny=maybe"], False),
    "missing_value": (["--port"], False),
    "bad_int": (["--port=abc"], False),
    "bad_float": (["--wait=fast"], True),
    "positional_refused": (["serve"], False),
}


@pytest.mark.parametrize("case", list(ARGV_CASES))
def test_parse_flags_matches_jax(case):
    argv, passthrough = ARGV_CASES[case]

    def run(fn):
        try:
            return fn(list(argv), dict(DEFAULTS), passthrough), None
        except SystemExit as e:
            return None, str(e)

    got, want = run(parse_flags), run(jax_parse_flags)
    assert got == want
    if case in ("unknown_flag", "bad_bool", "missing_value", "bad_int", "bad_float"):
        assert want[1]  # an error, the same message


# -- the program -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shallow():
    """The shallow C=8 HigherHRNet with random params and BN statistics in
    both packages."""
    model = JaxHigherHRNet(num_kpts=17, C=8, s2d=False, **SHALLOW)
    variables = _random_variables(model)
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW).eval()
    net.load_state_dict(_tensors(variables_to_torch(variables)), strict=True)
    return model, variables, net


def _random_variables(model) -> dict:
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    rs = np.random.RandomState(0)
    return {col: _randomize(tree, rs) for col, tree in template.items()}


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _flat_outputs(out):
    hms, tags = out
    return [*hms, tags]


def test_export_program_round_trip_and_jax(shallow, tmp_path):
    model, variables, net = shallow
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    export_program(net, (3, 64, 64), tmp_path / "HigherHRNet.pt2")
    assert not net.training
    loaded = torch.export.load(str(tmp_path / "HigherHRNet.pt2")).module()
    with torch.no_grad():
        want = _flat_outputs(net(xt))
        got = _flat_outputs(loaded(xt))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    hms_j, tags_j = model.apply(variables, x, train=False)
    for g, w in zip(got, [*hms_j, tags_j]):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-3) < 2e-4


def test_export_program_bf16_under_autocast(shallow, tmp_path):
    """The bfloat16 program is the forward traced under autocast: equal to
    the module's autocast forward bit for bit, float32 outputs."""
    _, _, net = shallow
    xt = torch.from_numpy(np.random.RandomState(2).randn(1, 3, 64, 64).astype(np.float32))
    export_program(net, (3, 64, 64), tmp_path / "bf16.pt2", dtype=torch.bfloat16)
    loaded = torch.export.load(str(tmp_path / "bf16.pt2")).module()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        want = _flat_outputs(net(xt))
    with torch.no_grad():
        got = _flat_outputs(loaded(xt))
        f32 = _flat_outputs(net(xt))
    for g, w, f in zip(got, want, f32):
        assert g.dtype == torch.float32 and torch.equal(g, w)
        assert not torch.equal(g, f)  # it did run in bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        export_program(net, (3, 64, 64), tmp_path / "f16.pt2", dtype=torch.float16)


# -- the weights -------------------------------------------------------------------------------

def _classifier_variables():
    model = JaxClassificationHRNet(C=8, num_classes=10, **TINY)
    return model, _random_variables(model)


@pytest.mark.parametrize("arch", ["HigherHRNet", "ClassificationHRNet"])
def test_export_weights_npz_matches_jax(shallow, arch, tmp_path):
    if arch == "HigherHRNet":
        _, variables, net = shallow
    else:
        _, variables = _classifier_variables()
        net = ClassificationHRNet(C=8, num_classes=10, device="cpu", **TINY)
        net.load_state_dict(_tensors(variables_to_torch(variables)), strict=True)
    jax_export_weights_npz(variables, tmp_path / "jax.npz")
    export_weights_npz(net, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert any(k.startswith("batch_stats/") for k in want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # a state dict (prefixes, num_batches_tracked) writes the same file
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    export_weights_npz(sd, tmp_path / "sd.npz")
    with np.load(tmp_path / "sd.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("arch", ["HigherHRNet", "ClassificationHRNet"])
def test_inverse_key_map_total_over_w32(arch):
    """Every key of the W32 models maps to a flax path and back:
    ``variables_to_torch(variables_from_state_dict(sd)) == sd``."""
    net = (HigherHRNet(num_kpts=17, C=32, device="cpu") if arch == "HigherHRNet"
           else ClassificationHRNet(C=32, num_classes=1000, device="cpu"))
    sd = {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    back = variables_to_torch(variables_from_state_dict(sd))
    assert set(back) == set(sd)
    assert all(np.array_equal(back[k], sd[k].numpy()) for k in sd)
    with pytest.raises(KeyError):
        flax_path_for("backbone.nonexistent.0")
    with pytest.raises(KeyError):
        variables_from_state_dict({"backbone.conv1.alpha": torch.zeros(1)})


def test_export_cli_end_to_end(tmp_path, monkeypatch):
    """``bin.export.main`` on the keypoints yaml with a tiny net on the CPU
    (the yaml's accelerator gives bfloat16; the CPU override float32):
    the program runs as the model's forward, and the npz reloads strictly
    into a new net with the same state dict."""
    monkeypatch.chdir(tmp_path)
    program, npz = export_cli.main([
        f"--config={ROOT / 'experiments/keypoints/higher_hrnet_32.yaml'}",
        "--trainer.accelerator=cpu", "--inference.ckpt_path=null", "--net.params.C=8",
        "--net.params.num_blocks_per_stage=[1,1,1,1]", "--net.params.num_units=1",
        "--net.params.num_deconv_resid_blocks=1", "--out=exports", "--input_size=64"])
    assert program == Path("exports/HigherHRNet.pt2") and npz == Path("exports/HigherHRNet.weights.npz")
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW).eval()
    net.load_state_dict(_tensors(load_flax_npz(npz)), strict=True)
    # the CLI's weights: seeded as create_inference_model draws them
    ref = init_flax_default_(HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW),
                             torch.Generator().manual_seed(0)).eval()
    for (k, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    xt = torch.from_numpy(np.random.RandomState(3).randn(1, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        got = _flat_outputs(torch.export.load(str(program)).module()(xt))
        want = _flat_outputs(ref(xt))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- model info --------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["HigherHRNet", "ClassificationHRNet"])
def test_count_params_and_table_match_jax(shallow, arch):
    if arch == "HigherHRNet":
        _, variables, net = shallow
    else:
        _, variables = _classifier_variables()
        net = ClassificationHRNet(C=8, num_classes=10, device="cpu", **TINY)
    n = jax_count_params(variables["params"])
    assert count_params(net) == n
    total = lambda table: int(re.search(r"TOTAL\s+([\d,]+)", table).group(1).replace(",", ""))  # noqa: E731
    table = param_table(net)
    assert total(table) == total(jax_param_table(variables["params"])) == n
    assert "backbone.stages" in table and "backbone.conv1" in table


def _macs_from_shapes(net, x) -> int:
    """Multiply-adds of the convolutions, transposed convolutions and
    Linear layers of one forward, from their weights' and activations'
    shapes."""
    macs = []

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.ConvTranspose2d):
            n, _, h, w = inputs[0].shape  # each input pixel meets every weight
            macs.append(n * h * w * m.weight.numel() // m.groups)
        elif isinstance(m, torch.nn.Conv2d):
            n, _, h, w = out.shape  # each output pixel meets every weight
            macs.append(n * h * w * m.weight.numel() // m.groups)
        elif isinstance(m, torch.nn.Linear):
            macs.append(out.numel() // m.out_features * m.weight.numel())

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


@pytest.mark.parametrize("arch", ["HigherHRNet", "ClassificationHRNet"])
def test_model_cost_counts_two_flops_a_multiply_add(shallow, arch):
    """``model_cost``'s flops are 2 a multiply-add of the convolutions,
    transposed convolutions and matmuls (batch 2, 64^2); bytes are at least
    the input, the weights and the outputs; the model's mode and state are
    restored after a train-mode count. JAX's XLA estimate for the same
    forward (a fused program's) is printed beside it, not held to a bound:
    0.96 and 0.92 of the count here (``model_cost``'s docstring)."""
    if arch == "HigherHRNet":
        model, _, net = shallow
    else:
        model, _ = _classifier_variables()
        net = ClassificationHRNet(C=8, num_classes=10, device="cpu", **TINY).eval()
    x = torch.zeros((2, 3, 64, 64))
    cost = model_cost(net, (3, 64, 64), batch=2)
    assert cost["flops"] == 2 * _macs_from_shapes(net, x)
    assert cost["params"] == count_params(net)
    assert cost["bytes_accessed"] >= 4 * (x.numel() + cost["params"])
    before = {k: v.clone() for k, v in net.state_dict().items()}
    train = model_cost(net, (3, 64, 64), batch=2, train=True)
    assert train["flops"] == cost["flops"] and not net.training
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    xla = jax_model_cost(model, (64, 64, 3), batch=2)
    print(f"{arch}: port flops {cost['flops']:.4g} (bytes {cost['bytes_accessed']:.4g}), "
          f"JAX's XLA flops {xla['flops']:.4g} (bytes {xla['bytes_accessed']:.4g}), "
          f"ratio {xla['flops'] / cost['flops']:.4f}")
    assert xla["params"] == cost["params"] and xla["flops"] > 0
