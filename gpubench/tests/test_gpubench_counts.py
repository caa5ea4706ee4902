"""The yardstick's counts: the frozen operation counts against the papers,
and the refine's roofline on the decomposition benchmark's shapes."""

from __future__ import annotations

import pytest

from gpubench import counts
from gpubench.reference.nets import spec

POSE = {"model": "HigherHRNet", "C": 32, "num_kpts": 17}
CLS = {"model": "ClassificationHRNet", "C": 32, "num_classes": 1000}


def test_higher_hrnet_w32_matches_the_paper():
    """HigherHRNet-W32 at 512²: 47.9 GFLOPs (multiply-adds) in the paper
    (Cheng et al. 2020, Table 1). The projects' ``get_model_summary``
    charges a transposed convolution its kernel at every output pixel, four
    times the products its stride-2 4x4 kernel makes; this count charges
    the products. With the paper's charge for the one transposed
    convolution the two agree within the paper's rounding (0.05 G)."""
    macs = counts.flops(POSE, (512, 512)) / 2
    cin, cout = 32 + 2 * 17, 32
    deconv = cin * cout * 16 * 128 * 128  # products: the kernel at each input pixel
    assert macs == pytest.approx(46.2034e9, abs=1e5)
    assert abs(macs + 3 * deconv - 47.9e9) <= 0.05e9


def test_hrnet_w32_c_matches_the_paper():
    """HRNet-W32-C at 224²: 8.9 G multiply-adds (HRNet-Image-Classification's
    table); within its rounding (0.05 G)."""
    assert abs(counts.flops(CLS, (224, 224)) / 2 - 8.9e9) <= 0.05e9


@pytest.mark.parametrize("arch,hw", [(POSE, (512, 512)), (CLS, (224, 224))], ids=["pose", "cls"])
def test_a_training_step_counts_three_passes_less_the_images_gradient(arch, hw):
    fwd, step = counts.flops(arch, hw), counts.flops(arch, hw, train=True)
    first = 2 * 64 * 3 * 9 * (hw[0] // 2) * (hw[1] // 2)  # the stem conv on the image
    assert step == pytest.approx(3 * fwd - first, rel=1e-9)


def test_refine_bound_on_the_bench_shapes():
    """B=8 images of 17 maps at 512², one tag dim, 30 person slots: the
    0.0851 ms bytes bound of the decomposition benchmark's records."""
    ms, by = counts.refine_bound(8, 17, 1, 512 * 512, 30, 64)
    assert by == "bytes" and round(ms, 4) == 0.0851


def test_bound_takes_the_larger_time():
    assert counts.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert counts.bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    assert counts.bound(1.0, 989e9, counts.PEAK_BF16_S) == (pytest.approx(1.0), "operations")


def test_spec_sizes_do_not_depend_on_the_input():
    assert spec(POSE, (64, 64)) == spec(POSE, (512, 704))
