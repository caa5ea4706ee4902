"""The control that each cell's comparison has to fail: the reference in the
program's place with its products in float8 (``gpubench/control.py``), and
for training a step on half of each batch: its inputs cut, or the whole
batch forward and the loss, or its tag term, over half of the rows. On the
CPU at the tiny sizes of
``tiny.py``; on the card at each cell's own sizes (marked ``cuda``, skipped
without a card):

    python3 -m pytest -o addopts="" -m cuda gpubench/tests/test_gpubench_control.py
"""

from __future__ import annotations

import pytest
import torch

from gpubench import control, harness
from gpubench.tests import tiny


def _fails(readings: dict, limits: dict) -> list:
    """The compared numbers (those with a limit) that ``readings`` fail."""
    return [k for k, v in readings.items() if k in limits and not v <= limits[k]]


FAULTS = ("half_batch", "half_loss", "half_tag_loss")


def _held(cell: dict, rec: dict) -> None:
    limits = cell["workload"]["limits"]
    assert _fails(rec["control"], limits), (rec["control"], limits)
    for fault in FAULTS:
        if fault in rec:
            assert _fails(rec[fault], limits), (fault, rec[fault], limits)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_at_tiny_size(layout, cell):
    c = layout.cell(cell)
    _held(c, control.readings(c, 2**31 + 99, torch.device("cpu"), layout))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' sizes are the card's")
    c = harness.Layout().cell(cell)
    _held(c, control.readings(c, 2**31 + 1234, torch.device("cuda")))
