"""The control: the plain reference in TF32 (the precision below the
float32 with TF32 off that both configurations state), in the program's
place, has to read ``correct`` false. TF32 is emulated by rounding every
product's operands (reference/arv.py), so the control runs on the CPU at
the rehearsal's size and, on a card, at each cell's own size. The readings
that set the limits come from portbench/calibrate.py on the card."""

import time

import pytest

from portbench.harness.common import load_module, make_ctx, setup_env

CELLS = ["va-train", "va-serve-clip", "vasa-serve-moment"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_rehearsal_size(rehearse, cell):
    _, out = rehearse(cell, 3_000_000_019, 0.5, mode="control")
    assert not all(c.ok for c in out.checks), [(c.name, c.value, c.limit) for c in out.checks]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    import torch

    from portbench.reference.arv import tf32_round

    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-12, -(1 + 3 * 2**-12), 3.14159265])
    assert tf32_round(x).tolist() == [1.0, 1 + 2**-10, 1.0, -(1 + 2**-10), 3.140625]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cell_s_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")
    setup_env()
    ctx = make_ctx(cell, 3_000_000_019, 1.0, False, False, time.perf_counter(), "control")
    ctx.device = torch.device("cuda", 0)
    out = load_module("drivers", ctx.workload["driver"]).run(ctx)
    assert not all(c.ok for c in out.checks), [(c.name, c.value, c.limit) for c in out.checks]
