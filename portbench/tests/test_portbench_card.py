"""The control of the hac cells on the card, at the cells' own sizes: the
plain reference in TF32 (the precision below the configuration's float32
without TF32) in the program's place fails a number of the cell, where the
program passes them all. TF32 acts only on a CUDA device, so these skip on
the CPU. Run on the card: python -m pytest -q portbench/tests/test_portbench_card.py"""

import pytest
import torch

from portbench import harness

SEED = 2**31 + 17


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 does not act on the CPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hac.train_rd", "hac.view"])
def test_the_tf32_control_is_not_correct(name, card):
    spec = harness.load_cell(name)
    session = harness.driver(spec.driver).setup(spec, SEED, card)
    session.window(1.0, trace=False)
    session.release()
    assert all(c.ok for c in session.check())
    checks = session.control()
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]
