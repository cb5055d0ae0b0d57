"""The check's control and faults: the plain reference in float32 in the
program's place, and the timed path broken underneath, must each make
`correct` false; on the card, the control at the cell's own size."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.tests.cases import CELLS, tiny_cell



def run(cell, seed=2 ** 31 + 99, device="cpu", per_call=None):
    line, _ = harness.run(cell.name, seed, 0.2, 0, device=device, cell=cell,
                          per_call=per_call)
    return line


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    cell.entry = control.control_entry()
    assert run(cell, per_call=cell.traffic["check_sample"])["correct"] \
        is False


@pytest.mark.parametrize("name", CELLS)
def test_control_stops_at_the_configurations_eps(name, monkeypatch):
    """The reference in float32 is asked for the configuration's own eps:
    a control that stopped short would read not correct for that alone."""
    from portbench import reference

    got = []
    monkeypatch.setattr(reference, "solve",
                        lambda A, b, c, cones, eps: got.append(eps))
    cell = tiny_cell(name)
    entry = control.control_entry()
    call = entry.prepare(cell.config, cell.traffic, "cpu")
    call(entry.stage(harness.make_instances(cell, [[1, 2, 3]])))
    assert got == [cell.config["eps"]]


def unchanged(ans):
    """The state a solve starts from, returned as its answer."""
    return dict(ans, **{k: np.zeros_like(ans[k]) for k in ("x", "y", "s")})


def half_batch(ans):
    """Half of the lanes solved, their answers copied over the rest."""
    h = (ans["x"].shape[0] + 1) // 2
    return {k: np.concatenate([v[:h], v[:h]])[:v.shape[0]]
            for k, v in ans.items()}


def altered(ans):
    """One value of one answer changed where it is produced."""
    x = ans["x"].copy()
    x[0, np.argmax(np.abs(x[0]))] *= 1.01
    return dict(ans, x=x)


FAULTS = [(n, f) for n in CELLS for f in (unchanged, half_batch, altered)
          if f is not half_batch or "batch" in n]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    real = cell.entry
    cell.entry = SimpleNamespace(
        prepare=real.prepare, stage=real.stage,
        answers=lambda res: fault(real.answers(res)))
    assert run(cell)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(name)
    cell.entry = control.control_entry()
    for seed in (101, 102, 103):
        assert run(cell, seed, device="cuda",
                   per_call=cell.traffic["check_sample"])["correct"] is False
