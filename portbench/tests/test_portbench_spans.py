"""The six span metrics (`portbench/spans.py`, `metrics/lp_batch.host_*`,
`lp_batch.chunk_host_ms`, `lp.host_*`, `lp.admm_host_us`) on a CPU
`--trace 1` run of each cell at a tiny size, and their refusals: too few
recorded calls, calls that are not the profiled ones, a program without
the record."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness
from portbench.tests.cases import tiny_cell

METRICS = {
    "smoke_lp.batch16": ("lp_batch.host_reads_per_batch",
                         "lp_batch.host_wait_share",
                         "lp_batch.chunk_host_ms"),
    "smoke_lp.single": ("lp.host_reads_per_admm", "lp.host_wait_share",
                        "lp.admm_host_us"),
}
CASES = [(cell, m) for cell, names in METRICS.items() for m in names]


def _metric(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


@pytest.fixture(scope="module")
def runs():
    """{cell: (the result line, the profiled calls' ADMM counts)} of one
    tiny `--trace 1` run each, the program's record emptied before."""
    from abip_tpu_torch.utils import profiling

    profiling.clear()
    out = {}
    for cell in METRICS:
        line, _ = harness.run(cell, 2 ** 31 + 4321, 0.3, 1, device="cpu",
                              cell=tiny_cell(cell))
        layer = METRICS[cell][0].split(".")[0]
        iters = [np.asarray(s.attrs["admm_iters"]).reshape(-1)
                 for s in profiling.spans()
                 if s.parent_id is None and s.name == f"{layer}.solve"]
        out[cell] = (line, iters)
    return out


def _record(iters):
    return SimpleNamespace(profile=SimpleNamespace(
        calls=[(0.1, {"admm_iters": a}) for a in iters]))


@pytest.mark.parametrize("cell,name", CASES)
def test_reads_a_positive_value(runs, cell, name):
    line, _ = runs[cell]
    assert line["correct"] is True
    assert line["metrics"][name]["value"] > 0


@pytest.mark.parametrize("cell,name", CASES)
def test_none_with_fewer_trees_than_calls(runs, cell, name):
    _, iters = runs[cell]
    assert _metric(name).read(_record(iters)) is not None
    assert _metric(name).read(_record(iters + iters)) is None
    assert _metric(name).read(_record([a + 1 for a in iters])) is None


@pytest.mark.parametrize("cell,name", CASES)
def test_none_without_the_programs_record(runs, cell, name, monkeypatch):
    from abip_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _metric(name).read(_record(runs[cell][1])) is None
    assert _metric(name).read(SimpleNamespace(profile=None)) is None
