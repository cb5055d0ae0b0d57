"""The span metrics (`portbench/spans.py`, `metrics/lp_batch.host_*`,
`lp_batch.chunk_host_ms`, `lp.host_*`, `lp.block_iter_share`) on a CPU
`--trace 1` run of each cell at a tiny size, and their refusals: too few
recorded calls, calls that are not the profiled ones, a program without
the record; the block share, which only a card's run reads above 0, on
span trees made up here."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, spans
from portbench.tests.cases import tiny_cell

METRICS = {
    "smoke_lp.batch16": ("lp_batch.host_reads_per_batch",
                         "lp_batch.host_wait_share",
                         "lp_batch.chunk_host_ms"),
    "smoke_lp.single": ("lp.host_reads_per_admm", "lp.host_wait_share"),
}
CASES = [(cell, m) for cell, names in METRICS.items() for m in names]
# blocks run only on a card: on the CPU the share reads 0, not above
ALL_CASES = CASES + [("smoke_lp.single", "lp.block_iter_share")]


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


@pytest.mark.parametrize("cell,name", ALL_CASES)
def test_none_with_fewer_trees_than_calls(runs, cell, name):
    _, iters = runs[cell]
    assert _metric(name).read(_record(iters)) is not None
    assert _metric(name).read(_record(iters + iters)) is None
    assert _metric(name).read(_record([a + 1 for a in iters])) is None


@pytest.mark.parametrize("cell,name", ALL_CASES)
def test_none_without_the_programs_record(runs, cell, name, monkeypatch):
    from abip_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _metric(name).read(_record(runs[cell][1])) is None
    assert _metric(name).read(SimpleNamespace(profile=None)) is None


def test_host_reads_per_admm_is_the_eager_loops_reading(runs):
    """On the CPU every iteration is an eager `lp.admm` span, so reads
    over the roots' `admm_iters` is reads over `lp.admm` spans."""
    rec = _record(runs["smoke_lp.single"][1])
    ts = spans.trees(rec, "lp")
    eager = sum(len(spans.named(t, "lp.host_read")) for t in ts) \
        / sum(len(spans.named(t, "lp.admm")) for t in ts)
    assert _metric("lp.host_reads_per_admm").read(rec) == eager


def _span(name, span_id, parent_id, **attrs):
    return SimpleNamespace(name=name, span_id=span_id, parent_id=parent_id,
                           request_id=1, attrs=attrs, start_ns=span_id,
                           end_ns=span_id + 1)


@pytest.mark.parametrize("blocks,share", [(3, 100.0), (1, 100.0 / 3),
                                          (0, 0.0)],
                         ids=["every-iteration", "a-third", "no-block"])
def test_block_share_on_made_up_trees(blocks, share, monkeypatch):
    """One solve of 30 ADMM iterations: `blocks` blocks of 10 noted
    iterations, the rest eager."""
    from abip_tpu_torch.utils import profiling

    tree = [_span("lp.solve", 1, None, admm_iters=30)]
    tree += [_span("lp.admm_block", 2 + i, 1, iters=10)
             for i in range(blocks)]
    tree += [_span("lp.admm", 10 + i, 1) for i in range(30 - 10 * blocks)]
    monkeypatch.setattr(profiling, "spans", lambda: tree)
    metric = _metric("lp.block_iter_share")
    assert metric.read(_record([np.array([30])])) == pytest.approx(share)
    assert metric.read(SimpleNamespace(profile=None)) is None
    monkeypatch.setattr(profiling, "spans", lambda: tree[1:])
    assert metric.read(_record([np.array([30])])) is None
