"""The port's spans (`abip_tpu_torch.utils.profiling`) in the LP batch
solver (delta engine) and the host LP loop, on the CPU: off without a
profiler, a tree per call on the profiler's clock with one, and the same
answers either way."""
import threading
from collections import Counter, defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import abip_tpu_torch  # noqa: E402
from abip_tpu_torch.parallel.batched import solve_lp_batch  # noqa: E402
from abip_tpu_torch.parallel.host_pool import solve_lp_pool  # noqa: E402
from abip_tpu_torch.utils import PhaseTimers, profiling  # noqa: E402
from bench import reference_smoke_lp  # noqa: E402

# the benchmark's batch options (portbench/configs/smoke_lp.json) at a
# chunk that fits the tiny instances
BATCH = dict(device="cpu", engine="delta", precision="mixed",
             solver="inverse", qres_period=64, avg_period=20)
FIELDS = ("x", "y", "s", "status", "admm_iters")
# how far a span's stamps may lie from its profiler event
CLOCK_NS = 1_000_000


def _lps(count=3):
    return [reference_smoke_lp(m=6, n_rand=14, density=0.5, seed=s)
            for s in range(count)]


def _stacks(lps):
    return tuple(np.stack([p[k] for p in lps]) for k in range(3))


def _batch(lps):
    return solve_lp_batch(*_stacks(lps), **BATCH)


def _single(lps):
    return abip_tpu_torch.solve_lp(*lps[0], device="cpu")


SOLVERS = {"lp_batch": _batch, "lp": _single}


def _fields(res):
    return {k: np.asarray(torch.as_tensor(getattr(res, k))) for k in FIELDS}


def _trees(spans):
    out = defaultdict(list)
    for s in spans:
        out[s.request_id].append(s)
    return list(out.values())


@pytest.fixture(scope="module")
def traced():
    """Each solver once with no profiler and once under a CPU profiler
    (after a session that warms the record): {layer: (untraced fields,
    traced fields, the spans, the session's host events)}."""
    lps = _lps()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("warm.solve"):
            pass
    out = {}
    for name, run in SOLVERS.items():
        profiling.clear()
        off = _fields(run(lps))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = run(lps)
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if not str(e.device_type()).endswith("CUDA")]
        out[name] = (off, _fields(on), profiling.spans(), events)
    profiling.clear()
    return out


def test_off_is_one_shared_noop():
    assert not profiling.tracing()
    assert profiling.annotate("lp.solve") is profiling.annotate("lp.admm")
    assert profiling.host_read() is profiling.annotate("lp.solve")
    with profiling.annotate("lp.solve") as span:
        span.note(admm_iters=1)


@pytest.mark.parametrize("layer", sorted(SOLVERS))
def test_off_records_nothing(layer):
    profiling.clear()
    SOLVERS[layer](_lps(2))
    assert profiling.spans() == []


@pytest.mark.parametrize("layer", sorted(SOLVERS))
def test_every_span_nests_in_its_parent(traced, layer):
    spans = traced[layer][2]
    trees = _trees(spans)
    assert len(trees) == 1
    by_id = {s.span_id: s for s in spans}
    for tree in trees:
        root, = [s for s in tree if s.parent_id is None]
        assert root.name == f"{layer}.solve"
        assert {s.request_id for s in tree} == {root.span_id}
        for s in tree:
            assert s.start_ns <= s.end_ns
            if s is root:
                continue
            parent = by_id[s.parent_id]
            assert parent.request_id == s.request_id
            assert parent.thread == s.thread
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert s.name.split(".")[0] == layer


def test_admm_spans_count_the_iterations(traced):
    on, spans = traced["lp"][1], traced["lp"][2]
    names = Counter(s.name for s in spans)
    assert names["lp.admm"] == int(on["admm_iters"]) > 0
    assert names["lp.project"] == names["lp.update"] == names["lp.admm"]


@pytest.mark.parametrize("layer,unit", [("lp_batch", "lp_batch.chunk"),
                                         ("lp", "lp.admm")])
def test_host_reads_cover_each_chunk_or_iteration(traced, layer, unit):
    names = Counter(s.name for s in traced[layer][2])
    assert names[unit] > 0
    assert names[f"{layer}.host_read"] >= names[unit]


def test_batch_spans_name_each_step_of_a_chunk(traced):
    spans = traced["lp_batch"][2]
    by_id = {s.span_id: s for s in spans}
    names = Counter(s.name for s in spans)
    chunks = names["lp_batch.chunk"]
    for step in ("anchor", "k1", "absorb", "check"):
        inside = [s for s in spans if s.name == f"lp_batch.{step}"]
        assert len(inside) == chunks
        assert {by_id[s.parent_id].name for s in inside} == {"lp_batch.chunk"}
    assert names["lp_batch.stage"] == names["lp_batch.outer"] > 0
    for once in ("upload", "setup", "extract"):
        assert names[f"lp_batch.{once}"] == 1


@pytest.mark.parametrize("layer", sorted(SOLVERS))
def test_tracing_changes_no_answer(traced, layer):
    off, on = traced[layer][:2]
    for k in FIELDS:
        np.testing.assert_array_equal(on[k], off[k])


def test_root_notes_the_answers_iterations(traced):
    for layer, (_, on, spans, _) in traced.items():
        root, = [s for s in spans if s.parent_id is None]
        noted = np.asarray(torch.as_tensor(root.attrs["admm_iters"]))
        np.testing.assert_array_equal(noted, on["admm_iters"])


@pytest.mark.parametrize("layer", sorted(SOLVERS))
def test_spans_on_the_profilers_clock(traced, layer):
    spans, events = traced[layer][2:]
    ranges = defaultdict(list)
    for name, start, end in events:
        ranges[name].append((start, end))
    mine = defaultdict(list)
    for s in spans:
        mine[s.name].append((s.start_ns, s.end_ns))
    assert set(mine) <= set(ranges)
    for name, stamps in mine.items():
        assert len(stamps) == len(ranges[name])
        for (s0, s1), (e0, e1) in zip(stamps, sorted(ranges[name])):
            assert abs(s0 - e0) < CLOCK_NS and abs(s1 - e1) < CLOCK_NS


def test_pool_workers_record_trees_of_their_own():
    lps = _lps(3)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        solve_lp_pool(lps, workers=2, device="cpu", engine="delta",
                      cadence="chunk", precision="mixed", qres_period=64)
    spans = profiling.spans()
    profiling.clear()
    trees = _trees(spans)
    assert len(trees) == len(lps)
    by_id = {s.span_id: s for s in spans}
    main = threading.get_ident()
    threads = []
    for tree in trees:
        root, = [s for s in tree if s.parent_id is None]
        assert root.name == "lp_batch.solve"
        assert {s.thread for s in tree} == {root.thread}
        assert all(by_id[s.parent_id].thread == s.thread
                   for s in tree if s is not root)
        threads.append(root.thread)
    # the first instance warms the kernels on the caller's thread; the
    # other two run in the pool's workers
    assert threads[0] == main and main not in threads[1:]


def test_record_keeps_the_newest_roots():
    profiling.clear()
    extra = 6
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(profiling.KEEP_ROOTS + extra):
            with profiling.annotate(f"root.{k}"):
                with profiling.annotate("root.child"):
                    pass
    spans = profiling.spans()
    profiling.clear()
    roots = [s.name for s in spans if s.parent_id is None]
    assert roots == [f"root.{k}" for k in range(
        extra, profiling.KEEP_ROOTS + extra)]
    assert len(spans) == 2 * profiling.KEEP_ROOTS


def test_host_read_takes_the_innermost_layer():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("lp.admm"):
            with profiling.host_read():
                pass
        with profiling.host_read():
            pass
    names = [s.name for s in profiling.spans()]
    profiling.clear()
    assert names == ["lp.admm", "lp.host_read", "host_read"]


def test_phases_are_spans_of_their_layer():
    timers = PhaseTimers(layer="qcp")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.phase("inner_admm"):
            pass
    names = [s.name for s in profiling.spans()]
    profiling.clear()
    assert names == ["qcp.inner_admm"] and timers.counts["inner_admm"] == 1


def test_only_a_verbose_solve_on_a_card_syncs_its_phases(monkeypatch):
    cuda = torch.device("cuda")
    assert PhaseTimers.of_solve(False, cuda, "lp").sync is None
    assert PhaseTimers.of_solve(True, cuda, "lp").sync \
        is torch.cuda.synchronize
    built = []
    real = PhaseTimers.of_solve.__func__

    def spy(cls, *args):
        built.append((args, real(cls, *args)))
        return built[-1][1]

    monkeypatch.setattr(PhaseTimers, "of_solve", classmethod(spy))
    _single(_lps(1))
    (args, timers), = built
    assert args[0] is False and timers.sync is None
    assert timers.counts["inner_admm"] > 0
