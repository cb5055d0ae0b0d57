"""The host LP loop's masked block against its eager loop, on the CPU.

On a CUDA card a stage of the host LP loop runs as blocks of
`lp.BLOCK` iterations (`lp._admm_block`), each captured once as a CUDA
graph and replayed.  Here the block runs uncaptured: every stage of an
eager solve is run again as blocks (`lp._on_card` made to say yes) and
must leave the state the eager loop left, bit for bit: u, v, u_prev,
the four accumulators, j, k, qres, avg_criterion, status and res.  Each
case names the situation it holds the block to and asserts that the
eager solve meets it.  PCG and a sharded workspace keep the eager loop:
their solves record no `lp.admm_block` span.
"""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu_torch import LPWorkspace, Settings, lp, solve_lp  # noqa: E402
from abip_tpu_torch.hsd import LPResiduals  # noqa: E402
from abip_tpu_torch.tools import generate  # noqa: E402
from abip_tpu_torch.utils import graphs, profiling  # noqa: E402
from bench import reference_smoke_lp  # noqa: E402


def _smoke():
    return reference_smoke_lp(m=20, n_rand=180, seed=3)


def _mid_block(s):
    return s["j"] % lp.BLOCK != 0


def _qres_exit(s):
    return s["status"] == 0 and s["qres"] < s["thresh"]


# name: (instance, settings, the situation some stage of the eager solve
# meets)
CASES = {
    "qres-stop-mid-block": (
        _smoke, {}, lambda s: _qres_exit(s) and _mid_block(s)
        and s["j"] > lp.BLOCK),
    # sparsity_ratio 0.3 makes the stopper round(1 / mu): 1, 1, 2, 5
    "stopper-below-block": (
        _smoke, dict(sparsity_ratio=0.3),
        lambda s: s["stopper"] < lp.BLOCK and s["j"] == s["stopper"]),
    "max-iters-mid-block": (
        _smoke, dict(max_admm_iters=437),
        lambda s: s["k"] == 437 and _mid_block(s)),
    "solved-mid-block": (
        _smoke, {}, lambda s: s["status"] == 1 and _mid_block(s)),
    "infeasible-mid-block": (
        lambda: generate.infeasible_lp(m=10, n=30, seed=2), {},
        lambda s: s["status"] == -2 and _mid_block(s)),
    "unbounded-mid-block": (
        lambda: generate.unbounded_lp(m=10, n=30, seed=1), {},
        lambda s: s["status"] == -1 and _mid_block(s)),
    "average-adopted": (_smoke, {}, lambda s: s["avg"]),
    "half-update": (
        _smoke, dict(half_update=True),
        lambda s: _qres_exit(s) and _mid_block(s)),
    # a restart average every 25 iterations: the blocks in which one
    # falls run eagerly
    "restart-block-eager": (
        _smoke, dict(restart_thresh=0, restart_fre=25),
        lambda s: s["j"] >= 25),
}


def _eager_stages(ws, monkeypatch):
    """Solve eagerly; every stage's arguments and resulting state."""
    stages, real = [], lp._run_inner_k

    def record(*args, **kw):
        out = real(*args, **kw)
        stages.append((args, kw, out))
        return out

    monkeypatch.setattr(lp, "_run_inner_k", record)
    ws.solve()
    monkeypatch.setattr(lp, "_run_inner_k", real)
    return stages


def _facts(args, out):
    _, _, mu, _, gamma, stopper, _, _, _ = args
    return dict(j=out.j, k=out.k, stopper=stopper, status=int(out.status),
                qres=float(out.qres), thresh=float(gamma * mu),
                avg=bool(out.avg_criterion))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.dtype, tuple(x.shape), x.contiguous().numpy().tobytes()
    return x


def _assert_same_state(eager, block):
    for name in lp.InnerState._fields:
        a, b = getattr(eager, name), getattr(block, name)
        if name == "res":
            for f in LPResiduals._fields:
                assert _bits(getattr(a, f)) == _bits(getattr(b, f)), f
        else:
            assert _bits(a) == _bits(b), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_leaves_the_eager_loops_state(monkeypatch, case):
    make, kw, situation = CASES[case]
    A, b, c = make()
    ws = LPWorkspace(A, b, c, Settings(eps=1e-6, **kw), device="cpu")
    stages = _eager_stages(ws, monkeypatch)
    assert any(situation(_facts(args, out)) for args, _, out in stages)

    runs, reads = [], []
    real_run, real_read = lp._AdmmBlock.run, lp._running
    monkeypatch.setattr(lp, "_on_card", lambda ops: True)
    monkeypatch.setattr(lp._AdmmBlock, "run",
                        lambda self: runs.append(1) or real_run(self))
    monkeypatch.setattr(lp, "_running",
                        lambda *a: reads.append(1) or real_read(*a))
    for args, kw_, eager in stages:
        _assert_same_state(eager, lp._run_inner_k(*args, **kw_))
    assert runs
    # a read as each stage starts, and one an eager iteration
    eager_iters = len(reads) - len(stages)
    if case == "restart-block-eager":
        assert eager_iters > 0
    else:
        assert eager_iters == 0


def test_threads_share_one_block_graph(monkeypatch):
    """Eight threads solving LPs of one shape at once, with the device
    test lifted and a short switch interval: a stage that finds the
    block's buffers held by another runs the eager loop, and every
    thread gets the answer it gets alone, bit for bit."""
    monkeypatch.setattr(lp, "_on_card", lambda ops: True)
    monkeypatch.setattr(lp, "_GRAPHS", graphs.GraphCache(lp._GRAPHS.kept))
    probs = [reference_smoke_lp(m=10, n_rand=60, seed=30 + i)
             for i in range(8)]
    alone = [solve_lp(*p, eps=1e-4, device="cpu") for p in probs]
    together = [None] * len(probs)

    def work(i):
        together[i] = solve_lp(*probs[i], eps=1e-4, device="cpu")

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(probs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(lp._GRAPHS) == 2         # without and with the final check
    for a, b in zip(alone, together):
        assert b is not None and a.admm_iters == b.admm_iters
        for name in "xys":
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _span_names(fn):
    """The names of the spans `fn()` records under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return [s.name for s in profiling.spans()]


@pytest.mark.parametrize("linsys", ["dense", "cg"])
def test_pcg_keeps_the_eager_loop(monkeypatch, linsys):
    """With the device test lifted, the direct path runs blocks and PCG,
    whose stop test reads every sweep, runs no block."""
    monkeypatch.setattr(lp, "_on_card", lambda ops: True)
    A, b, c = reference_smoke_lp(m=10, n_rand=60, seed=5)
    names = _span_names(lambda: solve_lp(A, b, c, eps=1e-4, linsys=linsys,
                                         device="cpu"))
    if linsys == "cg":
        assert "lp.admm_block" not in names and "lp.admm" in names
    else:
        assert "lp.admm_block" in names and "lp.admm" not in names


def _sharded_block_spans(rank, world):
    """Counts of `lp.admm_block` and `lp.admm` spans of a sharded solve
    (dense factor kept, then PCG) with the device test lifted."""
    from tests.torch_gloo import cpu_mesh

    lp._on_card = lambda ops: True
    A, b, c = reference_smoke_lp(m=10, n_rand=60, seed=5)
    out = []
    for linsys in ("dense", "cg"):
        ws = LPWorkspace(A, b, c, Settings(eps=1e-4), device="cpu").shard(
            cpu_mesh(world, "rows"), linsys=linsys)
        names = _span_names(ws.solve)
        out.append((names.count("lp.admm_block"), names.count("lp.admm")))
    return out


def test_sharded_workspace_keeps_the_eager_loop(tmp_path):
    from tests.torch_gloo import run_group

    for ranks in run_group(_sharded_block_spans, 2, tmp_path):
        for blocks, iters in ranks:
            assert blocks == 0 and iters > 0


def test_restart_in_block():
    """A block runs eagerly exactly where a restart average falls in
    it: past restart_thresh, at a multiple of restart_fre."""
    stgs = Settings(restart_thresh=100, restart_fre=25)
    assert not lp._restart_in_block(stgs, 0, 50)       # j + 1 never 25
    assert lp._restart_in_block(stgs, 20, 100)         # j + 1 = 25
    assert not lp._restart_in_block(stgs, 20, 80)      # k < 100 there
    assert not lp._restart_in_block(stgs, 20, 95)      # k = 99 at j = 24
    assert lp._restart_in_block(stgs, 20, 96)          # k = 100 at j = 24
    assert not lp._restart_in_block(Settings(), 0, 0)
    assert lp._restart_in_block(Settings(), 990, 99_991)  # j + 1 = 1000
