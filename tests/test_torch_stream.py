"""`abip_tpu_torch.parallel.segmented` and `.host_pool` against the
reference's `abip_tpu.parallel.segmented` and `.host_pool`.

The suites of `tests/test_parallel.py:236` (5 LPs m=10 n=30 streamed
through B=2 lanes, seg_chunks=8, qres_period=16) and `:483` (4 LPs
through the pool, precision "mixed", solver "inverse") from the same
numpy seeds go through both packages on the CPU.  Both run f32 products
(in the anchored deltas) summed in other orders, so: equal statuses,
objectives within 1e-6 relative of the reference's; the ADMM and IPM
counts come out equal on these suites and are held equal.  The pool at
workers=4 equals workers=1 bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.parallel import host_pool as jpool  # noqa: E402
from abip_tpu.parallel import segmented as jseg  # noqa: E402
from abip_tpu_torch.parallel import host_pool, segmented  # noqa: E402
from conftest import random_lp  # noqa: E402

DEV = dict(device="cpu")
POOL_KW = dict(eps=1e-6, precision="mixed", solver="inverse")


def _suite(seed, count, m=10, n=30):
    rng = np.random.default_rng(seed)
    return [random_lp(rng, m, n) for _ in range(count)]


@pytest.fixture(scope="module")
def stream5():
    """The suite through both packages; the port's segments are watched:
    each one's lane statuses on entry and on exit."""
    probs = _suite(20, 5)
    kw = dict(B=2, seg_chunks=8, qres_period=16, eps=1e-6)
    ref, ref_info = jseg.solve_lp_stream(probs, **kw)
    stats = []
    make = segmented.make_segment_fn

    def watched(**opts):
        segment = make(**opts)

        def run(data, state):
            before = state.status.tolist()
            state = segment(data, state)
            stats.append((before, state.status.tolist()))
            return state

        return run

    segmented.make_segment_fn = watched
    try:
        out, info = segmented.solve_lp_stream(probs, **DEV, **kw)
    finally:
        segmented.make_segment_fn = make
    return probs, ref, ref_info, out, info, stats


def test_stream_matches_reference(stream5):
    probs, ref, ref_info, out, info, _ = stream5
    assert info["solved"] == ref_info["solved"] == 5
    assert info["B"] == ref_info["B"] == 2
    for r, p, (A, b, c) in zip(ref, out, probs):
        assert p["status"] == r["status"] == 1
        assert (p["admm_iters"], p["ipm_iters"]) == (r["admm_iters"],
                                                     r["ipm_iters"])
        assert abs(p["pobj"] - r["pobj"]) <= 1e-6 * abs(r["pobj"]), (
            p["pobj"], r["pobj"])
        hs = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
        assert abs(p["pobj"] - hs) <= 1e-4 * (1 + abs(hs))
        assert p["x"].shape == (30,) and p["y"].shape == (10,)


def test_stream_parks_drained_lane(stream5):
    """5 instances on 2 lanes: once the suite is drained, a finished lane
    is parked at STATUS_IDLE, and a segment leaves a parked lane parked."""
    *_, stats = stream5
    idle = segmented.STATUS_IDLE
    parked = [(t, ln) for t, (before, _) in enumerate(stats)
              for ln in range(2) if before[ln] == idle]
    assert parked
    for t, ln in parked:
        assert stats[t][1][ln] == idle


def test_parked_lane_state_is_frozen():
    """A segment leaves a lane with a nonzero status untouched."""
    A, b, c = _suite(21, 1)[0]
    t = [torch.as_tensor(x)[None] for x in (A, b, c)]
    data = segmented.lp_setup(*t)
    st = segmented.lp_init_state(1, 10, 30)
    st = st._replace(status=torch.full((1,), segmented.STATUS_IDLE,
                                       dtype=torch.int32))
    out = segmented.make_segment_fn(seg_chunks=4, qres_period=16)(data, st)
    for a, b_ in zip(out[:-1], st[:-1]):
        assert torch.equal(a, b_)


def test_stream_rejects_mixed_shapes():
    probs = _suite(22, 1)
    A2, b2, c2 = _suite(23, 1, m=11)[0]
    with pytest.raises(ValueError, match="same-shape"):
        segmented.solve_lp_stream([probs[0], (A2, b2, c2)], **DEV)


def test_setup_matches_reference():
    """`lp_setup`'s f64 fields against the reference's, 1e-10 relative
    to each field's scale."""
    A, b, c = _suite(24, 1)[0]
    ref = jseg.lp_setup(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    out = segmented.lp_setup(*[torch.as_tensor(x)[None] for x in (A, b, c)])
    for name in segmented.LPLaneData._fields:
        r = np.asarray(getattr(ref, name), np.float64)
        p = getattr(out, name)[0].double().numpy()
        tol = 1e-6 if getattr(out, name).dtype == torch.float32 else 1e-10
        assert np.abs(p - r).max() <= tol * max(np.abs(r).max(), 1e-300), name


@pytest.fixture(scope="module")
def pool4():
    probs = _suite(30, 4)
    ref = jpool.solve_lp_pool(probs, workers=4, **POOL_KW)
    return probs, ref


@pytest.mark.parametrize("workers", [1, 4])
def test_pool_matches_reference(pool4, workers):
    probs, ref = pool4
    out = host_pool.solve_lp_pool(probs, workers=workers, **DEV, **POOL_KW)
    for r, p in zip(ref, out):
        assert int(p.status) == int(r.status) == 1
        assert int(p.admm_iters) == int(r.admm_iters)
        assert abs(float(p.pobj) - float(r.pobj)) <= 1e-6 * abs(
            float(r.pobj))


def test_pool_workers_bit_for_bit(pool4):
    probs, _ = pool4
    one = host_pool.solve_lp_pool(probs, workers=1, **DEV, **POOL_KW)
    four = host_pool.solve_lp_pool(probs, workers=4, **DEV, **POOL_KW)
    for a, b in zip(one, four):
        for name in ("x", "y", "s", "status", "admm_iters", "ipm_iters",
                     "pobj", "dobj"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_pool_map_order_and_errors():
    assert host_pool.pool_map(lambda v: v * v, range(7), workers=3) == [
        v * v for v in range(7)]

    def boom(v):
        raise RuntimeError(f"item {v}")

    with pytest.raises(RuntimeError, match="item"):
        host_pool.pool_map(boom, [1, 2], workers=2)
