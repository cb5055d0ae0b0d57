"""The conic slice as a whole: `abip_tpu_torch.solve_qcp_batch` against
`abip_tpu.parallel.batched_qcp.solve_qcp_batch`, engine "sprint2"
(ladder phase 1, anchored-delta endgame), on numpy-seeded `randcone`
batches with known optima, in both Schur forms.

Both sides run their f32 iterations with reductions in other orders.
Statuses and IPM counts must be equal; ADMM counts agree within
max(2 * probe, 5%); objectives within 1e-6 relative of the reference's
and 2e-5 of the known optimum.  The f32 criterion of a slow stage can
hover at its threshold for several chunks, and then the two versions
may cross it a chunk apart (ROADMAP.md queue 3); the batches below are
ones where they do not.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from abip_tpu import ConeSpec as JSpec  # noqa: E402
from abip_tpu.parallel import batched_qcp as jbq  # noqa: E402
from abip_tpu_torch import ConeSpec, solve_qcp_batch  # noqa: E402
from abip_tpu_torch.parallel import batched_qcp as bq  # noqa: E402
from benchmarks import conic_mini  # noqa: E402

PROBE = 8
KW = dict(engine="sprint2", eps=1e-6, precision="mixed", normalize=True,
          rho_y=1e-3, max_admm=1_000_000, solver="inverse",
          inner_crit_period=512, probe_period=PROBE)
BATCHES = {
    # m=7 <= n/2: the Woodbury form
    "woodbury": (dict(soc=(5,), rsoc=(4,), nonneg=10), 7, 308),
    # m=8 > n/2: the primal form
    "primal": (dict(soc=(5,), nonneg=10), 8, 100),
}


def _batch(name, count=4):
    spec, m, seed0 = BATCHES[name]
    data = [conic_mini.randcone("x", m, JSpec(**spec), seed=seed0 + i)
            for i in range(count)]
    As, bs, cs = (np.stack([d[k] for d in data]) for k in (1, 2, 3))
    return spec, (As, bs, cs), np.asarray([d[5] for d in data])


@pytest.fixture(scope="module", params=sorted(BATCHES))
def solved(request):
    """Both packages' solves of one batch (one reference compile each)."""
    spec, stacks, stars = _batch(request.param)
    port = solve_qcp_batch(*stacks, device="cpu", cones=ConeSpec(**spec),
                           **KW)
    ref = jbq.solve_qcp_batch(*(jnp.asarray(x) for x in stacks),
                              cones=JSpec(**spec), **KW)
    return request.param, stacks, stars, port, ref


def test_batch_matches_reference(solved):
    name, stacks, stars, port, ref = solved
    prep = bq.prepare_conic_batch(*(torch.from_numpy(x) for x in stacks),
                                  cones=ConeSpec(**BATCHES[name][0]),
                                  rho_y=1e-3)
    assert prep.dss.form == name
    status = np.asarray(ref.status)
    assert port.status.tolist() == status.tolist() == [1] * 4
    assert port.ipm_iters.tolist() == np.asarray(ref.ipm_iters).tolist()
    kp, kr = port.admm_iters.numpy(), np.asarray(ref.admm_iters)
    assert (np.abs(kp - kr) <= np.maximum(2 * PROBE, 0.05 * kr)).all(), (
        kp, kr)
    pr = np.asarray(ref.pobj)
    np.testing.assert_allclose(port.pobj.numpy(), pr, rtol=1e-6)
    assert np.abs(port.pobj.numpy() - stars).max() < 2e-5
    assert np.abs(pr - stars).max() < 2e-5


def test_solution_satisfies_the_constraints(solved):
    """x in K with Ax = b, from the unscaled solution."""
    name, (As, bs, _), _, port, _ = solved
    x = port.x.numpy()
    r = np.einsum("bmn,bn->bm", As, x) - bs
    assert np.abs(r).max() < 1e-4 * (1 + np.abs(bs).max())
    nn = BATCHES[name][0]["nonneg"]
    assert (x[:, -nn:] > -1e-6).all()
    assert (x[:, 0] >= np.linalg.norm(x[:, 1:5], axis=1) - 1e-6).all()


def test_lane_equals_one_lane_solve():
    """A lane of the batch ends where a one-lane solve of its instance
    ends: masks freeze the other lanes without touching it."""
    spec, stacks, _ = _batch("woodbury")
    cones = ConeSpec(**spec)
    whole = solve_qcp_batch(*stacks, device="cpu", cones=cones, **KW)
    one = solve_qcp_batch(*(x[1:2] for x in stacks), device="cpu",
                          cones=cones, **KW)
    for f in ("status", "ipm_iters", "admm_iters"):
        assert getattr(one, f)[0].item() == getattr(whole, f)[1].item(), f
    np.testing.assert_allclose(one.x[0].numpy(), whole.x[1].numpy(),
                               rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("case,status", [("infeasible", -2),
                                         ("unbounded", -1)])
def test_certificates(case, status):
    """`tests/test_conic_ladder.py:65-83`: x >= 0 with x = -1 is
    infeasible; min -x1 s.t. x1 - x2 = 0 is unbounded."""
    if case == "infeasible":
        A, b, c = [[1.0, 0.0]], [-1.0], [1.0, 0.0]
    else:
        A, b, c = [[1.0, -1.0]], [0.0], [-1.0, 0.0]
    r = solve_qcp_batch(np.asarray([A]), np.asarray([b]), np.asarray([c]),
                        device="cpu", cones=ConeSpec.lp(2), **dict(
                            KW, eps=1e-5, inner_crit_period=64))
    assert r.status.tolist() == [status]


def test_cold_delta_start_is_refused():
    """The delta endgame lacks the k=0 tau_t := 1 case: a cold start
    raises (`tests/test_conic_ladder.py:85-94`)."""
    spec, stacks, _ = _batch("woodbury", 2)
    with pytest.raises(ValueError, match="endgame"):
        solve_qcp_batch(*stacks, device="cpu", cones=ConeSpec(**spec),
                        engine="delta",
                        eps=1e-4, cadence="chunk", precision="mixed")


def test_importing_the_port_leaves_jax_out():
    """`abip_tpu_torch` and its conic modules import neither JAX nor the
    JAX package."""
    code = ("import sys, abip_tpu_torch, abip_tpu_torch.cones, "
            "abip_tpu_torch.conic_ops, abip_tpu_torch.qcp, "
            "abip_tpu_torch.scaling, abip_tpu_torch.linsys.schur, "
            "abip_tpu_torch.ops.conic_dr, abip_tpu_torch.ops.conic_delta, "
            "abip_tpu_torch.ops.build, abip_tpu_torch.parallel.batched_qcp, "
            "abip_tpu_torch.ops.admm_sprint, abip_tpu_torch.ops.prox, "
            "abip_tpu_torch.parallel.batched, abip_tpu_torch.parallel, "
            "abip_tpu_torch.problems, abip_tpu_torch.problems.lasso, "
            "abip_tpu_torch.problems.svm; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('abip_tpu.') or "
            "m == 'abip_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("seed", [8000, 8007, 8015])
def test_jax_free_generator_is_bit_identical(seed):
    """`chip_smoke.randcone` (on the port's ConeSpec, no JAX) draws the
    same arrays as `benchmarks.conic_mini.randcone` at the dim-1020
    spec; `randqcp_diag` the same as `randqcp(q_rank="diag")`."""
    spec = chip_smoke.CONIC_SPEC
    ref = conic_mini.randcone("x", chip_smoke.CONIC_M, JSpec(**spec), seed)
    port = chip_smoke.randcone("x", chip_smoke.CONIC_M, ConeSpec(**spec),
                               seed)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(port[k], ref[k])
    assert port[5] == ref[5]
    small = chip_smoke.SMALL_SPEC
    ref = conic_mini.randqcp("q", 12, JSpec(**small), seed, q_rank="diag")
    port = chip_smoke.randqcp_diag("q", 12, ConeSpec(**small), seed)
    for k in (1, 2, 3, 4):
        np.testing.assert_array_equal(port[k], ref[k])
    assert port[6] == ref[6]
