"""The engines this slice ports, as whole solves, against the JAX
package: the LP steps engine (f64 and mixed; cadence "cond" and
"chunk"; solver "cholesky" and "inverse"), the sprint engine (cadence
"cond" through the plain sprint K7, "chunk" through the stopping sprint
K6), sprint2 with either endgame, the mu_stop / init_state resume, the
compacted phase 2 above B=32, and the conic `phase1="sprint"` (K4).

LP instances are `tests/conftest.random_lp` at the shapes of
`tests/test_ops.py:124-389`; conic batches are those of
`tests/test_torch_batched_qcp.py`.  Statuses and IPM counts must be
equal and objectives within 1e-6 relative; f64 ADMM counts must be
equal, mixed and f32 ones within max(2 * probe, 5%).  The reference's
f32 kernels run as their XLA versions here (its CPU default).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import ConeSpec as JSpec  # noqa: E402
from abip_tpu.parallel import batched as jbatched  # noqa: E402
from abip_tpu.parallel import batched_qcp as jbq  # noqa: E402
from abip_tpu_torch import ConeSpec, solve_qcp_batch  # noqa: E402
from abip_tpu_torch.ops import admm_sprint, conic_dr  # noqa: E402
from abip_tpu_torch.parallel import batched  # noqa: E402
from conftest import random_lp  # noqa: E402
from test_torch_batched_qcp import BATCHES, _batch  # noqa: E402

DEV = dict(device="cpu")
PROBE = 8
CONFIGS = {
    "steps-f64-chunk": dict(eps=1e-6),
    "steps-f64-cond": dict(eps=1e-6, cadence="cond"),
    "steps-mixed-chunk-cholesky": dict(eps=1e-6, precision="mixed",
                                       qres_period=64),
    "steps-mixed-cond-inverse": dict(eps=1e-6, precision="mixed",
                                     solver="inverse", cadence="cond",
                                     qres_period=8),
    "sprint-cond": dict(eps=1e-6, precision="mixed", engine="sprint",
                        sprint_T=16, cadence="cond"),
    "sprint-chunk": dict(eps=1e-6, precision="mixed", engine="sprint",
                         solver="inverse", qres_period=64),
    "sprint2-steps": dict(eps=1e-6, precision="mixed", solver="inverse",
                          engine="sprint2", qres_period=256,
                          probe_period=PROBE),
    "sprint2-delta": dict(eps=1e-6, precision="mixed", solver="inverse",
                          engine="sprint2", endgame="delta",
                          qres_period=256, probe_period=PROBE,
                          sprint_T=32, sprint_mu_switch=1e-4),
}


def _lps(seed0, count=3, m=20, n=60):
    probs = [random_lp(np.random.default_rng(seed0 + i), m, n)
             for i in range(count)]
    return tuple(np.stack(x) for x in zip(*probs))


def _assert_matches(port, ref, exact_counts):
    status = np.asarray(ref.status)
    assert port.status.tolist() == status.tolist()
    assert port.ipm_iters.tolist() == np.asarray(ref.ipm_iters).tolist()
    kp, kr = port.admm_iters.numpy(), np.asarray(ref.admm_iters)
    if exact_counts:
        assert kp.tolist() == kr.tolist()
    else:
        assert (np.abs(kp - kr) <= np.maximum(2 * PROBE, 0.05 * kr)).all(), (
            kp, kr)
    solved = status == 1
    np.testing.assert_allclose(port.pobj.numpy()[solved],
                               np.asarray(ref.pobj)[solved], rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lp_engine_matches_reference(name):
    kw = CONFIGS[name]
    stacks = _lps(200 if name.startswith("sprint2") else 100)
    port = batched.solve_lp_batch(*stacks, **DEV, **kw)
    ref = jbatched.solve_lp_batch(*(jnp.asarray(x) for x in stacks), **kw)
    assert port.status.tolist() == [1, 1, 1]
    _assert_matches(port, ref, kw.get("precision", "f64") == "f64")


def test_sprint_paths_launch_their_plain_kernels(monkeypatch):
    """The sprint engine reaches K7 under cadence "cond" and K6 under
    "chunk"; on CPU tensors through their plain version."""
    calls = []
    plain = admm_sprint._sprint_compute

    def spy(op, t_max, probe):
        calls.append(probe)
        return plain(op, t_max, probe)

    monkeypatch.setattr(admm_sprint, "_sprint_compute", spy)
    stacks = _lps(100, count=1)
    batched.solve_lp_batch(*stacks, **DEV, **CONFIGS["sprint-cond"])
    assert calls and set(calls) == {0}
    calls.clear()
    batched.solve_lp_batch(*stacks, **DEV, **CONFIGS["sprint-chunk"])
    assert calls and set(calls) == {PROBE}


def test_mu_stop_and_init_state_resume():
    """`tests/test_ops.py:366-389`: mu_stop exits at the phase boundary
    with status 0; the 6-tuple resume finishes the solve; a capped run
    (k_cap) resumed mid-stage from the 9-tuple ends where the
    reference's does."""
    A, b, c = random_lp(np.random.default_rng(11), 15, 45)
    kw = dict(eps=1e-6, precision="mixed", solver="inverse",
              qres_period=64, probe_period=PROBE, cadence="chunk")
    As, bs, cs = A[None], b[None], c[None]
    jA, jb, jc = jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)
    r1 = batched.device_solve_lp(*(torch.as_tensor(x) for x in (As, bs, cs)),
                                 mu_stop=1e-3, **kw)
    q1 = jbatched.device_solve_lp(jA, jb, jc, mu_stop=1e-3, **kw)
    assert int(r1.status[0]) == int(q1.status) == 0
    assert float(r1.mu[0]) < 1e-3 and int(r1.admm_iters[0]) > 0
    assert int(r1.admm_iters[0]) == int(q1.admm_iters)
    r2 = batched.device_solve_lp(
        *(torch.as_tensor(x) for x in (As, bs, cs)),
        init_state=(r1.u_raw, r1.v_raw, r1.mu, r1.admm_iters, r1.ipm_iters,
                    r1.status), **kw)
    q2 = jbatched.device_solve_lp(
        jA, jb, jc, init_state=(q1.u_raw, q1.v_raw, q1.mu, q1.admm_iters,
                                q1.ipm_iters, q1.status), **kw)
    assert int(r2.status[0]) == int(q2.status) == 1
    assert int(r2.admm_iters[0]) > int(r1.admm_iters[0])
    _assert_matches(r2, jbatched.DeviceSolveResult(
        *[None if x is None else x[None] for x in q2]), False)
    capped = batched.device_solve_lp(
        *(torch.as_tensor(x) for x in (As, bs, cs)), k_cap=64, **kw)
    qcap = jbatched.device_solve_lp(jA, jb, jc, k_cap=64, **kw)
    assert int(capped.status[0]) == int(qcap.status) == 0
    assert int(capped.admm_iters[0]) == int(qcap.admm_iters) == 64
    state = (capped.u_raw, capped.v_raw, capped.mu, capped.admm_iters,
             capped.ipm_iters, capped.status, capped.u_sum_raw,
             capped.v_sum_raw, capped.sj)
    r3 = batched.device_solve_lp(*(torch.as_tensor(x) for x in (As, bs, cs)),
                                 init_state=state, **kw)
    q3 = jbatched.device_solve_lp(
        jA, jb, jc, init_state=(qcap.u_raw, qcap.v_raw, qcap.mu,
                                qcap.admm_iters, qcap.ipm_iters, qcap.status,
                                qcap.u_sum_raw, qcap.v_sum_raw, qcap.sj),
        **kw)
    _assert_matches(r3, jbatched.DeviceSolveResult(
        *[None if x is None else x[None] for x in q3]), False)


def test_compacted_phase2_matches_whole_batch():
    """B=33 with tile=0 runs phase 2 in compacted rounds; with the
    default round length every lane ends exactly as in whole-batch runs
    of the same lanes (B <= 32); with 64-iteration rounds (lanes resumed
    mid-stage from the 9-tuple) statuses agree and objectives to 1e-6.
    A max_ipm cap ends every lane instead of looping."""
    stacks = _lps(500, count=33, m=8, n=24)
    kw = dict(eps=1e-6, precision="mixed", solver="inverse",
              engine="sprint2", qres_period=64, probe_period=PROBE)
    whole = [batched.solve_lp_batch(*(x[s] for x in stacks), tile=0, **DEV,
                                    **kw) for s in (slice(0, 16),
                                                    slice(16, 33))]
    whole = batched.DeviceSolveResult(*[torch.cat(f) for f in zip(*whole)])
    comp = batched.solve_lp_batch(*stacks, tile=0, **DEV, **kw)
    assert comp.status.tolist() == whole.status.tolist() == [1] * 33
    assert comp.admm_iters.tolist() == whole.admm_iters.tolist()
    np.testing.assert_allclose(comp.pobj.numpy(), whole.pobj.numpy(),
                               rtol=1e-12)
    short = batched.solve_lp_batch(*stacks, tile=0, compact_period=64, **DEV,
                                   **kw)
    assert short.status.tolist() == [1] * 33
    np.testing.assert_allclose(short.pobj.numpy(), whole.pobj.numpy(),
                               rtol=1e-6)
    capped = batched.solve_lp_batch(*stacks, tile=0, max_ipm=2, **DEV, **kw)
    assert ((capped.status == 0) | (capped.status == 1)).all()
    assert ((capped.ipm_iters <= 2) | (capped.status == 1)).all()


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_conic_phase1_sprint_matches_reference(name):
    """sprint2 with phase1="sprint" on the batches of
    `tests/test_torch_batched_qcp.py`, through the plain K4."""
    kw = dict(engine="sprint2", eps=1e-6, precision="mixed", normalize=True,
              rho_y=1e-3, max_admm=1_000_000, solver="inverse",
              inner_crit_period=512, probe_period=PROBE, phase1="sprint")
    spec, stacks, stars = _batch(name)
    before = conic_dr.dr_sprint_cuda.launches
    port = solve_qcp_batch(*stacks, **DEV, cones=ConeSpec(**spec), **kw)
    assert conic_dr.dr_sprint_cuda.launches == before   # CPU: plain version
    ref = jbq.solve_qcp_batch(*(jnp.asarray(x) for x in stacks),
                              cones=JSpec(**spec), **kw)
    assert port.status.tolist() == [1] * 4
    _assert_matches(port, ref, False)
    assert np.abs(port.pobj.numpy() - stars).max() < 2e-5


def test_conic_sprint_engine_runs_phase1_style():
    """engine="sprint" alone needs mu_stop >= sprint_mu_switch, as the
    reference's does; with it the lanes stop at the switch."""
    spec, stacks, _ = _batch("woodbury", 2)
    kw = dict(eps=1e-6, precision="mixed", normalize=True, rho_y=1e-3,
              inner_crit_period=512, probe_period=PROBE)
    with pytest.raises(ValueError, match="phase-1 style"):
        solve_qcp_batch(*stacks, **DEV, cones=ConeSpec(**spec),
                        engine="sprint", **kw)
    r = solve_qcp_batch(*stacks, **DEV, cones=ConeSpec(**spec),
                        engine="sprint", mu_stop=1e-3, **kw)
    assert r.status.tolist() == [0, 0] and (r.mu < 1e-3).all()
