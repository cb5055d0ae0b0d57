"""`abip_tpu_torch.schedules` and the host utilities against the JAX
package's: the schedules are a copy and must return the same values on
the same host floats; checkpoints written by either package load in the
other; the phase timers synchronize through the hook they are given."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import schedules as jsched  # noqa: E402
from abip_tpu.settings import Settings as JSettings  # noqa: E402
from abip_tpu.utils.checkpoint import SolverCheckpoint as JCheckpoint  # noqa: E402
from abip_tpu_torch import schedules  # noqa: E402
from abip_tpu_torch.settings import Settings  # noqa: E402
from abip_tpu_torch.utils import IterationLog, PhaseTimers  # noqa: E402
from abip_tpu_torch.utils.checkpoint import SolverCheckpoint  # noqa: E402

RESIDUALS = [
    dict(res_pri=5e-7, res_dual=5e-7, rel_gap=5e-7, res_infeas=np.nan,
         res_unbdd=np.nan),
    dict(res_pri=5e-7, res_dual=2e-6, rel_gap=5e-7, res_infeas=5e-7,
         res_unbdd=np.nan),
    dict(res_pri=1e-3, res_dual=1e-3, rel_gap=1e-3, res_infeas=np.nan,
         res_unbdd=5e-7),
    dict(res_pri=8e-6, res_dual=2e-6, rel_gap=4e-6, res_infeas=np.nan,
         res_unbdd=np.nan),
    dict(res_pri=3.5e-6, res_dual=1e-7, rel_gap=1e-7, res_infeas=np.nan,
         res_unbdd=np.nan),
]
OPTIONS = [dict(), dict(pfeasopt=True), dict(hybrid_mu=False,
                                             dynamic_sigma=0.0),
           dict(dynamic_sigma_second=0.0), dict(hybrid_mu=False,
                                                dynamic_sigma=0.3)]


def _pair(opts):
    return JSettings(eps=1e-6, **opts), Settings(eps=1e-6, **opts)


@pytest.mark.parametrize("opts", OPTIONS)
def test_check_converged_matches_reference(opts):
    js, ps = _pair(opts)
    for res, ipm, admm in itertools.product(RESIDUALS, (0, 3), (0, 10)):
        assert schedules.check_converged(res, ps, ipm, admm) == \
            jsched.check_converged(res, js, ipm, admm)


@pytest.mark.parametrize("opts", OPTIONS)
def test_update_mu_matches_reference(opts):
    """Every branch of the hybrid dispatch, the tabulated schedule (dense
    and sparse) and the LOQO rule, with the same host floats."""
    js, ps = _pair(opts)
    rng = np.random.default_rng(0)
    m = 4
    u = np.concatenate([rng.standard_normal(m), rng.random(9) + 0.1])
    v = np.concatenate([np.zeros(m), rng.random(9) + 0.1])
    for mu, sp, res, fc, dc, ds in itertools.product(
            (1.0, 3e-3, 5e-4, 8e-7), (0.05, 0.15, 0.5), RESIDUALS,
            (False, True), (False, True), (ps.dynamic_sigma, 0.5)):
        args = (mu, 0.8, 3.0, res)
        tail = (sp, fc, dc, ds)
        assert schedules.update_mu(*args, ps, *tail, u=u, v=v, m=m) == \
            jsched.update_mu(*args, js, *tail, u=u, v=v, m=m)


def test_loqo_degrades_on_nonpositive_products():
    u = np.array([0.0, 1.0, -1.0])
    v = np.array([0.0, 1.0, 1.0])
    assert schedules.update_mu_loqo(0.1, u, v, 1, 0.5) == \
        jsched.update_mu_loqo(0.1, u, v, 1, 0.5) == pytest.approx(0.05)


def test_checkpoints_cross_load(tmp_path):
    rng = np.random.default_rng(1)
    ck = SolverCheckpoint(u=rng.random(7), v=rng.random(7), mu=1e-3,
                          beta=0.7, sigma=0.8, gamma=2.0, admm_iters=123,
                          ipm_iters=5, final_check=True)
    ck.save(str(tmp_path / "port"))
    back = JCheckpoint.load(str(tmp_path / "port"))
    JCheckpoint(**{f.name: getattr(back, f.name)
                   for f in dataclasses.fields(back)}).save(
        str(tmp_path / "ref.npz"))
    again = SolverCheckpoint.load(str(tmp_path / "ref.npz"))
    for f in dataclasses.fields(ck):
        np.testing.assert_array_equal(getattr(again, f.name),
                                      getattr(ck, f.name))


def test_phase_timers_sync_and_log(capsys):
    calls = []
    timers = PhaseTimers(sync=lambda: calls.append(1))
    with timers.phase("inner_admm"):
        pass
    with timers.phase("inner_admm"):
        pass
    assert calls == [1, 1] and timers.counts["inner_admm"] == 2
    log = IterationLog(enabled=True)
    log.row(0, 10, 1.0, dict(res_pri=1e-2, res_dual=1e-2, rel_gap=1e-2,
                            tau=1.0), -1.0, -1.0)
    log.footer("Solved", {"pobj": -1.0, "ipm_iters": 1}, timers)
    out = capsys.readouterr().out
    assert "Status: Solved" in out and "inner_admm" in out


def test_profiling_hooks_write_a_trace(tmp_path):
    """`trace_solve` writes a Chrome trace holding the ranges `annotate`
    names."""
    import json

    from abip_tpu_torch.utils import annotate, trace_solve

    with trace_solve(str(tmp_path)):
        with annotate("abip_range"):
            torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "abip_range" in names
