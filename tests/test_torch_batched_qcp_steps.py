"""The rest of the batched conic driver: `abip_tpu_torch.solve_qcp_batch`
with the steps engine, the f64 and full-Q batches, k_cap, straggler
compaction and the steps endgame, `solve_qcp_device` and `host_polish`,
against `abip_tpu.parallel.batched_qcp` on numpy-seeded `randcone`
batches (the `BATCHES` of `tests/test_torch_batched_qcp.py`: Woodbury
form at m=7, primal at m=8).

Tolerances.  The f64 steps engine runs the same f64 recurrence in both
packages: statuses, IPM and ADMM counts are equal, objectives agree to
1e-9 and x, y, s to 1e-7 of their scale.  Mixed precision (and every
sprint2 path, whose phase 1 is f32) reduces in f32 in other orders:
statuses and IPM counts are equal, ADMM counts within max(2 * probe, 5%)
and objectives within 1e-6 relative, the bars of
`tests/test_torch_batched_qcp.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import ConeSpec as JSpec  # noqa: E402
from abip_tpu.parallel import batched_qcp as jbq  # noqa: E402
from abip_tpu.qcp import solve_qcp as jsolve_qcp  # noqa: E402
from abip_tpu_torch import ConeSpec, solve_qcp, solve_qcp_batch  # noqa: E402
from abip_tpu_torch.parallel import batched_qcp as bq  # noqa: E402
from benchmarks import conic_mini  # noqa: E402
from test_host_polish import _tiny_lasso_embed  # noqa: E402
from test_torch_batched_qcp import BATCHES, KW, PROBE, _batch  # noqa: E402

CPU = dict(device="cpu")
STEPS = dict(engine="steps", eps=1e-6, normalize=True, rho_y=1e-3,
             max_admm=1_000_000)
CASES = {
    "f64-chunk-woodbury": ("woodbury", dict(STEPS, precision="f64",
                                            cadence="chunk",
                                            inner_crit_period=8)),
    "f64-chunk-primal": ("primal", dict(STEPS, precision="f64",
                                        cadence="chunk",
                                        inner_crit_period=8)),
    "f64-cond-woodbury": ("woodbury", dict(STEPS, precision="f64",
                                           cadence="cond",
                                           inner_check_period=50)),
    "f64-cond-primal": ("primal", dict(STEPS, precision="f64",
                                       cadence="cond",
                                       inner_check_period=50)),
    "mixed-chunk-woodbury": ("woodbury", dict(STEPS, precision="mixed",
                                              solver="inverse",
                                              cadence="chunk",
                                              inner_crit_period=8)),
    "mixed-cond-primal": ("primal", dict(STEPS, precision="mixed",
                                         solver="inverse", cadence="cond",
                                         inner_crit_period=4)),
}


def _ref(stacks, spec, Q=None, **kw):
    args = [jnp.asarray(x) for x in stacks]
    return jbq.solve_qcp_batch(*args, None if Q is None else jnp.asarray(Q),
                               cones=JSpec(**spec), **kw)


def _port(stacks, spec, Q=None, **kw):
    return solve_qcp_batch(*stacks, Q, cones=ConeSpec(**spec), **CPU, **kw)


def assert_exact(port, ref):
    """The f64 bar: equal decisions, objectives to 1e-9, iterates to
    1e-7 of scale."""
    for f in ("status", "ipm_iters", "admm_iters"):
        assert getattr(port, f).tolist() == np.asarray(
            getattr(ref, f)).tolist(), f
    np.testing.assert_allclose(port.pobj.numpy(), np.asarray(ref.pobj),
                               rtol=1e-9, atol=1e-9)
    for f in ("x", "y", "s"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(port, f).numpy(), r, rtol=0,
                                   atol=1e-7 * max(1.0, np.abs(r).max()),
                                   err_msg=f)


def assert_close(port, ref, probe=PROBE):
    """The f32 bar: equal statuses and IPM counts, ADMM counts within
    max(2 * probe, 5%), objectives within 1e-6 relative."""
    assert port.status.tolist() == np.asarray(ref.status).tolist()
    assert port.ipm_iters.tolist() == np.asarray(ref.ipm_iters).tolist()
    kp, kr = port.admm_iters.numpy(), np.asarray(ref.admm_iters)
    assert (np.abs(kp - kr) <= np.maximum(2 * probe, 0.05 * kr)).all(), (
        kp, kr)
    pr = np.asarray(ref.pobj)
    np.testing.assert_allclose(port.pobj.numpy(), pr, rtol=1e-6,
                               atol=1e-6 * max(1.0, np.abs(pr).max()))


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request):
    form, kw = CASES[request.param]
    spec, stacks, stars = _batch(form, 3)
    return (request.param, kw, stacks, stars, _port(stacks, spec, **kw),
            _ref(stacks, spec, **kw))


def test_steps_engine_matches_reference(steps):
    name, kw, _, stars, port, ref = steps
    assert port.status.tolist() == [1, 1, 1]
    if kw["precision"] == "f64":
        assert_exact(port, ref)
    else:
        assert_close(port, ref, probe=8)
    assert np.abs(port.pobj.numpy() - stars).max() < 2e-5


def test_steps_lane_equals_one_lane_solve(steps):
    """Masks freeze the other lanes without touching a lane: lane 1 of
    the batch ends where a one-lane solve ends, in both cadences (the
    host's reads decide when the cond cadence checks)."""
    name, kw, stacks, _, whole, _ = steps
    spec = BATCHES[CASES[name][0]][0]
    one = _port(tuple(x[1:2] for x in stacks), spec, **kw)
    for f in ("status", "ipm_iters", "admm_iters"):
        assert getattr(one, f)[0].item() == getattr(whole, f)[1].item(), f
    np.testing.assert_allclose(one.x[0].numpy(), whole.x[1].numpy(),
                               rtol=1e-9, atol=1e-10)


def _full_q_batch(B=3, seed=0):
    """`tests/test_qcp_robustness.py:133-160`: m=8, n=20, a full PSD Q."""
    rng = np.random.default_rng(seed)
    m, n = 8, 20
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    M = rng.standard_normal((n, n))
    Q = M @ M.T + 0.5 * np.eye(n)
    c = rng.standard_normal(n)
    stacks = (np.stack([A] * B), np.stack([b * (1 + 0.01 * k)
                                           for k in range(B)]),
              np.stack([c] * B))
    return stacks, np.stack([Q] * B)


OPTIONS = {
    # the sprint2 options the port once refused, each against the
    # reference on the Woodbury batch (full Q on its own batch)
    "engine-steps": dict(KW, engine="steps"),
    "endgame-steps": dict(KW, endgame="steps"),
    "compact-64": dict(KW, compact_period=64),
    "precision-f64": dict(KW, precision="f64"),
    "full-q": dict(KW, engine="steps", inner_crit_period=8, eps=1e-7),
}


@pytest.fixture(scope="module")
def compacted():
    """compact_period=64 at B=5 in both packages; the port's rounds and
    setups recorded on the way."""
    spec, stacks, stars = _batch("woodbury", 5)
    rounds, prepares = [], []
    solve, prepare = bq._solve, bq._prepare

    def spy_solve(*a, **kw):
        if kw.get("k_cap") is not None:
            rounds.append((kw["prepared"].A.shape[0], kw["k_cap"],
                           kw["init_state"][4].tolist()))
        return solve(*a, **kw)

    def spy_prepare(*a, **kw):
        prepares.append(a[0].shape[0])
        return prepare(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bq, "_solve", spy_solve)
        mp.setattr(bq, "_prepare", spy_prepare)
        port = _port(stacks, spec, **OPTIONS["compact-64"])
    ref = _ref(stacks, spec, **OPTIONS["compact-64"])
    return port, ref, stars, rounds, prepares


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_reference(name, request):
    """Each option of `solve_qcp_batch` against the reference: the steps
    engine with the sprint2 knobs, the steps endgame, compaction at B=5
    with compact_period=64 (the first round's bucket of 8 holds three
    duplicated lanes), precision "f64" through the whole sprint2 path,
    and a full (B, n, n) Q (the primal Schur form)."""
    kw = OPTIONS[name]
    if name == "full-q":
        stacks, Q = _full_q_batch()
        spec = dict(nonneg=20)
        port, ref = _port(stacks, spec, Q, **kw), _ref(stacks, spec, Q, **kw)
        assert port.status.tolist() == [1, 1, 1]
        assert_close(port, ref)
        return
    if name == "compact-64":
        port, ref, stars = request.getfixturevalue("compacted")[:3]
    else:
        spec, stacks, stars = _batch("woodbury", 3)
        port, ref = _port(stacks, spec, **kw), _ref(stacks, spec, **kw)
    assert set(port.status.tolist()) == {1}
    assert_close(port, ref)
    assert np.abs(port.pobj.numpy() - stars).max() < 2e-5


def test_compaction_rounds_slice_the_setup(compacted):
    """compact_period=64 at B=5: phase 2 runs in rounds on power-of-two
    buckets of at least 4 lanes (duplicates of active lanes fill them),
    each with one shared scalar cap, the prepared setup sliced to the
    bucket and never recomputed."""
    port, _, _, rounds, prepares = compacted
    assert port.status.tolist() == [1] * 5
    assert prepares == [5]
    assert len(rounds) >= 2
    for nb, cap, ks in rounds:
        assert nb >= 4 and nb & (nb - 1) == 0
        assert isinstance(cap, int) and cap <= max(ks) + 64


def test_defaults_above_b32_compact():
    """Above B=32 the reference's default compacts phase 2 (every 2048
    iterations); since no lane of these needs that many, the rounds end
    where the uncompacted endgame ends, lane for lane."""
    spec, (As, bs, cs), _ = _batch("woodbury", 3)
    rep = tuple(np.concatenate([x] * 11) for x in (As, bs, cs))
    default = _port(rep, spec, **KW)
    plain = _port(rep, spec, **dict(KW, compact_period=0))
    assert default.status.tolist() == [1] * 33
    for f in ("status", "ipm_iters", "admm_iters"):
        assert getattr(default, f).tolist() == getattr(plain, f).tolist()
    np.testing.assert_allclose(default.pobj.numpy(), plain.pobj.numpy(),
                               rtol=1e-12)


def test_kcap_resume_matches_uncapped():
    """`tests/test_resume_caps.py:13-47` on the port: capped rounds of 60
    iterations on a shared scalar cap, each resumed from the last, reach
    the uncapped solve's optimum; the reference's rounds take the same
    counts."""
    cones = dict(soc=(5,), nonneg=10)
    _, A, b, c, _, star = conic_mini.randcone("x", 8, JSpec(**cones),
                                              seed=102)
    stacks = (A[None], b[None], c[None])
    kw = dict(eps=1e-6, precision="mixed", rho_y=1e-3, normalize=True,
              solver="inverse", cadence="chunk", inner_crit_period=64,
              probe_period=8, max_admm=100_000)
    full = _port(stacks, cones, **kw)
    assert full.status.tolist() == [1]

    def rounds(run, resume):
        st, k = None, 0
        for n_rounds in range(1, 51):
            r = run(stacks, cones, init_state=st, k_cap=np.int32(k + 60),
                    **kw)
            k = int(np.asarray(r.admm_iters)[0])
            if int(np.asarray(r.status)[0]) != 0:
                return r, n_rounds
            st = resume(r)
        return r, n_rounds

    port, n_port = rounds(_port, bq._resume)
    ref, n_ref = rounds(_ref, lambda r: (r.u_raw, r.v_raw, r.mu, r.tol_inner,
                                         r.admm_iters, r.ipm_iters,
                                         r.status))
    assert port.status.tolist() == [1] and n_port > 1
    assert abs(float(port.pobj[0]) - star) < 2e-5
    k_full = int(full.admm_iters[0])
    assert abs(int(port.admm_iters[0]) - k_full) <= 0.2 * k_full + 128
    assert n_port == n_ref
    assert_close(port, ref)


def test_solve_qcp_device_matches_reference():
    """One instance at the reference's defaults (cadence "cond", f64,
    inner_crit_period=1), normalized, with a full Q on an SOC cone:
    scalar fields, the reference's counts."""
    (As, bs, cs), Qs = _full_q_batch(1, seed=4)
    spec = dict(soc=(5,), nonneg=15)
    port = bq.solve_qcp_device(As[0], bs[0], cs[0], Qs[0],
                               cones=ConeSpec(**spec), eps=1e-7,
                               normalize=True, **CPU)
    ref = jbq.solve_qcp_device(*(jnp.asarray(x[0]) for x in (As, bs, cs,
                                                              Qs)),
                               cones=JSpec(**spec), eps=1e-7, normalize=True)
    assert port.status.dim() == 0 and tuple(port.x.shape) == (20,)
    assert int(port.status) == int(ref.status) == 1
    assert int(port.ipm_iters) == int(ref.ipm_iters)
    assert int(port.admm_iters) == int(ref.admm_iters)
    assert abs(float(port.pobj) - float(ref.pobj)) <= 1e-9 * max(
        1.0, abs(float(ref.pobj)))
    host = jsolve_qcp(As[0], bs[0], cs[0], JSpec(**spec), Q=Qs[0], eps=1e-7)
    assert abs(float(port.pobj) - host.pobj) <= 1e-5 * (1 + abs(host.pobj))


def _two(name):
    spec, (As, bs, cs), _ = _batch(name, 2)
    return spec, As, bs, cs


REFUSALS = {
    "period": (dict(engine="steps", anchor_period=0), "must be >= 1"),
    "cadence": (dict(engine="steps", cadence="every"), "cadence must be"),
    "engine": (dict(engine="warp"), "engine must be"),
    "precision": (dict(engine="steps", precision="f16"), "precision must"),
    "delta-cadence": (dict(engine="delta", cadence="cond"),
                      "requires cadence='chunk'"),
    "ladder-mu-stop": (dict(engine="ladder"), "phase-1 style"),
    "sprint-cadence": (dict(engine="sprint", cadence="cond", mu_stop=1e-3),
                       "requires cadence='chunk'"),
    "woodbury-m-ge-n": (dict(engine="steps", form="woodbury", square=True),
                        "requires m < n"),
    "woodbury-full-q": (dict(engine="steps", form="woodbury", full_q=True),
                        "diagonal \\(or no\\) Q"),
    "ladder-full-q": (dict(engine="ladder", mu_stop=1e-3, full_q=True),
                      "supports diagonal"),
    "normalize-and-scaling": (dict(engine="steps", normalize=True,
                                   scaling=True), "either normalize"),
    "prepared-normalize": (dict(engine="steps", normalize=True,
                                prepared=True), "prepared already"),
    "prepared-mode": (dict(engine="steps", precision="mixed", prepared=True),
                      "prepared factors were built"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_option_refusals(name):
    """The reference's ValueErrors (`batched_qcp.py:112-255`), raised
    before any work."""
    kw, match = REFUSALS[name]
    kw = dict(kw)
    spec, As, bs, cs = _two("woodbury")
    Q = None
    if kw.pop("square", False):
        As = As[:, :, :As.shape[1]]
        cs = cs[:, :As.shape[1]]
        spec = dict(nonneg=As.shape[1])
    if kw.pop("full_q", False):
        Q = np.stack([np.eye(As.shape[2])] * 2)
    if kw.pop("scaling", False):
        kw["scaling"] = tuple(torch.ones(2) for _ in range(6))
    if kw.pop("prepared", False):
        kw["prepared"] = bq.prepare_conic_batch(
            *(torch.from_numpy(x) for x in (As, bs, cs)),
            cones=ConeSpec(**spec), precision="f64")
    with pytest.raises(ValueError, match=match):
        solve_qcp_batch(As, bs, cs, Q, cones=ConeSpec(**spec), **CPU, **kw)


def test_solve_qcp_device_refusals():
    spec, As, bs, cs = _two("woodbury")
    with pytest.raises(ValueError, match="must be >= 1"):
        bq.solve_qcp_device(As[0], bs[0], cs[0], cones=ConeSpec(**spec),
                            inner_crit_period=0, **CPU)
    with pytest.raises(ValueError, match="cadence must be"):
        bq.solve_qcp_device(As[0], bs[0], cs[0], cones=ConeSpec(**spec),
                            cadence="sometimes", **CPU)


@pytest.fixture(scope="module")
def polished():
    """The tiny LASSO embedding of `tests/test_host_polish.py`, stopped
    by k_cap=40 in both packages (the f64 steps engine: equal state),
    then polished by each package's host driver."""
    A, b, c, jcones = _tiny_lasso_embed()
    cones = ConeSpec(rsoc=tuple(jcones.rsoc), nonneg=jcones.nonneg)
    kw = dict(engine="steps", eps=1e-6, rho_y=1e-3, normalize=True,
              k_cap=np.int32(40))
    port = solve_qcp_batch(A[None], b[None], c[None], cones=cones, **CPU,
                           **kw)
    ref = jbq.solve_qcp_batch(A[None], b[None], c[None], cones=jcones, **kw)
    sp = bq.host_polish(A, b, c, cones, port, lane=0, eps=1e-6, **CPU)
    sr = jbq.host_polish(A, b, c, jcones, ref, lane=0, eps=1e-6)
    return (A, b, c, cones), port, ref, sp, sr


@pytest.mark.parametrize("entry", ["solve_qcp_het_batch", "host_polish"])
def test_entry_point_matches_reference(entry, request):
    """The two entry points the port once refused: a two-lane
    heterogeneous batch (different cones and shapes) and the f64 polish
    of a k_cap-stopped lane, each against the reference."""
    if entry == "host_polish":
        _, port, ref, sp, sr = request.getfixturevalue("polished")
        assert port.status.tolist() == [0]
        assert port.admm_iters.tolist() == np.asarray(
            ref.admm_iters).tolist() == [40]
        assert sp.status_name == sr.status_name == "Solved"
        assert (sp.ipm_iters, sp.admm_iters) == (sr.ipm_iters, sr.admm_iters)
        assert abs(sp.pobj - sr.pobj) <= 1e-6 * max(1.0, abs(sr.pobj))
        return
    spec_w, As_w, bs_w, cs_w = _two("woodbury")
    spec_p, As_p, bs_p, cs_p = _two("primal")
    jp = [(As_w[0], bs_w[0], cs_w[0], None, JSpec(**spec_w)),
          (As_p[0], bs_p[0], cs_p[0], None, JSpec(**spec_p))]
    pp = [(A, b, c, None, ConeSpec(**s)) for (A, b, c, _, _), s in
          zip(jp, (spec_w, spec_p))]
    kw = dict(eps=1e-6, rho_y=1e-3, route="batch", inner_crit_period=8)
    port = bq.solve_qcp_het_batch(pp, **kw, **CPU)
    ref = jbq.solve_qcp_het_batch(jp, **kw)
    assert port.status.tolist() == [1, 1]
    assert_exact(port, ref)


def test_host_polish_finishes_on_its_device(polished):
    """`tests/test_host_polish.py`: the polish of a capped lane is
    Solved, certified, at the uncapped optimum; overrides reach its
    settings."""
    (A, b, c, cones), port, _, sol, _ = polished
    full = solve_qcp(A, b, c, cones, eps=1e-6, **CPU)
    assert sol.status_name == "Solved"
    assert sol.res_pri < 1e-6 and sol.res_dual < 1e-6 and sol.rel_gap < 1e-6
    assert sol.pobj == pytest.approx(full.pobj, rel=1e-4, abs=1e-6)
    loose = bq.host_polish(A, b, c, cones, port, lane=0, eps=1e-4,
                           max_ipm_iters=200, **CPU)
    assert loose.status_name == "Solved" and loose.res_pri < 1e-4


def test_prepared_conic_takes_lanes():
    """`PreparedConic.take` slices every per-lane tensor, the Schur
    solver's included, with repeats: the compaction rounds' view of
    `jax.tree.map(lambda a: a[idx], prep)`."""
    spec, stacks, _ = _batch("primal", 3)
    P = bq.prepare_conic_batch(*(torch.from_numpy(x) for x in stacks),
                               cones=ConeSpec(**spec), rho_y=1e-3,
                               precision="f64")
    idx = torch.tensor([2, 0, 2, 1])
    T = P.take(idx)
    assert T.dss.mode == "chol" and T.dss.form == "primal"
    np.testing.assert_array_equal(T.A.numpy(), P.A.numpy()[[2, 0, 2, 1]])
    np.testing.assert_array_equal(T.dss.chol.numpy(),
                                  P.dss.chol.numpy()[[2, 0, 2, 1]])
    w = torch.ones((4, P.A.shape[1]), dtype=torch.float64)
    zx = T.dss.solve(w, torch.ones((4, P.A.shape[2]),
                                   dtype=torch.float64))[1]
    ref = P.dss.solve(w[:3], torch.ones((3, P.A.shape[2]),
                                        dtype=torch.float64))[1]
    np.testing.assert_allclose(zx.numpy(), ref.numpy()[[2, 0, 2, 1]],
                               rtol=1e-14)


@pytest.mark.parametrize("form", ["woodbury", "primal"])
def test_prepared_f64_matches_reference(form):
    """precision "f64" builds the f64 Cholesky factor (mode "chol"), and
    `prepared_from_numpy` carries the reference's across."""
    spec, stacks, _ = _batch(form, 2)
    port = bq.prepare_conic_batch(*(torch.from_numpy(x) for x in stacks),
                                  cones=ConeSpec(**spec), rho_y=1e-3)
    ref = jax.device_get(jbq.prepare_conic_batch(
        *(jnp.asarray(x) for x in stacks), cones=JSpec(**spec), rho_y=1e-3))
    conv = bq.prepared_from_numpy(ref)
    assert port.dss.mode == conv.dss.mode == "chol"
    assert port.dss.form == conv.dss.form == form
    fac = "cholG" if form == "woodbury" else "chol"
    np.testing.assert_allclose(getattr(port.dss, fac).numpy(),
                               np.asarray(getattr(ref.dss, fac)),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(getattr(conv.dss, fac).numpy(),
                                  np.asarray(getattr(ref.dss, fac)))
    np.testing.assert_allclose(port.r_vec.numpy(), np.asarray(ref.r_vec),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_ieee_f32_under_either_tf32_api(api):
    """`device.ieee_f32`, which the mixed engine's f32 products run in,
    holds TF32 off whichever API the caller enabled it with (a read of
    the legacy flag raises once the other was used) and restores it."""
    from abip_tpu_torch.device import ieee_f32

    matmul = torch.backends.cuda.matmul
    try:
        if api == "legacy":
            matmul.allow_tf32 = True
        else:
            matmul.fp32_precision = "tf32"
        with ieee_f32():
            assert matmul.fp32_precision == "ieee"
            assert matmul.allow_tf32 is False
        assert matmul.fp32_precision == "tf32"
        if api == "legacy":
            assert matmul.allow_tf32 is True
        spec, stacks, stars = _batch("woodbury", 2)
        res = _port(stacks, spec, **CASES["mixed-chunk-woodbury"][1])
        assert res.status.tolist() == [1, 1]
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.allow_tf32 = False
        matmul.fp32_precision = "none"
