"""`abip_tpu_torch.io`, `dispatch.solve_general` and the CLI against
`abip_tpu` on the committed suites, both on the CPU (the port with
`device="cpu"` / `--cpu`).

The readers (MPS, the native MPS and CBF parsers, CBF, SeDuMi) and the
presolve are copies of the reference's numpy/scipy code: their outputs
must be equal.  Solves through them run the host drivers and are held
to the bar of `tests/test_torch_lp.py` and `tests/test_torch_qcp.py`:
equal status, IPM and ADMM counts, objectives within 1e-8 relative (to
max(1, |obj|): the presolved LPs' dual objectives carry the 1/rho_y
amplification of y), and the CLI's JSON line equal up to those
tolerances and the wall time.
"""
import glob
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import abip_tpu  # noqa: E402
import abip_tpu_torch  # noqa: E402
from abip_tpu import __main__ as jcli  # noqa: E402
from abip_tpu.io import cbf as jcbf  # noqa: E402
from abip_tpu.io import mps as jmps  # noqa: E402
from abip_tpu.io import presolve as jpresolve  # noqa: E402
from abip_tpu.io import sedumi as jsedumi  # noqa: E402
from abip_tpu_torch import __main__ as cli  # noqa: E402
from abip_tpu_torch.cones import ConeSpec  # noqa: E402
from abip_tpu_torch.io import cbf, mps, native, presolve, sedumi  # noqa: E402
from abip_tpu_torch.io.mps_write import write_mps  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
SUITES = os.path.join(REPO, "benchmarks", "suites")
CPU = dict(device="cpu")
OBJ_RTOL = 1e-8


def _suite(name, pattern):
    paths = sorted(glob.glob(os.path.join(SUITES, name, pattern)))
    assert paths, f"committed suite {name} missing"
    return paths


def _assert_solves_equal(ref, port):
    assert port.status_name == ref.status_name
    assert (port.ipm_iters, port.admm_iters) == (ref.ipm_iters,
                                                 ref.admm_iters)
    for name in ("pobj", "dobj"):
        r, p = getattr(ref, name), getattr(port, name)
        assert abs(p - r) <= OBJ_RTOL * max(1.0, abs(r)), (name, p, r)


def _assert_lp_equal(a, b, same_name=True):
    for f in ("c", "row_lo", "row_hi", "lb", "ub"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.A != b.A).nnz == 0 and a.A.shape == b.A.shape
    assert (a.objcon, a.maximize) == (b.objcon, b.maximize)
    assert a.name == b.name or not same_name


@pytest.mark.parametrize("path", _suite("netlib_mini", "*.mps")
                         + _suite("mittelmann_mini", "*.mps*"),
                         ids=os.path.basename)
def test_read_mps_and_presolve_match_reference(path):
    port, ref = mps.read_mps(path), jmps.read_mps(path)
    _assert_lp_equal(port, ref)
    if not path.endswith(".gz"):
        # the native parser names the problem after its file
        _assert_lp_equal(mps.read_mps(path, prefer_native="always"), ref,
                         same_name=False)
    ps, rs = presolve.presolve_to_standard(port), \
        jpresolve.presolve_to_standard(ref)
    assert (ps.A != rs.A).nnz == 0
    np.testing.assert_array_equal(ps.b, rs.b)
    np.testing.assert_array_equal(ps.c, rs.c)
    assert (ps.objcon_shift, ps.sparsity) == (rs.objcon_shift, rs.sparsity)
    x = np.random.default_rng(0).random(ps.A.shape[1])
    np.testing.assert_array_equal(ps.recover(x), rs.recover(x))


@pytest.mark.parametrize("path", _suite("cblib_mini", "*.cbf"),
                         ids=os.path.basename)
def test_read_cbf_matches_reference(path):
    port, ref = cbf.read_cbf(path), jcbf.read_cbf(path)
    np.testing.assert_array_equal(port.A, ref.A)
    np.testing.assert_array_equal(port.b, ref.b)
    np.testing.assert_array_equal(port.c, ref.c)
    assert isinstance(port.cones, ConeSpec)
    assert (port.cones.soc, port.cones.rsoc, port.cones.free,
            port.cones.zero, port.cones.nonneg) == (
        ref.cones.soc, ref.cones.rsoc, ref.cones.free, ref.cones.zero,
        ref.cones.nonneg)
    assert (port.objsense, port.obj_b) == (ref.objsense, ref.obj_b)
    nat = cbf.read_cbf(path, prefer_native="always")
    np.testing.assert_array_equal(nat.A, ref.A)


@pytest.mark.parametrize("path", _suite("conic_mini", "*.mat"),
                         ids=os.path.basename)
def test_load_sedumi_matches_reference(path):
    A, b, c, cones, perm = sedumi.load_sedumi_mat(path)
    rA, rb, rc, rcones, rperm = jsedumi.load_sedumi_mat(path)
    for p, r in ((A, rA), (b, rb), (c, rc), (perm, rperm)):
        np.testing.assert_array_equal(np.asarray(p.toarray() if sp.issparse(p)
                                                 else p),
                                      np.asarray(r.toarray() if sp.issparse(r)
                                                 else r))
    assert cones.dim == rcones.dim and cones.soc == rcones.soc


def test_cbf_roundtrips():
    """`tests/test_cbf.py`'s round trips through the port's writer and
    reader: a randcone instance exactly, MAX sense with an objective
    constant (solved, against HiGHS), and a constraint-free instance."""
    import tempfile

    from scipy.optimize import linprog

    from benchmarks.conic_mini import randcone

    jc = abip_tpu.ConeSpec(soc=(5, 4), rsoc=(3,), free=2, nonneg=10)
    _, A, b, c, _, pobj_star = randcone("rt", 8, jc, seed=3)
    cones = ConeSpec(soc=(5, 4), rsoc=(3,), free=2, nonneg=10)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rt.cbf")
        cbf.write_cbf(path, A, b, c, cones, comment="round-trip")
        emb = cbf.read_cbf(path)
        np.testing.assert_array_equal(emb.A, A)
        np.testing.assert_array_equal(emb.b, b)
        np.testing.assert_array_equal(emb.c, c)
        assert emb.cones == cones
        sol = abip_tpu_torch.solve(emb.A, emb.b, emb.c, cones=emb.cones,
                                   eps=1e-6, **CPU)
        assert sol.status_name == "Solved"
        assert abs(emb.objective(sol.pobj) - pobj_star) <= 1e-4 * max(
            1.0, abs(pobj_star))

        rng = np.random.default_rng(5)
        A = np.abs(rng.standard_normal((3, 6))) + 0.1
        b = A @ (rng.random(6) + 0.5)
        c = rng.random(6) + 0.5
        path = os.path.join(d, "max.cbf")
        cbf.write_cbf(path, A, b, -c, ConeSpec.lp(6), objsense="MAX",
                      obj_b=7.5)
        _, _, obj = cbf.solve_cbf(path, eps=1e-7, **CPU)
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        assert abs(obj - (-ref.fun + 7.5)) < 1e-5

        path = os.path.join(d, "nocon.cbf")
        cbf.write_cbf(path, np.zeros((0, 3)), np.zeros(0),
                      np.array([1.0, -2.0, 3.0]), ConeSpec(soc=(3,)))
        emb = cbf.read_cbf(path)
        assert emb.A.shape == (0, 3) and emb.cones.soc == (3,)


@pytest.mark.parametrize("name", ["rand_soc_b_max", "rand_rsoc_a_rows",
                                  "nnlsq30x25s33_max"])
def test_solve_cbf_matches_reference(name):
    path = os.path.join(SUITES, "cblib_mini", f"{name}.cbf")
    with open(os.path.join(SUITES, "cblib_mini", "optima.json")) as f:
        star = json.load(f)[name]
    port, x, obj = cbf.solve_cbf(path, eps=1e-6, **CPU)
    ref, rx, robj = jcbf.solve_cbf(path, eps=1e-6)
    _assert_solves_equal(ref, port)
    assert abs(obj - robj) <= OBJ_RTOL * max(1.0, abs(robj))
    assert abs(obj - star) <= 1e-5 * max(1.0, abs(star))
    np.testing.assert_allclose(x, rx, rtol=0, atol=1e-6 * max(
        1.0, np.abs(rx).max()))


def test_solve_sedumi_matches_reference():
    path = os.path.join(SUITES, "conic_mini", "rand_mixed_a.mat")
    port, extra = sedumi.solve_sedumi(path, eps=1e-6,
                                      extra_fields=("pobj_star",), **CPU)
    ref = jsedumi.solve_sedumi(path, eps=1e-6)
    _assert_solves_equal(ref, port)
    star = float(np.asarray(extra["pobj_star"]).ravel()[0])
    assert abs(port.pobj - star) <= 1e-5 * max(1.0, abs(star))


@pytest.mark.parametrize("dense", [True, False])
def test_solve_mps_matches_reference(dense):
    """dense=False keeps the presolved scipy sparse A (K5's route on the
    card)."""
    path = os.path.join(SUITES, "netlib_mini", "blend01.mps")
    port, pstd = presolve.solve_mps(path, dense=dense, eps=1e-6, **CPU)
    ref, _ = jpresolve.solve_mps(path, dense=dense, eps=1e-6)
    _assert_solves_equal(ref, port)
    np.testing.assert_allclose(port.x, ref.x, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref.x).max()))
    np.testing.assert_allclose(port.x_std, ref.x_std, rtol=0, atol=1e-6 * max(
        1.0, np.abs(ref.x_std).max()))


def test_solve_mps_routes():
    """method="device" runs the batched device solve at B=1: held to the
    reference's route on the same file (equal status, ADMM counts within
    10% and objectives within 1e-6 relative, the bar of the mixed-
    precision routes) and to HiGHS on the presolved form (1e-5); "pdhg"
    runs the restarted PDHG in f64, held to the reference's "pdhg" route
    (equal status and iteration count, objectives within 1e-9 relative)
    and to HiGHS (1e-5)."""
    from scipy.optimize import linprog

    path = os.path.join(SUITES, "netlib_mini", "blend01.mps")
    sol, std = presolve.solve_mps(path, method="device", eps=1e-6, **CPU)
    jsol, _ = jpresolve.solve_mps(path, method="device", eps=1e-6)
    assert sol.status_name == jsol.status_name == "Solved"
    assert abs(sol.admm_iters - jsol.admm_iters) <= 0.1 * jsol.admm_iters
    assert abs(sol.pobj - jsol.pobj) <= 1e-6 * max(1.0, abs(jsol.pobj))
    ref = linprog(std.c, A_eq=std.A, b_eq=std.b, bounds=(0, None),
                  method="highs")
    assert abs(sol.pobj - std.user_objective(ref.fun)) <= 1e-5 * max(
        1.0, abs(ref.fun))
    psol, _ = presolve.solve_mps(path, method="pdhg", eps=1e-6, **CPU)
    jpsol, _ = jpresolve.solve_mps(path, method="pdhg", eps=1e-6)
    assert psol.status_name == jpsol.status_name == "Solved"
    assert psol.admm_iters == jpsol.admm_iters
    assert abs(psol.pobj - jpsol.pobj) <= 1e-9 * max(1.0, abs(jpsol.pobj))
    assert abs(psol.pobj - std.user_objective(ref.fun)) <= 1e-5 * max(
        1.0, abs(ref.fun))
    np.testing.assert_allclose(psol.x, jpsol.x, rtol=0,
                               atol=1e-7 * max(1.0, np.abs(jpsol.x).max()))
    with pytest.raises(ValueError, match="Settings"):
        presolve.solve_mps(path, method="device",
                           settings=abip_tpu_torch.Settings(), **CPU)
    # the reference has no CBF device route: `method` reaches Settings
    with pytest.raises(TypeError, match="method"):
        cbf.solve_cbf(os.path.join(SUITES, "cblib_mini", "rand_soc_a.cbf"),
                      method="device", **CPU)


@pytest.mark.parametrize("sparse_route", [True, False])
def test_solve_general_matches_reference(sparse_route):
    """A two-sided, bounded, free-variable LP through presolve: at
    sparsity <= 0.25 the standard form stays a scipy sparse A."""
    rng = np.random.default_rng(21)
    m, n = 12, 30
    A = rng.standard_normal((m, n))
    if sparse_route:
        A[rng.random((m, n)) < 0.85] = 0.0
    x0 = rng.random(n)
    row = A @ x0
    lo, hi = row - rng.random(m), row + rng.random(m)
    lb = np.where(np.arange(n) % 5 == 0, -np.inf, 0.0)
    ub = np.where(np.arange(n) % 3 == 0, 2.0, np.inf)
    c = rng.random(n) + 0.1
    kw = dict(row_lo=lo, row_hi=hi, lb=lb, ub=ub, objcon=1.5, eps=1e-6)
    port = abip_tpu_torch.dispatch.solve_general(A, c, **kw, **CPU)
    ref = abip_tpu.solve_general(A, c, **kw)
    std = presolve.presolve_to_standard(mps.GeneralLP(
        c=c, A=sp.csc_matrix(A), row_lo=lo, row_hi=hi, lb=lb, ub=ub,
        objcon=1.5))
    assert (std.sparsity <= 0.25) == sparse_route
    _assert_solves_equal(ref, port)
    np.testing.assert_allclose(port.x, ref.x, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref.x).max()))


def _cli_json(main, argv, capsys):
    code = main(argv)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    return code, json.loads(line)


@pytest.mark.parametrize("case", ["mps", "cbf", "sedumi"])
def test_cli_in_process_matches_reference(case, tmp_path, capsys):
    if case == "mps":
        rng = np.random.default_rng(2)
        A = np.abs(rng.standard_normal((3, 8))) + 0.1
        x0 = rng.random(8) + 0.5
        p = mps.GeneralLP(c=rng.random(8) + 0.1, A=sp.csc_matrix(A),
                          row_lo=A @ x0, row_hi=A @ x0, lb=np.zeros(8),
                          ub=np.full(8, np.inf), name="t")
        path = str(tmp_path / "t.mps")
        write_mps(p, path)
        argv = [path, "--eps", "1e-7"]
    elif case == "cbf":
        argv = [os.path.join(SUITES, "cblib_mini", "rand_soc_b_max.cbf"),
                "--eps", "1e-6"]
    else:
        argv = [os.path.join(SUITES, "conic_mini", "rand_soc_a.mat"),
                "--sedumi", "--eps", "1e-6"]
    code, port = _cli_json(cli.main, argv + ["--cpu", "--json"], capsys)
    rcode, ref = _cli_json(jcli.main, argv + ["--cpu", "--json"], capsys)
    assert code == rcode == 0
    assert set(port) == set(ref)
    for k, r in ref.items():
        if k in ("status", "ipm_iters", "admm_iters"):
            assert port[k] == r, k
        elif k in ("pobj", "dobj", "objective"):
            assert abs(port[k] - r) <= OBJ_RTOL * max(1.0, abs(r)), k


def _crossover_line(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr().out.splitlines()
    line = [ln for ln in out if ln.startswith("crossover:")]
    return code, line, json.loads([ln for ln in out if ln.startswith("{")][-1])


def test_cli_crossover_matches_reference(capsys):
    """`--crossover` on an MPS file polishes the solve to a vertex and
    prints the reference's line: the same certificate (optimal_basis)
    and the vertex objective within 1e-9 relative (both crossovers are
    the same numpy code, from interior points within the solves' bar)."""
    argv = [os.path.join(SUITES, "netlib_mini", "blend01.mps"), "--eps",
            "1e-6", "--cpu", "--crossover", "--json"]
    code, line, rec = _crossover_line(cli.main, argv, capsys)
    rcode, rline, rrec = _crossover_line(jcli.main, argv, capsys)
    assert code == rcode == 0
    assert len(line) == len(rline) == 1
    fields = dict(f.split("=") for f in line[0].split()[1:])
    rfields = dict(f.split("=") for f in rline[0].split()[1:])
    assert fields["optimal_basis"] == rfields["optimal_basis"] == "True"
    v, rv = float(fields["vertex_obj"]), float(rfields["vertex_obj"])
    assert abs(v - rv) <= 1e-9 * max(1.0, abs(rv))
    assert rec["status"] == rrec["status"] == "Solved"


def test_native_parser_builds_and_cli_needs_a_card():
    """The shared C++ parser loads (built with `make -C native` on first
    use where it is missing); without a card and without `--cpu` the CLI
    raises rather than fall back to the CPU."""
    assert native.native_available() and native.cbf_native_available()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([os.path.join(SUITES, "cblib_mini", "rand_soc_a.cbf"),
                      "--json"])


def test_public_surface_matches_reference():
    """`abip_tpu_torch` and `abip_tpu_torch.parallel` export every name the
    reference's do, the multi-card `sharded_normal_matvec` and
    `sharded_pcg` included."""
    import abip_tpu.parallel as jpar

    import abip_tpu_torch.parallel as par

    assert set(abip_tpu.__all__) <= set(abip_tpu_torch.__all__)
    for name in abip_tpu_torch.__all__:
        assert hasattr(abip_tpu_torch, name), name
    assert set(jpar.__all__) <= set(par.__all__)
    for name in par.__all__:
        assert hasattr(par, name), name
