"""`abip_tpu_torch.conic_ops` (and the ladder's f32 barrier tables)
against `abip_tpu.conic_ops` / `abip_tpu.ops.conic_pallas`.

Random f64 inputs from numpy seeds, batched on the port's side and lane
by lane on the reference's.  f64 code on both sides: 1e-12 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import conic_ops as jops  # noqa: E402
from abip_tpu import qcp as jqcp  # noqa: E402
from abip_tpu.ops.conic_pallas import _adjust_barrier_f32 as j_adjust_f32  # noqa: E402
from abip_tpu_torch import conic_ops as ops  # noqa: E402
from abip_tpu_torch import qcp  # noqa: E402
from abip_tpu_torch.ops.conic_dr import _adjust_barrier_f32  # noqa: E402

B, M, N = 3, 5, 9


def _case(seed, diag_q):
    rng = np.random.default_rng(seed)
    l = M + N + 1
    d = dict(A=rng.standard_normal((B, M, N)), b=rng.standard_normal((B, M)),
             c=rng.standard_normal((B, N)), u=rng.standard_normal((B, l)),
             v=rng.standard_normal((B, l)), D=rng.random((B, M)) + 0.5,
             E=rng.random((B, N)) + 0.5, sc_b=rng.random(B) + 0.5,
             sc_c=rng.random(B) + 0.5, nb=rng.random(B) + 1.0,
             nc=rng.random(B) + 1.0,
             Q=(rng.random((B, N)) if diag_q else np.zeros((B, N))))
    d["u"][:, -1] = np.abs(d["u"][:, -1]) + 0.1
    # lane 0 certifies infeasibility (b'y > 0), lane 1 unboundedness
    # (c'x < 0), lane 2 neither
    d["u"][0, :M] = d["b"][0]
    d["u"][1, M:M + N] = -d["c"][1]
    d["u"][2, :M] = -d["b"][2]
    d["u"][2, M:M + N] = d["c"][2]
    return d


def _port_ops(d):
    A = torch.from_numpy(d["A"])
    Q = torch.from_numpy(d["Q"])
    return (lambda x: (A @ x[..., None])[..., 0],
            lambda y: (y[:, None, :] @ A)[:, 0],
            lambda x: Q * x)


def _jax_ops(d, i):
    A, Q = jnp.asarray(d["A"][i]), jnp.asarray(d["Q"][i])
    return (lambda x: A @ x), (lambda y: A.T @ y), (lambda x: Q * x)


@pytest.mark.parametrize("diag_q", [False, True])
def test_inner_conv_check_matches_reference(diag_q):
    d = _case(1, diag_q)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    port = ops.inner_conv_check(t["u"], t["v"], *_port_ops(d), t["b"], t["c"],
                                M, N).numpy()
    for i in range(B):
        r = jops.inner_conv_check(jnp.asarray(d["u"][i]), jnp.asarray(
            d["v"][i]), *_jax_ops(d, i), jnp.asarray(d["b"][i]),
            jnp.asarray(d["c"][i]), M, N)
        np.testing.assert_allclose(port[i], float(r), rtol=1e-12)


@pytest.mark.parametrize("diag_q", [False, True])
def test_residuals_and_codes_match_reference(diag_q):
    """Every field of `conic_residuals` (NaN where the reference puts
    NaN) and the `has_converged` codes.  A second evaluation takes the
    first as `prev` (res_dif = 0), and the tolerances vary, so that
    solved, stagnation, infeasible, unbounded and unfinished all occur."""
    d = _case(2, diag_q)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}

    def port_res(prev):
        return ops.conic_residuals(
            t["u"], t["v"], prev, *_port_ops(d), t["b"], t["c"], t["D"],
            t["E"], t["sc_b"], t["sc_c"], 1.0, t["nb"], t["nc"], 1e-4, 1e-4,
            1e-4, M, N)

    def jax_res(i, prev):
        return jops.conic_residuals(
            jnp.asarray(d["u"][i]), jnp.asarray(d["v"][i]), prev,
            *_jax_ops(d, i), jnp.asarray(d["b"][i]), jnp.asarray(d["c"][i]),
            jnp.asarray(d["D"][i]), jnp.asarray(d["E"][i]), d["sc_b"][i],
            d["sc_c"][i], 1.0, d["nb"][i], d["nc"][i], 1e-4, 1e-4, 1e-4, M,
            N)

    first = port_res(ops.ConicResiduals.init(B))
    second = port_res(first)
    # (eps_p = eps_d = eps_g, eps_inf, eps_unb, err_dif, total_pos)
    tols = ((1e-4, 1e-4, 1e-4, 0.0, True), (1e9, 1e-4, 1e-4, 0.0, True),
            (1e-4, 1e9, 1e-12, 0.0, True), (1e-4, 1e-12, 1e9, 0.0, True),
            (1e-4, 1e9, 1e9, 0.0, False), (1e-4, 1e-4, 1e-4, 1.0, True))
    seen = set()
    for i in range(B):
        r1 = jax_res(i, jops.ConicResiduals.init(jnp.float64))
        r2 = jax_res(i, r1)
        for port, ref in ((first, r1), (second, r2)):
            for name in ops.ConicResiduals._fields:
                np.testing.assert_allclose(
                    getattr(port, name)[i].item(), float(getattr(ref, name)),
                    rtol=1e-12, atol=1e-300, equal_nan=True, err_msg=name)
            for eps, e_inf, e_unb, dif, tp in tols:
                code = ops.conic_converged_code(
                    port, eps, eps, eps, e_inf, e_unb, dif,
                    torch.full((B,), tp))[i].item()
                want = int(jops.conic_converged_code(
                    ref, eps, eps, eps, e_inf, e_unb, dif, tp))
                assert code == want, (i, eps, e_inf, e_unb, dif, tp)
                seen.add(code)
    assert {0, 1, 2, -1, -2} <= seen, seen


def _edge_grid():
    """mu/eps and error ratios on, just below and just above every
    bucket edge of the `adjust_barrier` tables."""
    mus, ratios = [], []
    for e in ops._RATIO_EDGES:
        mus += [e * (1 - 1e-9), e, e * (1 + 1e-9)]
    for e in ops._ERR_EDGES:
        ratios += [e * (1 - 1e-9), e, e * (1 + 1e-9)]
    return np.array(mus + [1e-8, 1e4]), np.array(ratios + [0.1, 1e8])


def test_adjust_barrier_device_matches_reference_across_edges():
    eps, psi = 1.0, 1.0
    mus, ratios = _edge_grid()
    mu = torch.from_numpy(np.repeat(mus, ratios.size))
    ratio = torch.from_numpy(np.tile(ratios, mus.size))
    m_new, tol = ops.adjust_barrier_device(mu, ratio, eps, psi)
    for k in range(mu.numel()):
        rm, rt = jops.adjust_barrier_device(jnp.float64(mu[k].item()),
                                            jnp.float64(ratio[k].item()),
                                            eps, psi)
        assert m_new[k].item() == pytest.approx(float(rm), rel=1e-15)
        assert tol[k].item() == pytest.approx(float(rt), rel=1e-15)
    # psi != 1 takes the power
    m2, t2 = ops.adjust_barrier_device(mu[:3], ratio[:3], 1e-6, 0.8)
    rm, rt = jops.adjust_barrier_device(jnp.float64(mu[0].item()),
                                        jnp.float64(ratio[0].item()), 1e-6,
                                        0.8)
    assert t2[0].item() == pytest.approx(float(rt), rel=1e-14)


def test_adjust_barrier_f32_matches_tables_across_edges():
    """The ladder's unrolled f32 tables against the reference's f32
    tables (equal bits) and against the f64 searchsorted tables
    (`tests/test_conic_ladder.py:28-44`), at every bucket edge."""
    eps = 1e-6
    mus, ratios = _edge_grid()
    mus = mus * eps
    mu32 = torch.from_numpy(np.repeat(mus, ratios.size).astype(np.float32))
    r32 = torch.from_numpy(np.tile(ratios, mus.size).astype(np.float32))
    eps32 = torch.full_like(mu32, eps)
    m_new, tol = _adjust_barrier_f32(mu32[:, None], r32[:, None],
                                     eps32[:, None], 1.0)
    for k in range(mu32.numel()):
        jm, jt = j_adjust_f32(jnp.float32(mu32[k].item()),
                              jnp.float32(r32[k].item()), jnp.float32(eps),
                              1.0)
        assert m_new[k, 0].item() == float(jm)
        assert tol[k, 0].item() == float(jt)
    # away from the edges (where f32 rounding of mu/eps may move a value
    # to the other side), the f32 tables agree with the f64 searchsorted
    # tables to f32 rounding: the grid of `tests/test_conic_ladder.py:28-44`
    for mu in (1.0, 0.3, 1e-2, 1e-3, 3e-5, 9e-7, 1e-8):
        for r in (0.5, 1.5, 1.9, 3.0, 5.0, 8.0, 12.0, 21.9, 22.0, 1e3, 1e8):
            m64, t64 = ops.adjust_barrier_device(
                torch.tensor([mu], dtype=torch.float64),
                torch.tensor([r], dtype=torch.float64), eps, 1.0)
            m32, t32 = _adjust_barrier_f32(
                torch.tensor([[mu]], dtype=torch.float32),
                torch.tensor([[r]], dtype=torch.float32),
                torch.tensor([[eps]], dtype=torch.float32), 1.0)
            assert m32.item() == pytest.approx(m64.item(), rel=1e-6)
            assert t32.item() == pytest.approx(t64.item(), rel=1e-6)


def test_conic_defaults_match_reference():
    assert qcp.EPS_TOL == jqcp.EPS_TOL
    port, ref = qcp.conic_defaults(), jqcp.conic_defaults()
    for name in ("rho_y", "rho_x", "rho_tau", "psi", "origin_rescale",
                 "pc_ruiz_rescale", "qp_rescale", "ruiz_iter", "scale"):
        assert getattr(port, name) == getattr(ref, name), name
    assert qcp.conic_defaults(rho_y=1e-3).rho_y == 1e-3
