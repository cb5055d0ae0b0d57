"""`abip_tpu_torch.ops.conic_dr.fused_dr_sprint_stop` (the conic sprint's
plain version) against `abip_tpu.ops.conic_pallas.fused_dr_sprint_stop`,
run as the Pallas kernel body (`use_pallas=True, interpret=True`) and
as its XLA fallback (`use_pallas=False`).

Both sides get the same f32 operands of a prepared numpy-seeded batch
(`tests/test_torch_conic_ladder.py`: Woodbury and primal forms, with and
without a diagonal Q), at the cold start (k0 = 0: the first iteration
takes tau_t = 1, mu = 1) and at the state 64 iterations later (k0 = 64,
mu = 0.2).  Iteration counts must be equal; values agree to the ladder's
tolerance: rtol 2e-5 plus 1e-5 of each output's largest magnitude, that
absolute term times 1/rho_y for the free block y (y = (wy - A zx) /
rho_y amplifies f32 rounding), and the inner criterion err, a
residual of such iterates, to 10% (measured: up to 6.6% apart at
k0 = 64, as the ladder's err is 3.5% apart at its end).  The
CUDA kernel is held to the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.cones import ConeLayout as JLayout  # noqa: E402
from abip_tpu.cones import ConeSpec as JSpec  # noqa: E402
from abip_tpu.ops import conic_pallas as jcp  # noqa: E402
from abip_tpu_torch import cones  # noqa: E402
from abip_tpu_torch.ops import conic_dr as dr  # noqa: E402
from test_torch_conic_ladder import (RHO_Y, SPEC, _cold_state,  # noqa: E402
                                     assert_f32_close, prepared_batch)

PROBE = 8
ERR_RTOL = 0.1
REFERENCE = {"pallas": dict(use_pallas=True, interpret=True),
             "xla": dict(use_pallas=False)}


def _operands(P):
    """(A, Minv, Hinv, r_vec, b, c, Qd) f32 tensors of the batch."""
    B, m, n = P.A.shape
    woodbury = P.dss.form == "woodbury"
    Hinv = P.dss.H_inv if woodbury else torch.zeros((B, n),
                                                    dtype=torch.float64)
    Qd = P.Q_diag if P.Q_diag is not None else torch.zeros(
        (B, n), dtype=torch.float64)
    return tuple(x.float().contiguous() for x in (
        P.A, P.dss.Minv64, Hinv, P.r_vec, P.b, P.c, Qd))


def _port(P, u, v, lam, thresh, k0, T):
    co = cones.cone_operands(cones.ConeSpec(**SPEC))
    return dr.fused_dr_sprint_stop(
        *_operands(P), co, RHO_Y, 1.0, 1.0, P.a_coef, lam, 1.8,
        torch.as_tensor(thresh, dtype=torch.float64), u, v, k0, T=T,
        probe=PROBE, woodbury=P.dss.form == "woodbury")


def _ref(P, i, u, v, lam, thresh, k0, T, how):
    n = P.A.shape[2]
    cd = jcp.cone_kernel_data(JLayout(JSpec(**SPEC)), jcp._pad128(n))
    ops = [jnp.asarray(x[i].numpy()) for x in _operands(P)]
    return jcp.fused_dr_sprint_stop(
        *ops, cd, RHO_Y, 1.0, 1.0, float(P.a_coef[i]), lam, 1.8, thresh,
        jnp.asarray(u[i].numpy()), jnp.asarray(v[i].numpy()),
        jnp.float32(k0), T=T, probe=PROBE,
        woodbury=P.dss.form == "woodbury", **REFERENCE[how])


def _assert_close(port, ref, m, label):
    """(u, v, t_done, err) of one lane: y with the 1/rho_y
    amplification, err at ERR_RTOL, t_done equal."""
    (pu, pv, pt, pe), (ru, rv, rt, re) = port, ref
    assert int(pt) == int(rt), label
    ru, rv = np.asarray(ru), np.asarray(rv)
    assert_f32_close(pu[:m].numpy(), ru[:m], f"{label} y", 1.0 / RHO_Y)
    assert_f32_close(pu[m:].numpy(), ru[m:], f"{label} x, tau")
    assert_f32_close(pv.numpy(), rv, f"{label} v")
    np.testing.assert_allclose(float(pe), float(re), rtol=ERR_RTOL,
                               err_msg=f"{label} err")


@pytest.mark.parametrize("how", sorted(REFERENCE))
@pytest.mark.parametrize("woodbury,diag_q", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_sprint_matches_reference(woodbury, diag_q, how):
    """T=64 at thresh=0 from the cold start (mu = 1), then 64 more from
    the port's state at mu = 0.2, two lanes at once."""
    P = prepared_batch(woodbury, diag_q)
    B, m, n = P.A.shape
    u0, _ = _cold_state(P)
    u = torch.from_numpy(np.tile(u0, (B, 1))).float()
    v = u.clone()
    first = _port(P, u, v, 1.0, 0.0, 0.0, 64)
    assert first[2].tolist() == [64, 64]
    for i in range(B):
        _assert_close([x[i] for x in first],
                      _ref(P, i, u, v, 1.0, 0.0, 0.0, 64, how), m,
                      f"cold lane {i}")
    u, v = first[0], first[1]
    second = _port(P, u, v, 0.2, 0.0, 64.0, 64)
    for i in range(B):
        _assert_close([x[i] for x in second],
                      _ref(P, i, u, v, 0.2, 0.0, 64.0, 64, how), m,
                      f"k0=64 lane {i}")


def test_sprint_stops_with_the_reference():
    """Per lane, a threshold halfway (geometrically) between the
    reference's err after 32 and 40 iterations, a drop of at least 1.1x,
    stops both versions at 40 within T=512; inactive lanes run zero
    iterations."""
    P = prepared_batch(True, False)
    B = P.A.shape[0]
    u0, _ = _cold_state(P)
    u = torch.from_numpy(np.tile(u0, (B, 1))).float()
    thresh = []
    for i in range(B):
        e32, e40 = (float(_ref(P, i, u, u, 1.0, 0.0, 0.0, t, "xla")[3])
                    for t in (32, 40))
        assert e32 > 1.1 * e40
        thresh.append((e32 * e40) ** 0.5)
        assert int(_ref(P, i, u, u, 1.0, thresh[i], 0.0, 512,
                        "pallas")[2]) == 40
    assert _port(P, u, u.clone(), 1.0, thresh, 0.0, 512)[2].tolist() == \
        [40] * B
    co = cones.cone_operands(cones.ConeSpec(**SPEC))
    out = dr.fused_dr_sprint_stop(
        *_operands(P), co, RHO_Y, 1.0, 1.0, P.a_coef, 1.0, 1.8, 0.0, u,
        u.clone(), 0.0, T=16, probe=PROBE, woodbury=True,
        active=torch.tensor([True, False]))
    assert out[2].tolist() == [16, 0]
    assert torch.equal(out[0][1], u[1])


def test_cuda_wrapper_refuses_cpu_tensors():
    P = prepared_batch(True, False)
    B, m, n = P.A.shape
    A, Minv, Hinv, r_vec, b, c, Qd = _operands(P)
    z = torch.zeros((B, m))
    op = dr.DrSprintOperands(torch.zeros((B, dr.N_SPRINT_SCAL)), A, Minv,
                             Hinv, r_vec[:, :m], r_vec[:, m:], b, c, Qd, z,
                             torch.zeros((B, n)), z, torch.zeros((B, n)))
    with pytest.raises(ValueError, match="CUDA"):
        dr.dr_sprint_cuda(op, cones.cone_operands(cones.ConeSpec(**SPEC)),
                          torch.ones((B,), dtype=torch.int32), probe=8,
                          woodbury=True)
