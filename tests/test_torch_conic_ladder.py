"""`abip_tpu_torch.ops.conic_dr` (the ladder's plain version) against
`abip_tpu.ops.conic_pallas` (its XLA version `_dr_ladder_compute`).

Both sides get identical f32 operands: the reference's padded operand
tuple, built from a prepared numpy-seeded batch as `fused_dr_ladder`
builds it, and the port's `ladder_operands_from_numpy` of that tuple.
The ladder runs phase 1 exactly (cold start k0 = 0, T = 2048,
mu_stop = 1e-3).  Its decisions (t_done, stages, mu) must be equal; its
values agree to the LP chunk's cross-framework f32 tolerance
(`tests/test_torch_admm_delta.py`), rtol 2e-5 plus
1e-5 of each output's largest magnitude (f32 reductions in another
order), as each does with an f64 run of the port's recurrence -- except
where the recurrence amplifies f32 rounding:

* y, the free block, is (wy - A zx) / rho_y: the rounding of the solve
  is multiplied by 1/rho_y = 1e3.  Measured after phase 1: both f32
  versions sit up to 4.5e-3 (scale ~4) from the f64 run, and as far
  from each other.  Its absolute term is 1e-5 / rho_y of the scale.
* err, the inner criterion at the last probe, is computed from y: the
  two f32 versions differ by up to 3.5% of it; held to rtol 5e-2.

The CUDA kernel is held to the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.cones import ConeLayout as JLayout  # noqa: E402
from abip_tpu.cones import ConeSpec as JSpec  # noqa: E402
from abip_tpu.ops import conic_pallas as jcp  # noqa: E402
from abip_tpu_torch import cones  # noqa: E402
from abip_tpu_torch.cones import _SOC  # noqa: E402
from abip_tpu_torch.ops import conic_dr as dr  # noqa: E402
from abip_tpu_torch.parallel import batched_qcp as bq  # noqa: E402
from benchmarks.conic_mini import randcone, randqcp  # noqa: E402

RTOL_F32, REL_SCALE = 2e-5, 1e-5
SPEC = dict(soc=(5,), rsoc=(4,), nonneg=10)
T, PROBE = 2048, 8


RHO_Y = 1e-3
ERR_RTOL = 5e-2


def assert_f32_close(port, ref, err_msg="", amplify=1.0):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    atol = amplify * REL_SCALE * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=RTOL_F32, atol=atol,
                               err_msg=err_msg)


def assert_ladder_close(port, ref, label):
    """(y, x, vy, vx, row) of two ladder runs of one lane: y with the
    1/rho_y amplification, the err slot of the row at ERR_RTOL."""
    for k, name in enumerate(("y", "x", "vy", "vx")):
        assert_f32_close(port[k], ref[k], f"{label} {name}",
                         1.0 / RHO_Y if name == "y" else 1.0)
    keep = [0, 1, 3, 4, 5, 6]
    assert_f32_close(np.asarray(port[4])[keep], np.asarray(ref[4])[keep],
                     f"{label} row")
    np.testing.assert_allclose(port[4][2], ref[4][2], rtol=ERR_RTOL,
                               err_msg=f"{label} err")


def prepared_batch(woodbury, diag_q, seed0=40, B=2):
    """A prepared numpy-seeded batch: Woodbury form at m=7 (2m <= n),
    primal form at m=12; with a diagonal Q from `randqcp`."""
    m = 7 if woodbury else 12
    data = [(randqcp("x", m, JSpec(**SPEC), seed=seed0 + i, q_rank="diag")
             if diag_q else randcone("x", m, JSpec(**SPEC), seed=seed0 + i))
            for i in range(B)]
    As, bs, cs = (torch.from_numpy(np.stack([d[k] for d in data]))
                  for k in (1, 2, 3))
    Qs = torch.from_numpy(np.stack([d[4] for d in data])) if diag_q else None
    P = bq.prepare_conic_batch(As, bs, cs, Qs, cones=cones.ConeSpec(**SPEC),
                               rho_y=1e-3, precision="mixed")
    assert P.dss.form == ("woodbury" if woodbury else "primal")
    return P


def reference_args(P, i, u, v, mu, tol, k0, mu_stop=1e-3, eps=1e-6):
    """The reference's operand tuple for lane i (`fused_dr_ladder`)."""
    B, m, n = P.A.shape
    woodbury = P.dss.form == "woodbury"
    mp, np_ = jcp._pad128(m), jcp._pad128(n)
    f = lambda x: jnp.asarray(x[i].numpy(), jnp.float32)  # noqa: E731
    l = m + n + 1
    scal = np.zeros((1, 128), np.float32)
    for k, s in enumerate((1e-3, 1.0, 1.0, P.a_coef[i].item(), mu, 1.8,
                           u[l - 1], v[l - 1], tol, k0, mu_stop, eps,
                           P.sc_b[i].item(), P.sc_c[i].item(),
                           P.nm_inf_b0[i].item(), P.nm_inf_c0[i].item())):
        scal[0, k] = np.float32(s)
    Minv = P.dss.Minv64
    mk = mp if woodbury else np_
    Qd = (P.Q_diag if P.Q_diag is not None
          else torch.zeros((B, n), dtype=torch.float64))
    Hinv = (P.dss.H_inv if woodbury
            else torch.zeros((B, n), dtype=torch.float64))
    u32, v32 = jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32)
    return (jnp.asarray(scal), jcp._pad_mat(f(P.A), m, n, mp, np_),
            jcp._pad_mat(f(Minv), Minv.shape[1], Minv.shape[1], mk, mk),
            jcp._pad_vec(f(Hinv), n, np_), jcp._pad_vec(f(P.r_vec)[:m], m, mp),
            jcp._pad_vec(f(P.r_vec)[m:], n, np_), jcp._pad_vec(f(P.b), m, mp),
            jcp._pad_vec(f(P.c), n, np_), jcp._pad_vec(f(Qd), n, np_),
            jcp._pad_vec(f(P.D), m, mp), jcp._pad_vec(f(P.E), n, np_),
            *jcp.cone_kernel_data(JLayout(JSpec(**SPEC)), np_),
            jcp._pad_vec(u32[:m], m, mp), jcp._pad_vec(u32[m:m + n], n, np_),
            jcp._pad_vec(v32[:m], m, mp), jcp._pad_vec(v32[m:m + n], n, np_))


@partial(jax.jit, static_argnames=("woodbury",))
def _reference_ladder(args, woodbury):
    cd = jcp.ConeKernelData(*args[11:11 + jcp._CD_FIELDS])
    with jax.default_matmul_precision("highest"):
        return jcp._dr_ladder_compute(
            *args[:11], cd, *args[11 + jcp._CD_FIELDS:], T=T, probe=PROBE,
            psi=1.0, woodbury=woodbury)


def _cold_state(P):
    B, m, n = P.A.shape
    x0 = cones.ConeLayout(cones.ConeSpec(**SPEC)).interior_point().numpy()
    u0 = np.concatenate([np.zeros(m), x0, [1.0]])
    return u0, u0.copy()


def _port_operands(ref_args, P):
    _, m, n = P.A.shape
    woodbury = P.dss.form == "woodbury"
    per_lane = [dr.ladder_operands_from_numpy([np.asarray(a) for a in args],
                                              m, n, woodbury)
                for args in ref_args]
    return dr.LadderOperands(*[torch.cat(f) for f in zip(*per_lane)])


@pytest.mark.parametrize("woodbury,diag_q", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_plain_ladder_matches_reference(woodbury, diag_q):
    """Phase 1 from the cold start, two lanes at once."""
    P = prepared_batch(woodbury, diag_q)
    u0, v0 = _cold_state(P)
    ref_args = [reference_args(P, i, u0, v0, 1.0, 4.0, 0.0) for i in range(2)]
    ref = [_reference_ladder(a, woodbury) for a in ref_args]
    op = _port_operands(ref_args, P)
    co = cones.cone_operands(cones.ConeSpec(**SPEC))
    t_max = torch.full((2,), T, dtype=torch.int32)
    port = dr._dr_ladder_compute(op, co, t_max, probe=PROBE, psi=1.0,
                                 woodbury=woodbury)
    exact = dr._dr_ladder_compute(
        dr.LadderOperands(*[x.double() for x in op]), co, t_max,
        probe=PROBE, psi=1.0, woodbury=woodbury)
    _, m, n = P.A.shape
    for i, r in enumerate(ref):
        r_vals = [np.asarray(r[0])[0, :m], np.asarray(r[1])[0, :n],
                  np.asarray(r[2])[0, :m], np.asarray(r[3])[0, :n],
                  np.asarray(r[4])[0, :dr.LADDER_ROW]]
        # decisions: iterations, stages and the final barrier parameter
        assert port[4][i, 3].item() == r_vals[4][3] == exact[4][i, 3].item()
        assert port[4][i, 6].item() == r_vals[4][6] == exact[4][i, 6].item()
        assert port[4][i, 4].item() == r_vals[4][4]
        assert r_vals[4][4] < 1e-3 <= r_vals[4][4] / 0.16
        p_vals = [x[i].numpy() for x in port]
        e_vals = [x[i].numpy() for x in exact]
        assert_ladder_close(p_vals, r_vals, "port vs reference")
        assert_ladder_close(p_vals, e_vals, "port vs f64 run")
        assert_ladder_close(r_vals, e_vals, "reference vs f64 run")


def test_plain_ladder_masks_lanes_and_stops_at_t_max():
    """A lane with t_max = 0 comes back unchanged; a lane with
    t_max = 16 stops after two trips, still above mu_stop."""
    P = prepared_batch(True, False)
    u0, v0 = _cold_state(P)
    ref_args = [reference_args(P, i, u0, v0, 1.0, 4.0, 0.0) for i in range(2)]
    op = _port_operands(ref_args, P)
    co = cones.cone_operands(cones.ConeSpec(**SPEC))
    y, x, vy, vx, row = dr._dr_ladder_compute(
        op, co, torch.tensor([0, 16], dtype=torch.int32), probe=PROBE,
        psi=1.0, woodbury=True)
    assert torch.equal(y[0], op.y[0]) and torch.equal(vx[0], op.vx[0])
    assert row[0, 3].item() == 0 and row[0, 4].item() == 1.0
    assert row[1, 3].item() == 16 and row[1, 4].item() >= 1e-3


def test_fused_dr_ladder_entry_on_cpu():
    """The entry takes the plain version on CPU tensors and returns the
    reference's tuple (u, v, t_done, err, mu, tol, stages)."""
    P = prepared_batch(True, False)
    B, m, n = P.A.shape
    u0, v0 = _cold_state(P)
    u = torch.from_numpy(np.tile(u0, (B, 1))).float()
    co = cones.cone_operands(cones.ConeSpec(**SPEC))
    out = dr.fused_dr_ladder(
        P.A.float(), P.dss.Minv64.float(), P.dss.H_inv.float(),
        P.r_vec.float(), P.b.float(), P.c.float(),
        torch.zeros((B, n)), P.D.float(), P.E.float(), co, 1e-3, 1.0, 1.0,
        P.a_coef, 1.0, 4.0, 1e-3, 1e-6, P.sc_b, P.sc_c, P.nm_inf_b0,
        P.nm_inf_c0, 1.8, u, u.clone(), 0.0, T=T, probe=PROBE,
        woodbury=True, active=torch.tensor([True, False]))
    uo, vo, t_done, err, mu, tol, stages = out
    assert uo.shape == (B, m + n + 1) and uo.dtype == torch.float32
    assert t_done.tolist()[1] == 0 and t_done.tolist()[0] > 0
    assert mu[0].item() < 1e-3 and stages[0].item() > 0
    assert torch.equal(uo[1], u[1])


@pytest.mark.parametrize("spec,interior", [
    (dict(soc=(1, 4), rsoc=(5, 3), free=2, zero=2, nonneg=3), False),
    (dict(soc=(3,) * 40 + (7,) * 5, rsoc=(3,) * 30 + (6,) * 5, nonneg=9),
     True)], ids=["every-kind", "many-blocks"])
def test_cone_prox_matches_reference_f32(spec, interior):
    """The f32 cone prox on gathered blocks against the reference's
    indicator-matrix products: every branch present on a few blocks, and
    the block bookkeeping on 80 blocks.  The many-block arguments lie
    inside their cones: for a head near -||body|| the reference formula
    itself cancels in f32 (two f32 versions then both sit ~2% from the
    f64 prox, and apart), which says nothing about the gathers."""
    lay = JLayout(JSpec(**spec))
    n = lay.n
    np_ = jcp._pad128(n)
    cd = jcp.cone_kernel_data(lay, np_)
    rng = np.random.default_rng(2)
    t = rng.standard_normal((3, n)).astype(np.float32)
    heads = np.flatnonzero(lay.head == 1)
    if interior:
        for i in range(3):
            for k, h in enumerate(heads):
                end = heads[k + 1] if k + 1 < heads.size else n
                if lay.kind[h] == _SOC:
                    t[i, h] = np.linalg.norm(t[i, h + 1:end]) + 0.5
                else:
                    t[i, h:h + 2] = np.linalg.norm(t[i, h + 2:end]) + 0.5
    else:
        t[0, heads[1]] = 5e-7                        # |a| <= _SOC_TOL
        t[1, heads] = -np.abs(t[1, heads])
        t[2, heads[2] + 1] = -t[2, heads[2]]         # RSOC sum_zz == 0
    lam = np.float32(1e-3)
    port = dr._cone_prox(torch.from_numpy(t), torch.full((3, 1), lam),
                         cones.cone_operands(cones.ConeSpec(**spec))).numpy()
    for i in range(3):
        tp = np.zeros((1, np_), np.float32)
        tp[0, :n] = t[i]
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jcp._cone_prox(jnp.asarray(tp), lam, cd))[0, :n]
        np.testing.assert_allclose(port[i], ref, rtol=2e-6, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    P = prepared_batch(True, False)
    u0, v0 = _cold_state(P)
    op = _port_operands([reference_args(P, 0, u0, v0, 1.0, 4.0, 0.0)], P)
    with pytest.raises(ValueError, match="CUDA"):
        dr.ladder_cuda(op, cones.cone_operands(cones.ConeSpec(**SPEC)),
                       torch.ones((1,), dtype=torch.int32), probe=8, psi=1.0,
                       woodbury=True)
