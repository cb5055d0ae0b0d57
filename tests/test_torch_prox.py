"""`abip_tpu_torch.ops.prox` (the fused barrier step's plain version)
against `abip_tpu.ops.prox_pallas`, and the port's `ops` exports.

Away from the reference's guard fault (small negative prox arguments,
`tests/test_torch_admm_sprint.py`) the two agree to a few ulps: f64 to
1e-12 relative, f32 to 1e-6, plus that much of the inputs' largest
magnitude absolute, since v + u_new - rel cancels.  The CUDA kernel is
held to the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import abip_tpu.ops as jops  # noqa: E402
from abip_tpu.ops import prox_pallas as jpp  # noqa: E402
from abip_tpu_torch import hsd  # noqa: E402
from abip_tpu_torch import ops  # noqa: E402
from abip_tpu_torch.ops import prox  # noqa: E402

TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _inputs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(n) for _ in range(3)]
    return x, [torch.tensor(a, dtype=dtype) for a in x]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("lam,alpha", [(0.01, 1.8), (1e-6, 1.0), (3.0, 1.5)])
def test_barrier_step_matches_reference(dtype, lam, alpha):
    """The plain version and the CPU entry against the reference's
    `_ref_impl` and its Pallas body in interpret mode, n = 1000."""
    x, t = _inputs(1000, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    atol = TOL[dtype] * max(np.abs(a).max() for a in x)
    ref = jpp._ref_impl(*(jnp.asarray(a, jdt) for a in x), lam, alpha)
    for port in (prox._ref_impl(*t, lam, alpha),
                 prox.fused_barrier_step(*t, lam, alpha)):
        for p, r in zip(port, ref):
            assert p.dtype == dtype
            np.testing.assert_allclose(p.double().numpy(),
                                       np.asarray(r, np.float64),
                                       rtol=TOL[dtype], atol=atol)
    if dtype == torch.float32:
        pal = jpp.fused_barrier_step(*(jnp.asarray(a, jdt) for a in x), lam,
                                     alpha, interpret=True)
        for p, r in zip(port, pal):
            np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                       rtol=TOL[dtype], atol=atol)
    assert (port[0] > 0).all()


def test_barrier_step_agrees_with_admm_update():
    """The step's math equals `hsd.admm_update` on the tail block
    (`tests/test_ops.py:50-64`)."""
    m, n = 5, 20
    rng = np.random.default_rng(1)
    u, v, u_t = (torch.tensor(rng.standard_normal(m + n + 1))
                 for _ in range(3))
    u_new, v_new = hsd.admm_update(u, v, u, u_t, 0.1, 1.8, m)
    u_k, v_k = prox.fused_barrier_step(u_t[m:], u[m:], v[m:], 0.1, 1.8)
    np.testing.assert_allclose(u_k.numpy(), u_new[m:].numpy(), rtol=1e-12)
    np.testing.assert_allclose(v_k.numpy(), v_new[m:].numpy(), rtol=1e-12)


def test_ops_exports_match_the_reference():
    assert set(ops.__all__) == set(jops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name))


def test_cuda_wrapper_refuses_cpu_tensors():
    _, t = _inputs(8, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        prox.barrier_step_cuda(*t, 0.1, 1.8)


# -- the kernel's launch plan (`prox.step_plan`) ------------------------------

SMS, RESIDENT = 132, 8      # an H100's SMs; blocks of 256 threads an SM holds
BASE = 0x7F00_0000_0000     # a 16-byte aligned address


def _covered(plan, n):
    """Every element's count of visits by the head, body and tail."""
    seen = np.zeros(n, dtype=int)
    seen[:plan.head] += 1
    seen[plan.head:plan.head + plan.body] += 1
    seen[plan.head + plan.body:] += 1
    return seen, plan.head + plan.body + plan.tail


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1_237, 32_000, 2 ** 24])
@pytest.mark.parametrize("itemsize,offset", [(4, 0), (4, 1), (4, 2), (4, 3),
                                             (8, 0), (8, 1)],
                         ids=["f32+0", "f32+1", "f32+2", "f32+3", "f64+0",
                              "f64+1"])
def test_step_plan_covers_each_element_once(n, itemsize, offset):
    """Head, body and tail cover n elements exactly once; the body starts
    16 bytes aligned in all five operands and holds whole vectors; the
    head and the tail are shorter than one vector; the grid is at most one
    wave of resident blocks and gives every vector and scalar a thread."""
    addr = BASE + offset * itemsize
    plan = prox.step_plan(n, itemsize, [addr] * 5, SMS, RESIDENT)
    seen, total = _covered(plan, n)
    assert total == n and (seen == 1).all()
    assert plan.body % plan.vec == 0
    if plan.vec > 1:
        assert plan.vec * itemsize == prox.VEC_BYTES
        assert (addr + plan.head * itemsize) % prox.VEC_BYTES == 0
        assert plan.head < plan.vec and plan.tail < plan.vec
    else:
        assert (plan.head, plan.body, plan.tail) == (0, n, 0)
        # only where no whole vector fits after the head
        assert n < 2 * prox.VEC_BYTES // itemsize
    assert plan.blocks <= SMS * RESIDENT
    work = max(plan.body // plan.vec, plan.head, plan.tail)
    assert (plan.blocks == 0) == (n == 0)
    assert plan.blocks == min(-(-work // prox.THREADS), SMS * RESIDENT)
    if n == 2 ** 24:
        assert plan.vec == prox.VEC_BYTES // itemsize
        assert plan.blocks == SMS * RESIDENT


@pytest.mark.parametrize("itemsize", [4, 8])
def test_step_plan_scalar_where_operands_disagree(itemsize):
    """Operands at different addresses modulo 16 bytes (an input view at
    an offset beside an aligned one) take the scalar form of the kernel,
    every element in the body."""
    n = 1_237
    addrs = [BASE, BASE + itemsize, BASE, BASE, BASE]
    plan = prox.step_plan(n, itemsize, addrs, SMS, RESIDENT)
    assert plan == prox.StepPlan(1, 0, n, 0, -(-n // prox.THREADS))


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0),
                                          (torch.float32, 1),
                                          (torch.float32, 3),
                                          (torch.float64, 1)])
def test_outputs_share_the_inputs_alignment(dtype, offset):
    """The wrapper's outputs start where a view at `offset` does modulo
    16 bytes, so a view keeps the vector body."""
    x = torch.zeros(64, dtype=dtype)[offset:offset + 37]
    out = prox._output_like(x)
    assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
    assert (out.data_ptr() - x.data_ptr()) % prox.VEC_BYTES == 0
