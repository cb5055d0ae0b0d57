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
