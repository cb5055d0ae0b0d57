"""`abip_tpu_torch.scaling` against `abip_tpu.scaling` (LP part).

The port equilibrates a `(B, m, n)` stack; the reference runs lane by
lane on the same numpy-seeded data.  Below 2^18 elements per lane the
factor loops run in f64 on both sides and agree to 1e-12 (summation
order only).  At and above it both run them in f32, where the order of
the reductions shows at about 1e-6, so the tolerance there is 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import scaling as jscaling  # noqa: E402
from abip_tpu.settings import Settings as JSettings  # noqa: E402
from abip_tpu_torch import scaling  # noqa: E402
from abip_tpu_torch.settings import Settings  # noqa: E402
from bench import reference_smoke_lp  # noqa: E402
from conftest import random_lp  # noqa: E402

_VARIANTS = {
    "default": {},
    "origin": dict(origin_rescale=True),
    "qp": dict(qp_rescale=True),
    "scaled": dict(scale=2.5, ruiz_iter=4),
    "off": dict(pc_ruiz_rescale=False),
}


def _compare(problems, stg_kw, rtol, atol):
    As = np.stack([p[0] for p in problems])
    bs = np.stack([p[1] for p in problems])
    cs = np.stack([p[2] for p in problems])
    stg = Settings(**stg_kw)
    A_s, sd = scaling.equilibrate(torch.as_tensor(As), stg)
    b_s, c_s, sc_b, sc_c = scaling.normalize_bc(
        sd, torch.as_tensor(bs), torch.as_tensor(cs), stg.scale)
    port = dict(A=A_s, D=sd.D, E=sd.E, mean_norm_row=sd.mean_norm_row,
                mean_norm_col=sd.mean_norm_col, b=b_s, c=c_s, sc_b=sc_b,
                sc_c=sc_c)
    jstg = JSettings(**stg_kw)
    for i in range(len(problems)):
        jA, jsd = jscaling.equilibrate(jnp.asarray(As[i]), jstg)
        jb, jc, jsb, jsc = jscaling.normalize_bc(
            jsd, jnp.asarray(bs[i]), jnp.asarray(cs[i]), jstg.scale)
        ref = dict(A=jA, D=jsd.D, E=jsd.E, mean_norm_row=jsd.mean_norm_row,
                   mean_norm_col=jsd.mean_norm_col, b=jb, c=jc, sc_b=jsb,
                   sc_c=jsc)
        for k, r in ref.items():
            np.testing.assert_allclose(port[k][i].numpy(), np.asarray(r),
                                       rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_equilibrate_random_lp(variant):
    rng = np.random.default_rng(3)
    probs = [random_lp(rng, m=20, n=60, density=d) for d in (1.0, 0.3, 0.1)]
    _compare(probs, _VARIANTS[variant], 1e-12, 1e-14)


def test_equilibrate_smoke_shape():
    """The main path's shape (m=50, n=2000: 100,000 elements, f64 factor
    loops)."""
    probs = [reference_smoke_lp(seed=s) for s in (0, 1)]
    _compare(probs, {}, 1e-12, 1e-14)


def test_equilibrate_f32_factor_loops():
    """m=128, n=2048 is exactly 2^18 elements: the factor loops run in
    f32 on both sides."""
    probs = [reference_smoke_lp(m=128, n_rand=1920, seed=s) for s in (2, 3)]
    assert scaling._factor_dtype(torch.zeros((1, 128, 2048),
                                             dtype=torch.float64)) \
        == torch.float32
    _compare(probs, {}, 1e-5, 1e-12)


def test_clip_col_guards():
    e = np.array([[0.0, 1e-6, 0.5, 1e5, 1e9]])
    port = scaling._clip_col(torch.as_tensor(e), 100)
    ref = jscaling._clip_col(jnp.asarray(e), 100)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-15)


@pytest.mark.parametrize("variant", ["default", "scaled", "off"])
def test_equilibrate_sparse(variant):
    """The host LP driver's scipy equilibration: the same f64 scipy
    passes as the reference's, so the scaled matrix and the factors agree
    to 1e-14."""
    import scipy.sparse as sp

    A, _, _ = reference_smoke_lp(m=12, n_rand=90, density=0.2, seed=4)
    kw = _VARIANTS[variant]
    A_p, sd_p = scaling.equilibrate_sparse(sp.csr_matrix(A), Settings(**kw))
    A_r, sd_r = jscaling.equilibrate_sparse(sp.csr_matrix(A),
                                            JSettings(**kw))
    np.testing.assert_allclose(A_p.toarray(), A_r.toarray(), rtol=1e-14,
                               atol=1e-15)
    for p, r in zip(sd_p, sd_r):
        assert p.dtype == torch.float64
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-14)
