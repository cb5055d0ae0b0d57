"""`abip_tpu_torch.cones` against `abip_tpu.cones`.

Same numpy-seeded inputs through both: the layout arrays must be equal,
and the f64 barrier prox must agree to 1e-12 (f64 code in both; only the
order of the block sums differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import cones as jcones  # noqa: E402
from abip_tpu_torch import cones  # noqa: E402
from abip_tpu_torch.cones import cone_operands  # noqa: E402

SPECS = [
    dict(soc=(1, 4), rsoc=(5,), free=2, zero=2, nonneg=3),  # 1-d SOC, all kinds
    dict(soc=(3, 6), rsoc=(3, 4), nonneg=5),
    dict(rsoc=(7,), free=3),
    dict(nonneg=6, zero=1),                                 # no blocks
    dict(soc=(125, 125), rsoc=(20,), nonneg=750),           # the dim-1020 spec
]


@pytest.mark.parametrize("spec", SPECS)
def test_layout_matches_reference(spec):
    lay, ref = cones.ConeLayout(cones.ConeSpec(**spec)), jcones.ConeLayout(
        jcones.ConeSpec(**spec))
    for name in ("kind", "seg", "head", "block_start"):
        np.testing.assert_array_equal(getattr(lay, name), getattr(ref, name),
                                      err_msg=name)
    for name in ("n", "num_blocks", "has_blocks", "has_soc", "has_rsoc"):
        assert getattr(lay, name) == getattr(ref, name), name
    np.testing.assert_array_equal(lay.interior_point().numpy(),
                                  np.asarray(ref.interior_point(jnp.float64)))
    e = np.random.default_rng(3).random((2, lay.n)) + 0.1
    tied = lay.segment_mean_tie(torch.from_numpy(e)).numpy()
    for i in range(2):
        np.testing.assert_allclose(tied[i], np.asarray(ref.segment_mean_tie(
            jnp.asarray(e[i]))), rtol=1e-14)


@pytest.mark.parametrize("spec", SPECS)
def test_cone_operands_describe_the_layout(spec):
    """The kernels' per-element classes and per-block rows encode the
    same structure as the layout: heads at the block starts, block
    lengths summing to the SOC/RSOC elements, 1-d SOC as nonneg."""
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    co = cone_operands(cones.ConeSpec(**spec))
    code, start, length = co.code.numpy(), co.start.numpy(), co.length.numpy()
    assert (code[start] == np.where(co.soc.numpy() > 0, 3, 5)).all()
    in_blk = (lay.kind == cones._SOC) | (lay.kind == cones._RSOC)
    assert length.sum() == in_blk.sum()
    assert ((code >= 3) == in_blk).all()
    assert ((code == 0) == (lay.kind == cones._NONNEG)).all()
    for k, (s, q) in enumerate(zip(start, length)):
        assert (co.blk.numpy()[s:s + q] == k).all()


def _prox_inputs(lay, B, seed):
    """Random prox arguments with every branch represented: tiny SOC
    heads (|a| <= 1e-9), negative heads, an RSOC block with
    zeta_eta + zeta_nu == 0 (the degenerate branch), per-element lam."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((B, lay.n))
    lam = 10.0 ** rng.uniform(-6, -1, (B, lay.n))
    heads = np.flatnonzero(lay.head == 1)
    if heads.size:
        t[0, heads[0]] = 3e-10
        t[1 % B, heads] = -np.abs(t[1 % B, heads])
        rs = heads[lay.kind[heads] == cones._RSOC]
        if rs.size:
            t[0, rs[0] + 1] = -t[0, rs[0]]
    return t, lam


@pytest.mark.parametrize("spec", SPECS)
def test_cone_barrier_prox_matches_reference(spec):
    """1e-12 relative (plus 1e-12 absolute) over every cone class."""
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    ref = jcones.ConeLayout(jcones.ConeSpec(**spec))
    t, lam = _prox_inputs(lay, 3, seed=11)
    port = cones.cone_barrier_prox(torch.from_numpy(t), torch.from_numpy(lam),
                                   lay).numpy()
    assert np.isfinite(port).all()
    for i in range(t.shape[0]):
        r = np.asarray(jcones.cone_barrier_prox(jnp.asarray(t[i]),
                                                jnp.asarray(lam[i]), ref))
        np.testing.assert_allclose(port[i], r, rtol=1e-12, atol=1e-12)


def test_cone_barrier_prox_scalar_lambda_broadcasts():
    """A per-lane `(B, 1)` lambda acts as that lambda on every element."""
    spec = cones.ConeSpec(**SPECS[1])
    lay = cones.ConeLayout(spec)
    t, _ = _prox_inputs(lay, 2, seed=5)
    lam = np.array([[1e-3], [1e-5]])
    a = cones.cone_barrier_prox(torch.from_numpy(t), torch.from_numpy(lam),
                                lay)
    b = cones.cone_barrier_prox(torch.from_numpy(t), torch.from_numpy(
        np.broadcast_to(lam, t.shape).copy()), lay)
    assert torch.equal(a, b)


def test_cone_spec_validation():
    with pytest.raises(ValueError):
        cones.ConeSpec(rsoc=(2,))
    with pytest.raises(ValueError):
        cones.ConeSpec(soc=(0,))
    with pytest.raises(ValueError):
        cones.ConeSpec(nonneg=3).validate_dim(4)
    assert cones.ConeSpec.lp(4) == cones.ConeSpec(nonneg=4)
