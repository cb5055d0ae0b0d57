"""`abip_tpu_torch.crossover` against `abip_tpu.crossover`.

The port's crossover is a numpy copy of the reference's, so from the
same interior point both give the same basis and the same vertex, bit
for bit.  From the port's own interior points (`solve_lp` and
`solve_lp_pdhg` on the CPU; the instances of `tests/test_crossover.py`)
the vertex is certified optimal and equals the reference's: the same
basis, x and y within 1e-9 of their scale.
"""
import numpy as np
import pytest
from scipy.optimize import linprog

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import abip_tpu  # noqa: E402
import abip_tpu_torch  # noqa: E402
from abip_tpu.crossover import crossover as jcrossover  # noqa: E402
from abip_tpu_torch.crossover import crossover  # noqa: E402


def random_lp(seed, m=25, n=80):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_crossover_equals_reference(seed):
    A, b, c = random_lp(seed)
    ref_sol = abip_tpu.solve_lp(A, b, c, eps=1e-6)
    ref = jcrossover(A, b, c, ref_sol.x)
    same = crossover(A, b, c, ref_sol.x)
    np.testing.assert_array_equal(same.basis, ref.basis)
    np.testing.assert_array_equal(same.x, ref.x)
    np.testing.assert_array_equal(same.y, ref.y)
    assert (same.pobj, same.optimal) == (ref.pobj, ref.optimal)

    sol = abip_tpu_torch.solve_lp(A, b, c, eps=1e-6, device="cpu")
    cr = crossover(A, b, c, sol.x)
    hs = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    assert cr.optimal and ref.optimal
    np.testing.assert_array_equal(cr.basis, ref.basis)
    np.testing.assert_allclose(cr.x, ref.x, rtol=0,
                               atol=1e-9 * np.abs(ref.x).max())
    np.testing.assert_allclose(cr.y, ref.y, rtol=0,
                               atol=1e-9 * np.abs(ref.y).max())
    assert abs(cr.pobj - hs) < 1e-9 * (1 + abs(hs))
    assert cr.primal_feas < 1e-10
    assert len(np.unique(cr.basis)) == A.shape[0]


def test_crossover_from_port_pdhg():
    A, b, c = random_lp(7, 30, 90)
    sol = abip_tpu_torch.solve_lp_pdhg(A, b, c, eps=1e-6, device="cpu")
    ref = jcrossover(A, b, c, abip_tpu.solve_lp_pdhg(A, b, c, eps=1e-6).x)
    cr = crossover(A, b, c, sol.x)
    assert cr.optimal and ref.optimal
    np.testing.assert_array_equal(cr.basis, ref.basis)
    assert abs(cr.pobj - ref.pobj) < 1e-9 * (1 + abs(ref.pobj))
