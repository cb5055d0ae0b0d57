"""The frozen copies: the generators, the reference and the bound."""
import numpy as np
import pytest
import torch

from portbench import reference, roofline
from portbench.generators import randcone, smoke_lp
from portbench.tests.cases import TINY_CONIC, configurations

CONES = TINY_CONIC["cones"]
TINY_LP = configurations()["smoke_lp"]["tiny"]
TINY_CONES = TINY_CONIC["tiny"]["cones"]


@pytest.mark.parametrize("gen,params", [(smoke_lp, TINY_LP["params"]),
                                        (randcone,
                                         TINY_CONIC["tiny"]["params"])])
def test_generators_repeat_for_a_seed(gen, params):
    a, b, c = (gen.make(params, s) for s in ([5, 1, 2], [5, 1, 2], [5, 1, 3]))
    for key in ("A", "b", "c"):
        assert np.array_equal(a[key], b[key])
    assert not np.array_equal(a["A"], c["A"])


def test_smoke_lp_matches_its_origin_shape():
    inst = smoke_lp.make({"m": 50, "n_rand": 1950, "density": 0.3}, 0)
    assert inst["A"].shape == (50, 2000)
    assert np.array_equal(inst["A"][:, 1950:], np.eye(50))


def test_randcone_optimum_is_certified():
    inst = randcone.make(TINY_CONIC["params"], [7, 1, 0])
    A, b, c, x, y, s = (inst[k] for k in "Abcxys")
    assert np.abs(A @ x - b).max() < 1e-12
    assert np.abs(A.T @ y + s - c).max() < 1e-12
    assert abs(x @ s) < 1e-9
    assert abs(c @ x - inst["optimum"]) < 1e-9
    X, S = (torch.as_tensor(v)[None] for v in (x, s))
    assert reference.cone_violation(X, CONES).item() < 1e-12
    assert reference.cone_violation(S, CONES).item() < 1e-12


def _stack(insts):
    return (torch.as_tensor(np.stack([d[k] for d in insts]),
                            dtype=torch.float64) for k in ("A", "b", "c"))


def test_reference_reaches_the_known_conic_optimum():
    insts = [randcone.make(TINY_CONIC["tiny"]["params"], [3, 1, i])
             for i in range(4)]
    A, b, c = _stack(insts)
    r = reference.solve(A, b, c, TINY_CONES, 1e-9)
    assert bool((r.status == 1).all())
    opt = torch.tensor([d["optimum"] for d in insts], dtype=torch.float64)
    got = reference.judge(A, b, c, TINY_CONES, r.x, r.y, r.s, opt)
    assert got["objective"].max() < 1e-7
    assert got["cone"].max() < 1e-12


def test_reference_matches_highs_on_the_lp():
    from scipy.optimize import linprog

    insts = [smoke_lp.make(TINY_LP["params"], [4, 1, i]) for i in range(3)]
    A, b, c = _stack(insts)
    r = reference.solve(A, b, c, TINY_LP["cones"], 1e-9)
    assert bool((r.status == 1).all())
    for d, x in zip(insts, r.x):
        ref = linprog(d["c"], A_eq=d["A"], b_eq=d["b"], bounds=(0, None),
                      method="highs")
        assert abs(d["c"] @ x.numpy() - ref.fun) < 1e-6 * (1 + abs(ref.fun))


def test_nesterov_todd_scaling():
    bl = reference.blocks(TINY_CONES)
    g = torch.Generator().manual_seed(0)
    x, s = (torch.rand(3, 19, generator=g, dtype=torch.float64) + 0.1
            for _ in range(2))
    for v in (x, s):
        for off, d in bl.soc:
            v[:, off] = v[:, off + 1:off + d].norm(dim=-1) + 0.5
    W = reference._nt(x, s, bl)
    lam = reference._apply_w(W, x, bl)
    assert torch.allclose(lam, reference._apply_w(W, s, bl, inverse=True))


def test_bound_of_a_full_chunk():
    """0.185 ms for K1's T=1536 chunk at B=16, m=50, n=2000 and 0.389 ms
    for K3's T=512 chunk at B=16, dim-1020 (PERF.md's kernel table)."""
    k1, what = roofline.bound_ms(16 * roofline.lane_bytes(50, 2000),
                                 16 * 1536 * roofline.lp_delta_flops(50, 2000),
                                 "f32")
    assert round(k1, 3) == 0.185 and what == "operations"
    k3, what = roofline.bound_ms(16 * roofline.lane_bytes(340, 1020),
                                 16 * 512 * roofline.conic_dr_flops(340, 1020),
                                 "f32")
    assert round(k3, 3) == 0.389 and what == "operations"


def test_device_rate_reads_the_window_busy_time():
    from types import SimpleNamespace

    from portbench import readers, trace

    assert trace._merge([(5, 9), (0, 2), (1, 3), (9, 10)]) == [[0, 3],
                                                                [5, 10]]
    ans = [{"status": np.array([1, 1, 0, 1])}, {"status": np.array([1] * 4)}]
    rec = SimpleNamespace(answers=ans, walls=[1.0, 1.0], window_busy_s=0.5)
    assert readers.instances_per_device_s(rec) == 14.0
    assert readers.instances_per_s(rec) == 3.5
    assert readers.instances_per_device_s(
        SimpleNamespace(**(vars(rec) | {"window_busy_s": None}))) is None
