"""The CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use) and skips without a card.  The file imports no JAX, so it
runs on a machine that has none, from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

K1 (LP delta chunk): anchors from the port's own f64 setup of
numpy-seeded smoke LPs, advanced by absolute f64 ADMM steps
(`chip_smoke.mid_solve_state`).  K2 (conic ladder) and K3 (conic delta
chunk): the cases and tolerances of `chip_smoke.ladder_parity` and
`chip_smoke.delta_parity`, on instances of the JAX-free
`chip_smoke.randcone`.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from abip_tpu_torch.ops import admm_delta as delta  # noqa: E402
from abip_tpu_torch.ops import conic_delta, conic_dr  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_rand,B", [(50, 1950, 4), (37, 374, 3)])
def test_kernel_matches_plain_on_card(cuda_device, m, n_rand, B):
    """T=64, thresh=0: equal t_done, and every output within the
    tolerance `chip_smoke.compare` states (rtol 2e-5 plus 1e-5 of the
    output's largest magnitude: both versions reduce in f32, in other
    orders)."""
    _, stacks = chip_smoke.smoke_batch(700, B, m=m, n_rand=n_rand)
    S, u, v = chip_smoke.mid_solve_state(torch, stacks, cuda_device)
    anc = chip_smoke.make_anchor(torch, S, u, v, 0.0)
    t_max = torch.full((B,), 64, dtype=torch.int32, device=cuda_device)
    ker = delta.delta_chunk_cuda(anc, t_max, 8)
    plain = delta._delta_compute(anc, t_max, 8)
    torch.cuda.synchronize()
    assert ker[6][:, 5].tolist() == plain[6][:, 5].tolist() == [64.0] * B
    chip_smoke.compare(ker, plain, f"m={m} n={m + n_rand}")


@pytest.mark.cuda
def test_kernel_refuses_shape_beyond_shared_memory(cuda_device):
    """n=60,000 needs more shared memory per block than the card has:
    the wrapper raises instead of launching."""
    B, m, n = 1, 1, 60_000
    z = {name: torch.zeros((B, m if name in delta._M_FIELDS else n),
                           dtype=torch.float32, device=cuda_device)
         for name in delta.DeltaAnchor._fields}
    z["scal"] = torch.zeros((B, delta.N_SCAL), device=cuda_device)
    z["A"] = torch.zeros((B, m, n), device=cuda_device)
    z["Ninv"] = torch.zeros((B, m, m), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        delta.delta_chunk_cuda(delta.DeltaAnchor(**z),
                               torch.ones((B,), dtype=torch.int32), 8)


@pytest.mark.cuda
def test_solve_on_card_goes_through_kernel(cuda_device):
    """A batch solved on CUDA tensors runs its chunks in the kernel, and
    each lane's objective agrees with scipy's HiGHS to 1e-5 relative."""
    from scipy.optimize import linprog

    from abip_tpu_torch.parallel.batched import solve_lp_batch

    data, stacks = chip_smoke.smoke_batch(800, 3, m=20, n_rand=180)
    delta.delta_chunk_cuda.launches = 0
    res = solve_lp_batch(*stacks, device=cuda_device,
                         **dict(chip_smoke.SOLVE_KW, qres_period=256))
    assert delta.delta_chunk_cuda.launches > 0
    assert res.status.tolist() == [1, 1, 1]
    for (A, b, c), pobj in zip(data, res.pobj.cpu().numpy()):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        assert abs(pobj - ref.fun) < 1e-5 * (1 + abs(ref.fun))


# the smoke's cases, plus a cone with no blocks at all and n > 1024
# (several columns per thread)
CONIC_CASES = chip_smoke.CONIC_CASES + (
    ("LP cone B=3", dict(seed0=80, count=3, m=10, spec=dict(nonneg=40))),
    ("wide n=1500 B=2", dict(seed0=90, count=2, m=400, spec=dict(
        soc=(600, 600), rsoc=(50,), nonneg=250))))
CASE_IDS = ["dim1020-woodbury", "small-primal-diagQ", "lp-cone",
            "wide-n1500"]
# 150 cone blocks, more than the 32 warps of a thread block walk at once
MANY_BLOCKS = dict(seed0=70, count=3, m=80, spec=dict(
    soc=(3,) * 60 + (9,) * 15, rsoc=(3,) * 60 + (5,) * 15, nonneg=20))


@pytest.mark.cuda
@pytest.mark.parametrize("label,case", CONIC_CASES, ids=CASE_IDS)
def test_ladder_kernel_matches_plain_on_card(cuda_device, label, case):
    """K2 on phase 1 from the cold start: equal t_done, stages and mu,
    the tolerance `chip_smoke.compare_conic` states, and at most 3x the
    plain version's distance from an f64 run."""
    chip_smoke.ladder_parity(torch, cuda_device, label, case)


@pytest.mark.cuda
@pytest.mark.parametrize("label,case", CONIC_CASES, ids=CASE_IDS)
def test_conic_delta_kernel_matches_plain_on_card(cuda_device, label, case):
    """K3 on the state phase 1 hands to the endgame: T=64 at thresh=0,
    then thresholds that stop lanes mid-chunk (t_done within a probe)."""
    chip_smoke.delta_parity(torch, cuda_device, label, case)


@pytest.mark.cuda
def test_conic_kernels_refuse_shapes_beyond_shared_memory(cuda_device):
    """15,000 two-element SOC blocks (n=30,000) need more shared memory
    per block than the card has: both wrappers raise instead of
    launching."""
    from abip_tpu_torch.cones import ConeSpec, cone_operands

    spec = ConeSpec(soc=(2,) * 15_000)
    co = cone_operands(spec, cuda_device)
    B, m, n = 1, 1, spec.dim
    f32 = torch.float32

    def zeros(names, m_names, extra):
        out = {k: torch.zeros((B, m if k in m_names else n), dtype=f32,
                              device=cuda_device) for k in names}
        out.update({k: torch.zeros(shape, dtype=f32, device=cuda_device)
                    for k, shape in extra.items()})
        return out

    t_max = torch.ones((B,), dtype=torch.int32, device=cuda_device)
    lad = conic_dr.LadderOperands(**zeros(
        conic_dr.LadderOperands._fields, conic_dr._LADDER_M,
        dict(scal=(B, conic_dr.N_LADDER_SCAL), A=(B, m, n), Minv=(B, m, m))))
    with pytest.raises(ValueError, match="shared memory"):
        conic_dr.ladder_cuda(lad, co, t_max, probe=8, psi=1.0, woodbury=True)
    anc = conic_delta.ConicDeltaAnchor(**zeros(
        conic_delta.ConicDeltaAnchor._fields, conic_delta._DELTA_M,
        dict(scal=(B, conic_delta.N_DELTA_SCAL), A=(B, m, n),
             Minv=(B, m, m))))
    with pytest.raises(ValueError, match="shared memory"):
        conic_delta.conic_delta_cuda(anc, co, t_max, probe=8, woodbury=True)


@pytest.mark.cuda
def test_conic_solve_on_card_goes_through_both_kernels(cuda_device):
    """A small batch solved on CUDA tensors runs phase 1 in K2 and the
    endgame in K3; every lane is solved within 2e-5 of its known
    optimum."""
    cones, stacks, stars = chip_smoke.conic_batch(
        308, count=4, spec=chip_smoke.SMALL_SPEC, m=7)
    conic_dr.ladder_cuda.launches = 0
    conic_delta.conic_delta_cuda.launches = 0
    res = chip_smoke.solve_conic(torch, cones, stacks, cuda_device)
    assert conic_dr.ladder_cuda.launches > 0
    assert conic_delta.conic_delta_cuda.launches > 0
    assert res.status.tolist() == [1, 1, 1, 1]
    assert abs(res.pobj.cpu().numpy() - stars).max() < 2e-5


@pytest.mark.cuda
def test_kernels_walk_many_cone_blocks(cuda_device):
    """One iteration of each kernel on 150 cone blocks against its plain
    version, at the tolerance of `chip_smoke.compare_conic`: K2 from the
    cold start, K3 from the state phase 1 leaves.  (Over many iterations
    such small blocks sit near their cones' boundaries, where the
    reference's f32 prox formulas cancel and any two f32 versions drift
    apart; ROADMAP.md queue 3.)"""
    from abip_tpu_torch.cones import cone_operands

    cones, stacks, _ = chip_smoke.conic_batch(**MANY_BLOCKS)
    P = chip_smoke.conic_prepared(torch, cones, stacks, cuda_device)
    co = cone_operands(cones, cuda_device)
    assert co.start.numel() == 150
    wb = P.dss.form == "woodbury"
    one = torch.ones((P.A.shape[0],), dtype=torch.int32, device=cuda_device)
    op = chip_smoke.cold_ladder_operands(torch, P, cones)
    run = dict(probe=1, psi=1.0, woodbury=wb)
    chip_smoke.compare_conic(conic_dr.ladder_cuda(op, co, one, **run),
                             conic_dr._dr_ladder_compute(op, co, one, **run),
                             ("y", "x", "vy", "vx", "row"), "K2 many blocks")
    st = chip_smoke.conic_phase1_state(torch, P, cones)
    anc = chip_smoke.conic_anchor(torch, P, cones, st, 0.0)
    run = dict(probe=1, woodbury=wb)
    chip_smoke.compare_conic(
        conic_delta.conic_delta_cuda(anc, co, one, **run),
        conic_delta._conic_delta_compute(anc, co, one, **run),
        ("dy", "dx", "dvy", "dvx", "row"), "K3 many blocks")
