"""The CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use) and skips without a card.  The file imports no JAX, so it
runs on a machine that has none, from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

K1 (LP delta chunk), K6 and K7 (LP sprints), each one thread-block
cluster per lane: anchors and states from
the port's own f64 setup of numpy-seeded smoke LPs, advanced by absolute
f64 ADMM steps (`chip_smoke.mid_solve_state`).  K2 (conic ladder), K3
(conic delta chunk) and K4 (conic sprint), each one thread-block cluster
per lane too: the cases and tolerances of `chip_smoke.ladder_parity`,
`chip_smoke.delta_parity` and `chip_smoke.conic_sprint_parity`, on
instances of the JAX-free `tools.generate.randcone`, in every form their
plans take.  K8 (barrier step): `chip_smoke.phase_barrier_step`.  The
shape repair: each kernel's spilled form (its layout in a global
workspace, for shapes no shared memory holds) against the plain version,
batches solved with every kernel spilled (`device.limit_shared_memory`),
and a batch whose lane one block of the first K2 could not hold in
shared memory solved through the kernels (`chip_smoke.phase_repair`).
The host conic driver (no kernel of its own): `solve_qcp` on the card
against the port on the CPU, and the CLI's file functions on the card.
The rest of the single-card port (no kernel of its own; K1 through the
thread pool): the same-pattern sparse family driver deterministic on the
card, the lane-swap stream and the pool against serial solves, PDHG's
mixed products in IEEE f32, and the differentiable LP map and its
minimum-norm adjoint solve against the CPU.  The multi-card layer on a
one-rank NCCL group (`chip_smoke.one_rank_nccl`): the sharded dense LP
and the batch over the mesh against their unsharded runs, and a group
that cannot form failing, never falling back to gloo.
"""
import functools
import os

# cuBLAS picks its kernels per workspace; a fixed configuration keeps the
# thread pool's concurrent streams on the same ones, and lets the
# deterministic mode of PyTorch run cuBLAS products
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from abip_tpu_torch.device import limit_shared_memory  # noqa: E402
from abip_tpu_torch.ops import admm_delta as delta  # noqa: E402
from abip_tpu_torch.ops import conic_delta, conic_dr  # noqa: E402
from abip_tpu_torch.tools.generate import randcone, randqcp  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_rand,B,cluster", [
    (50, 1950, 4, None), (37, 374, 3, None), (200, 2800, 2, None),
    (50, 1950, 2, 4), (50, 1950, 2, 16), (50, 1950, 2, "spill"),
    (37, 374, 3, "spill")],
    ids=["smoke", "ragged", "L2-streaming", "smoke-C4", "smoke-C16",
         "smoke-spill", "ragged-spill"])
def test_kernel_matches_plain_on_card(cuda_device, m, n_rand, B, cluster):
    """T=64, thresh=0: equal t_done, and every output within the
    tolerance `chip_smoke.compare` states (rtol 2e-5 plus 1e-5 of the
    output's largest magnitude: both versions reduce in f32, in other
    orders), for the plan's cluster (resident, or at m=200 n=3000 with A
    and Ninv read through L2), for resident plans of other cluster
    sizes, as the smoke times them, and spilled."""
    _, stacks = chip_smoke.smoke_batch(700, B, m=m, n_rand=n_rand)
    S, u, v = chip_smoke.mid_solve_state(torch, stacks, cuda_device)
    anc = chip_smoke.make_anchor(torch, S, u, v, 0.0)
    assert delta.delta_launch_plan(m, m + n_rand).resident == (m != 200)
    t_max = torch.full((B,), 64, dtype=torch.int32, device=cuda_device)
    if cluster == "spill":
        plan = delta.DeltaPlan(delta.CLUSTER, False, 0, spill=True)
    else:
        plan = cluster and delta.DeltaPlan(cluster, True, delta.delta_smem_bytes(
            m, m + n_rand, cluster, True))
    ker = delta.delta_chunk_cuda(anc, t_max, 8, plan=plan)
    plain = delta._delta_compute(anc, t_max, 8)
    torch.cuda.synchronize()
    assert ker[6][:, 5].tolist() == plain[6][:, 5].tolist() == [64.0] * B
    chip_smoke.compare(ker, plain, f"m={m} n={m + n_rand}")


@pytest.mark.cuda
def test_kernel_refuses_shape_beyond_shared_memory(cuda_device):
    """m=15,000 needs more shared memory per CTA than the card has even
    with A streamed through L2 (the exchange buffers, 4 m floats): the
    wrapper refuses a shared-memory plan of that shape, and by its own
    plan launches the spilled form, which runs the chunk."""
    B, m, n = 1, 15_000, 1
    z = {name: torch.zeros((B, m if name in delta._M_FIELDS else n),
                           dtype=torch.float32, device=cuda_device)
         for name in delta.DeltaAnchor._fields}
    z["scal"] = torch.zeros((B, delta.N_SCAL), device=cuda_device)
    z["A"] = torch.zeros((B, m, n), device=cuda_device)
    z["Ninv"] = torch.zeros((B, m, m), device=cuda_device)
    anc, one = delta.DeltaAnchor(**z), torch.ones((B,), dtype=torch.int32)
    shared = delta.DeltaPlan(delta.CLUSTER, False, delta.delta_smem_bytes(
        m, n, delta.CLUSTER, False))
    with pytest.raises(ValueError, match="shared memory"):
        delta.delta_chunk_cuda(anc, one, 8, plan=shared)
    assert delta.delta_launch_plan(m, n).spill
    out = delta.delta_chunk_cuda(anc, one, 8)
    assert out[6][:, 5].tolist() == [8.0]


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


# K2's and K4's forms: A resident at C=8 (the plan at dim-1020) and C=7,
# streamed at C=6 and C=16, spilled at C=16; the smoke's two conic cases,
# whose blocks straddle CTAs in every form
DR_FORMS = ((8, True), (7, True), (6, False), (16, False), (16, "spill"))
DR_FORM_IDS = ["C8-A", "C7-A", "C6-stream", "C16-stream", "C16-spill"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("form", DR_FORMS, ids=DR_FORM_IDS)
@pytest.mark.parametrize("label,case", chip_smoke.CONIC_CASES,
                         ids=CASE_IDS[:2])
def test_dr_kernels_in_every_form(cuda_device, label, case, form, kernel):
    """K2 (phase 1 from the cold start: equal t_done, stages and mu) and
    K4 (T=64 from the cold start and at k0 = 64, then lanes stopped
    mid-chunk) in each form, against their plain versions at the stated
    tolerance and at most 3x the plain version's distance from an f64
    run."""
    from abip_tpu_torch.cones import ConeSpec, cone_operands

    spec = ConeSpec(**(case.get("spec") or chip_smoke.CONIC_SPEC))
    co = cone_operands(spec)
    spans, _ = conic_delta.cluster_block_spans(co.start, co.length, spec.dim,
                                               form[0])
    assert any(lo != hi for lo, hi in spans)
    check = chip_smoke.ladder_parity if kernel == "K2" else \
        chip_smoke.conic_sprint_parity
    check(torch, cuda_device, f"{label} C={form[0]}", case, form=form)


@pytest.mark.cuda
@pytest.mark.parametrize("label,case", CONIC_CASES, ids=CASE_IDS)
def test_conic_delta_kernel_matches_plain_on_card(cuda_device, label, case):
    """K3 on the state phase 1 hands to the endgame: T=64 at thresh=0,
    then thresholds that stop lanes mid-chunk (t_done within a probe)."""
    chip_smoke.delta_parity(torch, cuda_device, label, case)


# K3's forms: A resident at C=7 and C=8, A streamed at C=6 and at C=16,
# spilled at C=16; and a batch small enough for every form, n=600, whose
# blocks straddle CTAs in each
STRADDLE = dict(seed0=95, count=2, m=60, spec=dict(soc=(150, 150),
                                                   rsoc=(20,), nonneg=280))
K3_FORMS = ((7, True), (8, True), (6, False), (16, False), (16, "spill"))


@pytest.mark.cuda
@pytest.mark.parametrize("form", K3_FORMS,
                         ids=["C7-A", "C8-A", "C6-stream", "C16-stream",
                              "C16-spill"])
def test_conic_delta_kernel_forms_on_straddling_blocks(cuda_device, form):
    """K3 in each form on STRADDLE, whose SOC(150) blocks straddle two or
    three CTAs' columns in every form: the parity and mid-chunk stops of
    `chip_smoke.delta_parity`."""
    from abip_tpu_torch.ops.conic_delta import (cluster_block_spans,
                                                conic_delta_smem_bytes)
    from abip_tpu_torch.cones import ConeSpec, cone_operands

    co = cone_operands(ConeSpec(**STRADDLE["spec"]))
    spans, _ = cluster_block_spans(co.start, co.length, 600, form[0])
    assert max(hi - lo for lo, hi in spans) >= 1
    if form[1] == "spill":
        plan = delta.DeltaPlan(form[0], False, 0, spill=True)
    else:
        plan = delta.DeltaPlan(*form, conic_delta_smem_bytes(60, 600, 3, *form))
    chip_smoke.delta_parity(torch, cuda_device, f"straddling C={form[0]}",
                            STRADDLE, plan=plan)


@pytest.mark.cuda
def test_repair_solves_what_the_kernels_refuse(cuda_device):
    """A conic batch whose lane one block of the first K2 could not hold
    in shared memory (`chip_smoke.REPAIR_SPEC`, n=14,500; 6 m + 4 n + 3 nb
    floats) solved on the card: phase 1 runs K2 in the form of its plan,
    A streamed through L2 at C=6 (no CTA holds A's slice of 14,500
    columns); every lane ends as the CPU (plain) solve ends, Solved, with
    objectives within 1e-5 relative."""
    from abip_tpu_torch.device import smem_optin
    from abip_tpu_torch.ops.conic_dr import dr_launch_plan, ladder_cuda

    cones, stacks, stars = chip_smoke.conic_batch(
        chip_smoke.REPAIR_SEED, count=2, spec=chip_smoke.REPAIR_SPEC,
        m=chip_smoke.REPAIR_M)
    nb = len(cones.soc) + len(cones.rsoc)
    m, n = chip_smoke.REPAIR_M, cones.dim
    assert 4 * (6 * m + 4 * n + 3 * nb) > smem_optin(cuda_device)
    plan = dr_launch_plan(m, n, nb, smem_optin(cuda_device))
    assert (plan.cluster, plan.resident, plan.spill) == (6, False, False)
    ladder_cuda.launches = 0
    card = chip_smoke.solve_conic(torch, cones, stacks, cuda_device)
    assert ladder_cuda.launches > 0
    cpu = chip_smoke.solve_conic(torch, cones, stacks, torch.device("cpu"))
    assert card.status.tolist() == cpu.status.tolist() == [1, 1]
    rel = abs(card.pobj.cpu().numpy() - cpu.pobj.numpy()) / abs(stars).clip(1)
    assert rel.max() < 1e-5


@pytest.mark.cuda
def test_conic_kernels_refuse_shapes_beyond_shared_memory(cuda_device):
    """Shapes beyond a CTA's shared memory: 15,000 two-element SOC blocks
    (n=30,000) exceed K3's streaming CTA, and a tall m=12,000 exceeds
    K2's (its replicated m-side state); each wrapper refuses a
    shared-memory plan of such a shape, and by its own plan spills and
    runs (K2 holds the 15,000 blocks with m=1 in a resident C=8 CTA)."""
    from abip_tpu_torch.cones import ConeSpec, cone_operands

    spec = ConeSpec(soc=(2,) * 15_000)
    co = cone_operands(spec, cuda_device)
    B, m, n = 1, 1, spec.dim
    f32 = torch.float32

    def zeros(names, m_names, extra, m=m, n=n):
        out = {k: torch.zeros((B, m if k in m_names else n), dtype=f32,
                              device=cuda_device) for k in names}
        out.update({k: torch.zeros(shape, dtype=f32, device=cuda_device)
                    for k, shape in extra.items()})
        return out

    def ladder_ops(m, n):
        return conic_dr.LadderOperands(**zeros(
            conic_dr.LadderOperands._fields, conic_dr._LADDER_M,
            dict(scal=(B, conic_dr.N_LADDER_SCAL), A=(B, m, n),
                 Minv=(B, m, m)), m, n))

    t_max = torch.ones((B,), dtype=torch.int32, device=cuda_device)
    run = dict(probe=8, psi=1.0, woodbury=True)
    assert conic_dr.dr_launch_plan(m, n, 15_000).resident
    out = conic_dr.ladder_cuda(ladder_ops(m, n), co, t_max, **run)
    assert out[4][:, 3].tolist() == [8.0]
    tall, co_nn = 12_000, cone_operands(ConeSpec(nonneg=10), cuda_device)
    lad = ladder_ops(tall, 10)
    shared = delta.DeltaPlan(16, False, conic_dr.dr_smem_bytes(
        tall, 10, 0, 16, False))
    with pytest.raises(ValueError, match="shared memory"):
        conic_dr.ladder_cuda(lad, co_nn, t_max, plan=shared, **run)
    assert conic_dr.dr_launch_plan(tall, 10, 0).spill
    out = conic_dr.ladder_cuda(lad, co_nn, t_max, **run)
    assert out[4][:, 3].tolist() == [8.0]
    del lad
    anc = conic_delta.ConicDeltaAnchor(**zeros(
        conic_delta.ConicDeltaAnchor._fields, conic_delta._DELTA_M,
        dict(scal=(B, conic_delta.N_DELTA_SCAL), A=(B, m, n),
             Minv=(B, m, m))))
    shared = delta.DeltaPlan(16, False, conic_delta.conic_delta_smem_bytes(
        m, n, 15_000, 16, False))
    with pytest.raises(ValueError, match="shared memory"):
        conic_delta.conic_delta_cuda(anc, co, t_max, probe=8, woodbury=True,
                                     plan=shared)
    assert conic_delta.conic_delta_launch_plan(m, n, 15_000).spill
    out = conic_delta.conic_delta_cuda(anc, co, t_max, probe=8,
                                       woodbury=True)
    assert out[4][:, 3].tolist() == [8.0]


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


# -- the host LP driver and K5 ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _spmv_cases():
    return dict(chip_smoke.spmv_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f64", "f32"])
@pytest.mark.parametrize("index", range(6))
def test_bcsr_kernel_matches_plain_on_card(cuda_device, index, kind):
    """K5 against its plain version (over the stored entries), the tile
    product and scipy's f64 product within the tolerance
    `chip_smoke.SPMV_TOL` states (1e-12 of |A||x| per row in f64, 1e-5 in
    f32), on each of `chip_smoke.spmv_cases` (the smoke instance's A and
    A', ragged shapes, rows whose lengths differ widely), with NaN in x's
    buffer past its end."""
    label, A = list(_spmv_cases().items())[index]
    chip_smoke.spmv_parity(torch, cuda_device, label, A, kind)


@pytest.mark.cuda
def test_host_lp_on_card_goes_through_bcsr_kernel(cuda_device):
    """`solve_lp` on a CSR A solved on the card launches K5 for its
    products and ends as the CPU solve of the port ends: the same status
    and IPM count, objectives within 1e-6 relative."""
    import scipy.sparse as sp

    from abip_tpu_torch import solve_lp
    from abip_tpu_torch.ops.spmv import bcsr_matvec_cuda
    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(m=20, n_rand=180, seed=3)
    A = sp.csr_matrix(A)
    bcsr_matvec_cuda.launches = 0
    card = solve_lp(A, b, c, eps=1e-6, device=cuda_device)
    assert bcsr_matvec_cuda.launches >= 4 * card.admm_iters
    cpu = solve_lp(A, b, c, eps=1e-6, device="cpu")
    assert card.status_name == cpu.status_name == "Solved"
    assert card.ipm_iters == cpu.ipm_iters
    assert abs(card.pobj - cpu.pobj) <= 1e-6 * abs(cpu.pobj)


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    """Called without `device`, the entry points run on the card."""
    import scipy.sparse as sp

    import abip_tpu_torch
    from abip_tpu_torch.ops.spmv import bcsr_matvec_cuda
    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(m=20, n_rand=180, seed=4)
    ws = abip_tpu_torch.LPWorkspace(sp.csr_matrix(A), b, c)
    assert ws.device.type == "cuda" and ws.ops.bcsr.vals.is_cuda
    bcsr_matvec_cuda.launches = 0
    assert abip_tpu_torch.solve_lp(sp.csr_matrix(A), b, c,
                                   eps=1e-4).status_name == "Solved"
    assert bcsr_matvec_cuda.launches > 0
    res = abip_tpu_torch.solve_lp_batch(
        A[None], b[None], c[None], **dict(chip_smoke.SOLVE_KW,
                                          qres_period=256))
    assert res.x.is_cuda and res.status.tolist() == [1]


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_host_lp_float32_on_card(cuda_device, sparse):
    """dtype="float32" on the card, with the caller's TF32 flag on: the
    driver's dense products stay IEEE f32 (the solve turns TF32 off and
    restores the flag), and the solve ends within 1e-3 of the f64 one."""
    import scipy.sparse as sp

    from abip_tpu_torch import solve_lp
    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(m=20, n_rand=180, seed=3)
    if sparse:
        A = sp.csr_matrix(A)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f32 = solve_lp(A, b, c, eps=1e-4, dtype="float32",
                       device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    f64 = solve_lp(A, b, c, eps=1e-4, device=cuda_device)
    assert f32.status_name == f64.status_name == "Solved"
    assert abs(f32.pobj - f64.pobj) <= 1e-3 * abs(f64.pobj)


# -- the host conic driver ----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chol", "inverse_mixed", "diag-q", "full-q",
                                  "cg"])
def test_solve_qcp_on_card_matches_cpu(cuda_device, case):
    """`solve_qcp` on the card (its default device) against the port on
    the CPU, on a small `tools.generate.randcone` / `randqcp` instance: the
    same f64 driver, so equal status and IPM count, ADMM counts within
    10% (cuSOLVER and LAPACK round the factor differently) and objectives
    within 1e-6 relative; the iterate lives on the card."""
    import numpy as np

    from abip_tpu_torch import ConeSpec, ConicWorkspace, conic_defaults

    cones = ConeSpec(**chip_smoke.SMALL_SPEC)
    kw, Q = {}, None
    if case in ("chol", "inverse_mixed", "cg"):
        _, A, b, c, _, star = randcone("c", 8, cones, 41)
        kw = {"inverse_mixed": dict(dense_mode="inverse_mixed", rho_y=1e-3),
              "cg": dict(linsys="cg")}.get(case, {})
    elif case == "diag-q":
        _, A, b, c, Q, _, star = randqcp("d", 8, cones, 42, q_rank="diag")
    else:
        _, A, b, c, Q, _, star = randqcp("f", 8, cones, 43)
    s = conic_defaults(eps=1e-7, **kw)
    ws = ConicWorkspace(A, b, c, cones, Q=Q, settings=s)
    assert ws.device.type == "cuda" and ws.b.is_cuda
    card = ws.solve()
    cpu = ConicWorkspace(A, b, c, cones, Q=Q, settings=s,
                         device="cpu").solve()
    assert card.status_name == cpu.status_name == "Solved"
    assert card.ipm_iters == cpu.ipm_iters
    assert abs(card.admm_iters - cpu.admm_iters) <= 0.1 * cpu.admm_iters
    assert abs(card.pobj - cpu.pobj) <= 1e-6 * max(1.0, abs(cpu.pobj))
    assert abs(card.pobj - star) <= 1e-5 * max(1.0, abs(star))
    assert np.isfinite(card.x).all()


@pytest.mark.cuda
def test_front_door_files_on_card(cuda_device):
    """The CLI's functions on the card: a .cbf, a .mat and a sparse .mps
    (K5 counted where its standard form packs BCSR)."""
    import json
    import os

    from abip_tpu_torch.io.cbf import solve_cbf
    from abip_tpu_torch.io.presolve import solve_mps
    from abip_tpu_torch.io.sedumi import solve_sedumi
    from abip_tpu_torch.ops.spmv import bcsr_matvec_cuda

    suites = chip_smoke.SUITES
    with open(os.path.join(suites, "cblib_mini", "optima.json")) as f:
        star = json.load(f)["rand_soc_b_max"]
    sol, _, obj = solve_cbf(os.path.join(suites, "cblib_mini",
                                         "rand_soc_b_max.cbf"), eps=1e-6)
    assert sol.status_name == "Solved" and abs(obj - star) <= 1e-5
    sol = solve_sedumi(os.path.join(suites, "conic_mini", "rand_soc_a.mat"),
                       eps=1e-6)
    assert sol.status_name == "Solved"
    bcsr_matvec_cuda.launches = 0
    sol, _ = solve_mps(os.path.join(suites, "netlib_mini", "rev02.mps"),
                       dense=False, eps=1e-6)
    assert sol.status_name == "Solved" and bcsr_matvec_cuda.launches > 0


# -- the sprint engines: K6, K7, K4, K8 ---------------------------------------

@pytest.mark.cuda
def test_lp_sprint_kernels_match_plain_on_card(cuda_device):
    """K6 and K7 against their plain version at the smoke shape and a
    ragged one (`chip_smoke.phase_lp_sprint_parity`: equal t_done, the
    stated tolerance, the accuracy ratio, lanes stopped mid-chunk)."""
    chip_smoke.phase_lp_sprint_parity(torch, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("label,case", CONIC_CASES, ids=CASE_IDS)
def test_conic_sprint_kernel_matches_plain_on_card(cuda_device, label, case):
    """K4 from the cold start and at k0 = 64, then lanes stopped
    mid-chunk (`chip_smoke.conic_sprint_parity`)."""
    chip_smoke.conic_sprint_parity(torch, cuda_device, label, case)


@pytest.mark.cuda
def test_barrier_step_kernel_matches_plain_on_card(cuda_device):
    """K8 in f32 and f64 on a 32,000-vector and a ragged one, and the
    prox at the reference guard's fault points within 1e-6 of the f64
    prox (`chip_smoke.phase_barrier_step`)."""
    _, launches = chip_smoke.phase_barrier_step(torch, cuda_device)
    assert launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [4, 16, "spill"])
def test_sprint_kernels_at_other_cluster_sizes(cuda_device, cluster):
    """K6 (T=64, thresh=0) and K7 (T=32) resident at cluster sizes the
    plan does not pick, and spilled, against the plain version at the LP
    sprints' tolerance (`chip_smoke.LP_SPRINT_REL_SCALE`), t_done
    equal."""
    from abip_tpu_torch.ops import admm_sprint as sp

    _, stacks = chip_smoke.smoke_batch(500, 4)
    S, u, v = chip_smoke.mid_solve_state(torch, stacks, cuda_device,
                                         sprint=True)
    op = chip_smoke.lp_sprint_operands(torch, S, u, v, 0.0)
    _, m, n = op.A.shape
    if cluster == "spill":
        plan = sp.DeltaPlan(sp.SPRINT_CLUSTER, False, 0, spill=True)
    else:
        plan = sp.DeltaPlan(cluster, True, sp.sprint_smem_bytes(m, n, cluster,
                                                                True))
    tol = dict(amplified=(), rel_scale=chip_smoke.LP_SPRINT_REL_SCALE)
    tm = torch.full((4,), 64, dtype=torch.int32, device=cuda_device)
    ker = sp.sprint_stop_cuda(op, tm, 8, plan=plan)
    plain = sp._sprint_compute(op, tm, 8)
    assert torch.equal(ker[3][:, 3], plain[3][:, 3])
    chip_smoke.compare_conic([*ker[:3], ker[3][:, :2]],
                             [*plain[:3], plain[3][:, :2]],
                             ("y", "x", "vx", "tau_kappa"), "K6", **tol)
    tm = torch.full((4,), 32, dtype=torch.int32, device=cuda_device)
    ker, plain = sp.sprint_cuda(op, tm, plan=plan), sp._sprint_compute(op, tm, 0)
    chip_smoke.compare_conic([*ker[:3], ker[3][:, :2]],
                             [*plain[:3], plain[3][:, :2]],
                             ("y", "x", "vx", "tau_kappa"), "K7", **tol)


@pytest.mark.cuda
def test_sprint_kernels_refuse_shapes_beyond_shared_memory(cuda_device):
    """m=15,000 needs more shared memory per CTA than the card has even
    streamed through L2 (the exchange buffers alone are 4 m floats): the
    LP sprint wrappers refuse a shared-memory plan of that shape, and by
    their own plan launch the spilled form.  (n=60,000, the shape the
    one-block kernel refused, now streams at C=6.)"""
    from abip_tpu_torch.ops import admm_sprint

    B, m, n = 1, 15_000, 1
    z = {k: torch.zeros((B, m if k in admm_sprint._M_FIELDS else n),
                        device=cuda_device)
         for k in admm_sprint.SprintOperands._fields}
    z.update(scal=torch.zeros((B, admm_sprint.N_SCAL), device=cuda_device),
             A=torch.zeros((B, m, n), device=cuda_device),
             Ninv=torch.zeros((B, m, m), device=cuda_device))
    op = admm_sprint.SprintOperands(**z)
    one = torch.ones((B,), dtype=torch.int32)
    shared = admm_sprint.DeltaPlan(
        admm_sprint.SPRINT_CLUSTER, False, admm_sprint.sprint_smem_bytes(
            m, n, admm_sprint.SPRINT_CLUSTER, False))
    with pytest.raises(ValueError, match="shared memory"):
        admm_sprint.sprint_stop_cuda(op, one, 8, plan=shared)
    with pytest.raises(ValueError, match="shared memory"):
        admm_sprint.sprint_cuda(op, one, plan=shared)
    assert admm_sprint.sprint_launch_plan(m, n).spill
    assert admm_sprint.sprint_stop_cuda(op, one, 8)[3][:, 3].tolist() == [8.0]
    assert admm_sprint.sprint_cuda(op, one)[3][:, 3].tolist() == [1.0]


@pytest.mark.cuda
def test_sprint_solves_on_card_go_through_their_kernels(cuda_device):
    """Small batches solved on the card: LP sprint2 + delta launches K6
    and K1, the sprint engine under cadence "cond" K7, conic
    phase1="sprint" K4 and K3; every lane within 1e-5 of HiGHS or 2e-5
    of its known optimum."""
    from abip_tpu_torch.ops.admm_sprint import sprint_cuda, sprint_stop_cuda
    from abip_tpu_torch.ops.conic_dr import dr_sprint_cuda

    data, stacks = chip_smoke.smoke_batch(810, 3, m=20, n_rand=180)
    for kw, kernel in ((dict(endgame="delta"), sprint_stop_cuda),
                       (dict(engine="sprint", cadence="cond"), sprint_cuda)):
        kernel.launches = 0
        delta.delta_chunk_cuda.launches = 0
        res = chip_smoke.solve_sprint(torch, stacks, cuda_device,
                                      **dict(kw, qres_period=256))
        assert kernel.launches > 0
        assert (delta.delta_chunk_cuda.launches > 0) == ("endgame" in kw)
        chip_smoke.lp_vs_highs(data, res, str(kw))
    cones, stacks, stars = chip_smoke.conic_batch(
        308, count=4, spec=chip_smoke.SMALL_SPEC, m=7)
    dr_sprint_cuda.launches = 0
    conic_delta.conic_delta_cuda.launches = 0
    res = chip_smoke.solve_conic_sprint(torch, cones, stacks, cuda_device)
    assert dr_sprint_cuda.launches > 0
    assert conic_delta.conic_delta_cuda.launches > 0
    assert res.status.tolist() == [1, 1, 1, 1]
    assert abs(res.pobj.cpu().numpy() - stars).max() < 2e-5


@pytest.mark.cuda
def test_solves_with_every_kernel_spilled(cuda_device):
    """With the launch plans held to no shared memory
    (`limit_shared_memory(0)`), every kernel spills: LP sprint2 + delta
    (K6, K1), the sprint engine under cadence "cond" (K7), the conic
    ladder + delta (K2, K3) and conic phase1="sprint" (K4, K3) still
    solve every lane, within 1e-5 of HiGHS or 2e-5 of the known
    optimum."""
    from abip_tpu_torch.ops.admm_sprint import sprint_cuda, sprint_stop_cuda
    from abip_tpu_torch.ops.conic_dr import dr_sprint_cuda, ladder_cuda

    data, stacks = chip_smoke.smoke_batch(810, 3, m=20, n_rand=180)
    cones, cstacks, stars = chip_smoke.conic_batch(
        308, count=4, spec=chip_smoke.SMALL_SPEC, m=7)
    kernels = (sprint_stop_cuda, sprint_cuda, delta.delta_chunk_cuda,
               ladder_cuda, dr_sprint_cuda, conic_delta.conic_delta_cuda)
    for k in kernels:
        k.launches = 0
    with limit_shared_memory(0):
        assert delta.delta_launch_plan(20, 200, 0).spill
        for kw in (dict(endgame="delta"), dict(engine="sprint",
                                               cadence="cond")):
            res = chip_smoke.solve_sprint(torch, stacks, cuda_device,
                                          **dict(kw, qres_period=256))
            chip_smoke.lp_vs_highs(data, res, f"spilled {kw}")
        for solve in (chip_smoke.solve_conic, chip_smoke.solve_conic_sprint):
            res = solve(torch, cones, cstacks, cuda_device)
            assert res.status.tolist() == [1, 1, 1, 1]
            assert abs(res.pobj.cpu().numpy() - stars).max() < 2e-5
    assert all(k.launches > 0 for k in kernels), [k.launches for k in kernels]


STEPS_KW = dict(engine="steps", eps=1e-6, normalize=True, rho_y=1e-3,
                inner_crit_period=8, max_admm=1_000_000)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("cadence", ["chunk", "cond"])
def test_steps_engine_on_card_matches_cpu(cuda_device, precision, cadence):
    """The batched steps engine on the card (its default device) against
    the same call on the CPU: equal statuses, objectives within 1e-6
    relative, every lane within 2e-5 of its known optimum."""
    from abip_tpu_torch import solve_qcp_batch

    cones, stacks, stars = chip_smoke.conic_batch(
        308, count=4, spec=chip_smoke.SMALL_SPEC, m=7)
    kw = dict(STEPS_KW, precision=precision, cadence=cadence)
    card = solve_qcp_batch(*stacks[:3], cones=cones, **kw)
    cpu = solve_qcp_batch(*stacks[:3], cones=cones, device="cpu", **kw)
    assert card.x.is_cuda
    assert card.status.tolist() == cpu.status.tolist() == [1] * 4
    pc = cpu.pobj.numpy()
    assert (abs(card.pobj.cpu().numpy() - pc)
            <= 1e-6 * np.maximum(1.0, abs(pc))).all()
    assert abs(card.pobj.cpu().numpy() - stars).max() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_mixed_steps_products_stay_ieee_f32(cuda_device, monkeypatch, api):
    """With TF32 switched on by the caller (through either of PyTorch's
    APIs), every f32 product of the mixed steps engine runs with TF32
    off (`device.ieee_f32`), and the caller's setting is restored."""
    from abip_tpu_torch import solve_qcp_batch
    from abip_tpu_torch.parallel import batched_qcp

    cones, stacks, stars = chip_smoke.conic_batch(
        308, count=2, spec=chip_smoke.SMALL_SPEC, m=7)
    matmul = torch.backends.cuda.matmul
    seen = []
    mv = batched_qcp._mv

    def spy(M, x):
        if M.dtype == torch.float32:
            seen.append(matmul.fp32_precision)
        return mv(M, x)

    monkeypatch.setattr(batched_qcp, "_mv", spy)
    try:
        if api == "legacy":
            matmul.allow_tf32 = True
        else:
            matmul.fp32_precision = "tf32"
        res = solve_qcp_batch(*stacks[:3], cones=cones,
                              **dict(STEPS_KW, precision="mixed"))
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.allow_tf32 = False
        matmul.fp32_precision = "none"
    assert seen and set(seen) == {"ieee"}, (len(seen), set(seen))
    assert res.status.tolist() == [1, 1]
    assert abs(res.pobj.cpu().numpy() - stars).max() < 2e-5


@pytest.mark.cuda
def test_compacted_sprint2_on_card(cuda_device):
    """sprint2 with compact_period=64 on the card: phase 1 in K2, the
    compaction rounds' endgame in K3 on power-of-two buckets; every lane
    within 2e-5 of its known optimum, as the uncompacted batch."""
    from abip_tpu_torch import solve_qcp_batch
    from abip_tpu_torch.ops.conic_dr import ladder_cuda

    cones, stacks, stars = chip_smoke.conic_batch(
        308, count=5, spec=chip_smoke.SMALL_SPEC, m=7)
    ladder_cuda.launches = 0
    conic_delta.conic_delta_cuda.launches = 0
    res = solve_qcp_batch(*stacks[:3], cones=cones,
                          **dict(chip_smoke.CONIC_KW, compact_period=64))
    assert ladder_cuda.launches > 0
    assert conic_delta.conic_delta_cuda.launches > 0
    assert res.status.tolist() == [1] * 5
    assert abs(res.pobj.cpu().numpy() - stars).max() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["batch", "pool"])
def test_het_batch_on_card(cuda_device, route):
    """Three cone structures of different shapes as one batch (padded
    layout) or per instance on the card, against the CPU."""
    from abip_tpu_torch import ConeSpec
    from abip_tpu_torch.parallel import solve_qcp_het_batch

    specs = (ConeSpec(soc=(5,), rsoc=(4,), nonneg=10),
             ConeSpec(soc=(6, 3), nonneg=8), ConeSpec(rsoc=(5,), nonneg=12))
    probs, stars = [], []
    for i, (spec, m) in enumerate(zip(specs, (7, 8, 6))):
        _, A, b, c, _, star = randcone("h", m, spec, 500 + i)
        probs.append((A, b, c, None, spec))
        stars.append(star)
    kw = dict(eps=1e-6, inner_crit_period=8, route=route)
    card = solve_qcp_het_batch(probs, **kw)
    cpu = solve_qcp_het_batch(probs, device="cpu", **kw)
    assert card.x.is_cuda
    assert card.status.tolist() == cpu.status.tolist() == [1, 1, 1]
    assert abs(card.pobj.cpu().numpy() - cpu.pobj.numpy()).max() < 1e-6
    assert abs(card.pobj.cpu().numpy() - np.array(stars)).max() < 2e-5


@pytest.mark.cuda
def test_host_polish_on_card(cuda_device):
    """A lane stopped by k_cap, polished in f64 by the host conic driver
    on the card (its default device): Solved at the known optimum."""
    from abip_tpu_torch import solve_qcp_batch
    from abip_tpu_torch.parallel.batched_qcp import host_polish

    cones, stacks, stars = chip_smoke.conic_batch(
        308, count=2, spec=chip_smoke.SMALL_SPEC, m=7)
    res = solve_qcp_batch(*stacks[:3], cones=cones, k_cap=40,
                          **dict(STEPS_KW, precision="f64"))
    assert res.status.tolist() == [0, 0]
    A, b, c = (x[1] for x in stacks[:3])
    sol = host_polish(A, b, c, cones, res, lane=1, eps=1e-6)
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - stars[1]) <= 1e-5 * max(1.0, abs(stars[1]))


# ---------------------------------------------------------------------------
# the rest of the single-card port
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_pagerank_family_deterministic_on_card(cuda_device):
    """A same-pattern PageRank family (n=2000, B=4) solved twice on the
    card under `torch.use_deterministic_algorithms(True)`: equal results
    bit for bit (the sparse products gather and sum in a fixed order);
    every lane Solved with |1'x - 1| <= 1e-5; lane 2 against its one-lane
    solve: equal status and IPM, ADMM and CG counts, x and y within 1e-10
    of their scale, s within 1e-10 of c's (a reduction over one lane
    splits its sum across thread blocks otherwise than over four:
    PyTorch's reduction kernel picks its split by the number of outputs;
    on the CPU the lane equals its one-lane solve bit for bit,
    `tests/test_torch_sparse_batched.py`)."""
    from abip_tpu_torch.parallel import solve_lp_batch_coo

    rows, cols, valss, bs, cs = chip_smoke.pagerank_family(2000, 4)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        infos = [{}, {}, {}]
        runs = [solve_lp_batch_coo(rows, cols, valss, bs, cs, m=2000, n=2000,
                                   eps=1e-6, info=infos[k]) for k in range(2)]
        one = solve_lp_batch_coo(rows, cols, valss[2:3], bs[2:3], cs[2:3],
                                 m=2000, n=2000, eps=1e-6, info=infos[2])
    finally:
        torch.use_deterministic_algorithms(prev)
    a, b = runs
    assert a.x.is_cuda
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.status.tolist() == [1] * 4
    assert (a.x.sum(-1) - 1).abs().max().item() <= 1e-5
    assert torch.equal(infos[0]["cg_iters"], infos[1]["cg_iters"])
    for f in ("status", "ipm_iters", "admm_iters"):
        assert int(getattr(one, f)[0]) == int(getattr(a, f)[2]), f
    assert int(infos[2]["cg_iters"][0]) == int(infos[0]["cg_iters"][2])
    for f in ("x", "y", "s"):
        lane, alone = getattr(a, f)[2], getattr(one, f)[0]
        # s = c - A'y is near 0 at the optimum: its scale is c's
        scale = float(np.abs(cs[2]).max() if f == "s" else lane.abs().max())
        assert float((lane - alone).abs().max()) <= 1e-10 * scale, f


@pytest.mark.cuda
def test_stream_and_pool_match_serial_on_card(cuda_device):
    """The lane-swap stream (5 LPs on 2 lanes, lanes refilled and one
    parked) against each instance streamed alone: equal statuses,
    objectives within 1e-6 relative (f32 products in both, batched
    products summing in another order).  The pool with the delta engine
    (K1 on each worker's stream) at workers=4 against workers=1 and
    against serial one-lane solves on the default stream: equal bit for
    bit; K1 launched."""
    from abip_tpu_torch.ops.admm_delta import delta_chunk_cuda
    from abip_tpu_torch.parallel import device_solve_lp, solve_lp_pool
    from abip_tpu_torch.parallel.segmented import solve_lp_stream

    data, _ = chip_smoke.smoke_batch(9500, 5, m=20, n_rand=180)
    kw = dict(seg_chunks=8, qres_period=16, eps=1e-6)
    out, info = solve_lp_stream(data, B=2, **kw)
    assert info["solved"] == 5
    for p, r in zip(data, out):
        alone, _ = solve_lp_stream([p], B=1, **kw)
        assert alone[0]["status"] == r["status"] == 1
        assert abs(alone[0]["pobj"] - r["pobj"]) <= 1e-6 * abs(r["pobj"])
    data, _ = chip_smoke.smoke_batch(9600, 4, m=20, n_rand=180)
    kw = dict(chip_smoke.SOLVE_KW, qres_period=256)
    delta_chunk_cuda.launches = 0
    four = solve_lp_pool(data, workers=4, **kw)
    assert delta_chunk_cuda.launches > 0
    one = solve_lp_pool(data, workers=1, **kw)
    for p, a, b in zip(data, four, one):
        r = device_solve_lp(*(torch.as_tensor(x, device=cuda_device)[None]
                              for x in p), **kw)
        assert int(a.status) == 1
        for f in ("x", "y", "s", "status", "admm_iters", "ipm_iters",
                  "pobj"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
            assert torch.equal(getattr(a, f), getattr(r, f)[0]), f


@pytest.mark.cuda
def test_pdhg_mixed_products_stay_ieee_f32(cuda_device, monkeypatch):
    """With TF32 switched on by the caller, every f32 product of PDHG's
    mixed precision runs with TF32 off (`device.ieee_f32`) and the
    caller's setting is restored; the batch solves to HiGHS."""
    from abip_tpu_torch import pdhg

    data, stacks = chip_smoke.smoke_batch(9700, 2, m=15, n_rand=30)
    matmul = torch.backends.cuda.matmul
    seen = []
    mv, rmv = pdhg._mv, pdhg._rmv

    def spy(fn):
        def wrapped(M, x):
            if M.dtype == torch.float32:
                seen.append(matmul.fp32_precision)
            return fn(M, x)
        return wrapped

    monkeypatch.setattr(pdhg, "_mv", spy(mv))
    monkeypatch.setattr(pdhg, "_rmv", spy(rmv))
    try:
        matmul.fp32_precision = "tf32"
        st = pdhg.solve_lp_pdhg_batch(*stacks, eps=1e-6, precision="mixed")
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.allow_tf32 = False
        matmul.fp32_precision = "none"
    assert seen and set(seen) == {"ieee"}, (len(seen), set(seen))
    assert st.status.tolist() == [1, 1]
    chip_smoke.highs_worst_gap(data, st.pobj.tolist(), "PDHG mixed")


def _lp_grad_instance(seed=7, m=8, n=20):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    return A, A @ x0, A.T @ y0 + rng.random(n) + 0.5


@pytest.mark.cuda
def test_lp_grad_on_card_matches_cpu(cuda_device):
    """d(v'x*)/db through `solve_lp_grad` on the card against the same
    call on the CPU: within 1e-8 of the gradient's scale."""
    from abip_tpu_torch import solve_lp_grad

    A, b, c = _lp_grad_instance()
    v = np.random.default_rng(11).standard_normal(c.shape[0])
    grads = []
    for dev in (cuda_device, "cpu"):
        bt = torch.tensor(b, device=dev, requires_grad=True)
        x, _, _ = solve_lp_grad(A, bt, c, eps=1e-9, device=dev)
        (torch.as_tensor(v, device=dev) @ x).backward()
        grads.append(bt.grad.cpu().numpy())
    scale = np.abs(grads[1]).max()
    assert np.abs(grads[0] - grads[1]).max() <= 1e-8 * scale


@pytest.mark.cuda
def test_min_norm_adjoint_on_card(cuda_device):
    """At a degenerate vertex (duplicate columns) the minimum-norm adjoint
    solve on the card gives a finite gradient; on one singular adjoint
    matrix the card's SVD solve equals the CPU's within 1e-9 relative."""
    from abip_tpu_torch import solve_lp_grad
    from abip_tpu_torch.diff import _min_norm_solve

    rng = np.random.default_rng(17)
    m, n = 6, 12
    A = rng.standard_normal((m, n))
    A[:, -1] = A[:, 0]
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    c[-1] = c[0]
    bt = torch.tensor(b, device=cuda_device, requires_grad=True)
    x, _, _ = solve_lp_grad(A, bt, c, eps=1e-9)
    x.sum().backward()
    assert torch.isfinite(bt.grad).all()
    M = rng.standard_normal((18, 18))
    M[:, -1] = M[:, 0]                       # rank 17
    rhs = rng.standard_normal(18)
    card = _min_norm_solve(torch.as_tensor(M, device=cuda_device),
                           torch.as_tensor(rhs, device=cuda_device))
    cpu = _min_norm_solve(torch.as_tensor(M), torch.as_tensor(rhs))
    assert torch.isfinite(card).all()
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=1e-9 * float(cpu.abs().max()))


# --------------------------------------------------------------------- #
# The multi-card layer on a one-rank NCCL group (the card's machine has   #
# one card; the multi-rank semantics are held on gloo CPU groups by      #
# `tests/test_torch_sharded.py` and `tests/test_torch_mesh.py`)          #
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_workspace_shard_on_one_rank_nccl(cuda_device):
    """`LPWorkspace.shard(linsys="dense")` over a one-rank NCCL mesh
    reproduces the unsharded dense solve on the card: equal status, IPM
    and ADMM counts, pobj to 1e-9 relative."""
    from abip_tpu_torch import LPWorkspace, Settings
    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(m=40, n_rand=360, seed=5)
    base = LPWorkspace(A, b, c, Settings(eps=1e-6)).solve()
    with chip_smoke.one_rank_nccl() as mesh:
        ws = LPWorkspace(A, b, c, Settings(eps=1e-6))
        sh = ws.shard(mesh("rows"), linsys="dense").solve()
        assert ws.ops.shard is not None and ws.ops.chol is not None
    assert sh.status_name == base.status_name == "Solved"
    assert (sh.ipm_iters, sh.admm_iters) == (base.ipm_iters, base.admm_iters)
    assert sh.pobj == pytest.approx(base.pobj, rel=1e-9)


@pytest.mark.cuda
def test_batch_over_one_rank_nccl(cuda_device):
    """`solve_lp_batch(mesh=...)` (K1) over a one-rank NCCL mesh: the
    unmeshed batch's statuses and counts, pobj to 1e-10 relative."""
    from abip_tpu_torch.parallel import solve_lp_batch

    _, stacks = chip_smoke.smoke_batch(720, 4)
    base = solve_lp_batch(*stacks, **chip_smoke.SOLVE_KW)
    with chip_smoke.one_rank_nccl() as mesh:
        delta.delta_chunk_cuda.launches = 0
        sh = solve_lp_batch(*stacks, mesh=mesh("batch"),
                            **chip_smoke.SOLVE_KW)
        assert delta.delta_chunk_cuda.launches > 0
    for f in ("status", "ipm_iters", "admm_iters"):
        assert torch.equal(getattr(sh, f), getattr(base, f)), f
    assert (sh.status == 1).all()
    torch.testing.assert_close(sh.pobj, base.pobj, rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_nccl_that_cannot_form_fails(cuda_device):
    """With NCCL pointed at a network interface that does not exist, the
    one-rank group's probe raises and the process fails: the group never
    forms, and nothing falls back to gloo."""
    import subprocess
    import sys

    code = ("import chip_smoke\n"
            "with chip_smoke.one_rank_nccl() as mesh:\n"
            "    print('FORMED', mesh('rows').get_group('rows'))\n")
    env = dict(os.environ, NCCL_SOCKET_IFNAME="abip_no_such_if0")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0, r.stdout
    assert "FORMED" not in r.stdout and "gloo" not in r.stdout.lower()


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["free_mixed", "zero_mixed", "mixed"])
def test_fuzz_conic_free_and_zero_blocks_on_card(cuda_device, cls):
    """`tools.fuzz_conic --batched --engine sprint2` on the card, four
    lanes of a class with free (and zero) cone blocks: K2 and K3 launch,
    every lane passes the tool's contract, with the CPU run's statuses."""
    from abip_tpu_torch.tools import fuzz_conic

    conic_dr.ladder_cuda.launches = 0
    conic_delta.conic_delta_cuda.launches = 0
    card = fuzz_conic.run_class(cls, 4, batched=True, engine="sprint2")
    assert conic_dr.ladder_cuda.launches > 0
    assert conic_delta.conic_delta_cuda.launches > 0
    cpu = fuzz_conic.run_class(cls, 4, batched=True, engine="sprint2",
                               device="cpu")
    assert all(r["ok"] for r in card), card
    assert [r["status"] for r in card] == [r["status"] for r in cpu]


@pytest.mark.cuda
def test_k2_k3_on_fuzz_batches(cuda_device):
    """K2 and K3 against their plain versions on fuzz_conic's zero_mixed
    and mixed batches, as the smoke's phase 11 holds them
    (`chip_smoke.phase_fuzz_parity`)."""
    k2, k3 = chip_smoke.phase_fuzz_parity(torch, cuda_device)
    assert k2 >= 0.0 and k3 >= 0.0
