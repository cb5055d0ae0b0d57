"""The launch plans of the card's kernels, as pure functions on the CPU.

Each chunk entry (`run_delta_chunk`: K1; the LP sprints' `_run`: K6,
K7; `run_conic_delta_chunk`: K3; `fused_dr_ladder` and
`fused_dr_sprint_stop`: K2, K4) launches its kernel on every CUDA
tensor, one thread-block cluster per lane.  The form of the launch
follows the shapes and the card's `shared_memory_per_block_optin`:
resident, streaming through L2, or, where no shared memory holds a CTA,
spilled: the same layout in a global workspace.  Where the reference's
`pallas_fits` gate sends a shape to its XLA version because its kernel
does not fit VMEM, the port's kernels still run it, in whatever form
their plan gives; the converse does not hold (the card's kernels stream
through L2 shapes a TPU core's VMEM does not hold).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.ops.spmv_pallas import pallas_fits  # noqa: E402
from abip_tpu_torch.cones import ConeSpec, cone_operands  # noqa: E402
from abip_tpu_torch.ops import admm_delta as delta  # noqa: E402
from abip_tpu_torch.ops import admm_sprint as sp  # noqa: E402
from abip_tpu_torch.ops import conic_delta as cd  # noqa: E402
from abip_tpu_torch.ops import conic_dr  # noqa: E402

H100 = delta.SMEM_OPTIN


def _p128(k):
    return -(-k // 128) * 128


# the reference's gates (`admm_delta.py:536-549`, `admm_pallas.py:432`,
# `conic_delta.py:662`, `conic_pallas.py:496`, `:805`), per-lane bytes
def _ref_delta(m, n):
    mp, np_ = _p128(m), _p128(n)
    return pallas_fits(4 * (mp * np_ + mp * mp + 13 * np_ + 6 * mp))


def _ref_sprint(m, n):
    mp, np_ = _p128(m), _p128(n)
    return pallas_fits(4 * (mp * np_ + mp * mp + 7 * (mp + np_)))


def _ref_conic(m, n, nb, woodbury, extra):
    mp, np_ = _p128(m), _p128(n)
    mk = mp if woodbury else np_
    return pallas_fits(4 * (mp * np_ + mk * mk + nb * np_ * 3
                            + extra * (mp + np_)))


CONIC = {  # (m, n, nb, woodbury)
    "dim-1020": (340, 1020, 3, True),
    "small primal": (12, 19, 2, False),
    "wide n=1500": (400, 1500, 3, True),
    "150 blocks": (80, 590, 150, True),
}


@pytest.mark.parametrize("label", sorted(CONIC))
def test_conic_delta_plan(label):
    """K3's plan is the first of CONIC_DELTA_PLANS that fits; the smoke
    shapes fit resident; every plan's shared memory is the kernel's."""
    m, n, nb, wb = CONIC[label]
    plan = cd.conic_delta_launch_plan(m, n, nb, H100, wb)
    assert plan.smem_bytes <= H100
    assert plan.smem_bytes == cd.conic_delta_smem_bytes(
        m, n, nb, plan.cluster, plan.resident, wb)
    first = next(p for p in cd.CONIC_DELTA_PLANS
                 if cd.conic_delta_smem_bytes(m, n, nb, *p, wb) <= H100)
    assert (plan.cluster, plan.resident) == first
    if label in ("dim-1020", "small primal", "150 blocks"):
        assert plan.resident
    assert not plan.spill


def test_conic_delta_shared_memory_by_form():
    """At dim-1020 C=7 and C=8 hold A's slice (201 and 174 KB), C=6 does
    not (234 KB)."""
    m, n, nb = 340, 1020, 3
    assert cd.conic_delta_smem_bytes(m, n, nb, 7, True) <= H100
    assert cd.conic_delta_smem_bytes(m, n, nb, 8, True) <= H100
    assert cd.conic_delta_smem_bytes(m, n, nb, 6, True) > H100
    nc, mp = 148, 340
    assert cd.conic_delta_smem_bytes(m, n, nb, 7, True) == 4 * (
        12 * 12 + 3 * 24 + 3 * mp + 4 * nc + 92 + 384 + 8 * mp + m * nc
        + 8 * nc)           # nc = 148 = 4 mod 8: the rows' stride is nc


def test_conic_delta_streaming_takes_every_shape_the_one_block_kernel_took():
    """The last plan (C=16, streaming) needs less than the one-block
    kernel's 6 m + 4 n + 7 nb floats and its scratch, so no shape that
    kernel took spills."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        m, n = int(rng.integers(1, 9000)), int(rng.integers(1, 14000))
        nb = int(rng.integers(0, n // 2 + 1))
        for wb in (True, False):
            old = 4 * (6 * m + 4 * n + 7 * nb + 32 * 9)
            if old <= H100:
                plan = cd.conic_delta_launch_plan(m, n, nb, H100, wb)
                assert not plan.spill, (m, n, nb, wb)


def test_conic_delta_plan_on_a_smaller_card():
    """With 100 KB a block, dim-1020 streams at C=6; with less than the
    streaming form needs, the plan spills at C=16, with no shared
    memory."""
    plan = cd.conic_delta_launch_plan(340, 1020, 3, 100_000)
    assert (plan.cluster, plan.resident) == (6, False)
    assert cd.conic_delta_launch_plan(340, 1020, 3, 2_000) == cd.DeltaPlan(
        16, False, 0, spill=True)


@pytest.mark.parametrize("m,n,resident", [
    (50, 2000, True), (37, 411, True), (1, 60_000, False),
    (200, 3000, False)], ids=["smoke", "ragged", "n=60000", "L2-streaming"])
def test_sprint_launch_plan(m, n, resident):
    """K6/K7 take K1's cluster plan with their own slices: 5 x-side
    slices (hx, gx, mask, x, vx) and 4 m-side vectors."""
    plan = sp.sprint_launch_plan(m, n)
    assert (plan.cluster, plan.resident) == (sp.SPRINT_CLUSTER, resident)
    assert not plan.spill
    nc = delta.delta_cols_per_cta(n, plan.cluster)
    assert plan.smem_bytes == sp.sprint_smem_bytes(m, n, plan.cluster,
                                                   resident)
    assert plan.smem_bytes == 4 * (4 * m + 240 + nc + (
        4 * m + m * nc + m * m + 5 * nc if resident else 0))


def test_sprint_launch_plan_refuses_beyond_the_largest_shape():
    """At m=15,000 no shared-memory form fits (the streaming form's
    exchange buffers alone are 4 m floats): the plan spills."""
    assert sp.sprint_smem_bytes(15_000, 1, sp.SPRINT_CLUSTER, False) > H100
    assert sp.sprint_launch_plan(15_000, 1) == sp.DeltaPlan(
        sp.SPRINT_CLUSTER, False, 0, spill=True)


@pytest.mark.parametrize("spare,resident", [(0, True), (-4, False)],
                         ids=["fits", "one-float-short"])
def test_sprint_launch_plan_on_a_smaller_card(spare, resident):
    need = sp.sprint_smem_bytes(50, 2000, sp.SPRINT_CLUSTER, True)
    plan = sp.sprint_launch_plan(50, 2000, smem_limit=need + spare)
    assert plan.resident == resident


def test_dr_predicate_is_the_one_block_kernels_shared_memory():
    """K2 and K4 run a cluster per lane (`dr_smem_bytes` is a
    CTA's shared memory, `conic_cluster.cuh:dr_smem_floats`): at dim-1020
    C=8 holds A's slice in 204 KB; 15,000 SOC(2) blocks, which one block
    per lane could not hold (6 m + 4 n + 3 nb floats), fit a CTA of C=8
    with A's slice (3,752 columns); only a tall m, whose replicated
    m-side state alone exceeds a CTA, spills."""
    nc, mp = 128, 340
    assert conic_dr.dr_smem_bytes(340, 1020, 3, 8, True) == 4 * (
        12 * 8 + 2 * 28 + 12 + 5 * mp + 4 * nc + 12 + 384
        + 8 * mp + 340 * (nc + 4) + 5 * nc)   # nc = 0 mod 8: stride nc + 4
    assert conic_dr.dr_smem_bytes(340, 1020, 3, 8, True) <= H100
    assert 4 * (6 * 1 + 4 * 30_000 + 3 * 15_000) > H100
    assert conic_dr.dr_launch_plan(1, 30_000, 15_000) == delta.DeltaPlan(
        8, True, conic_dr.dr_smem_bytes(1, 30_000, 15_000, 8, True))
    assert conic_dr.dr_launch_plan(12_000, 10, 0).spill


DR = {  # (m, n, nb, woodbury): (cluster, form)
    "dim-1020": ((340, 1020, 3, True), (8, "resident")),
    "small primal": ((12, 19, 2, False), (8, "resident")),
    "wide n=1500": ((400, 1500, 3, True), (6, "streaming")),
    "repair n=14500": ((50, 14_500, 15, True), (6, "streaming")),
    "15000 blocks": ((1, 30_000, 15_000, True), (8, "resident")),
    "tall m=12000": ((12_000, 10, 0, True), (16, "spilled")),
}


@pytest.mark.parametrize("label", sorted(DR))
def test_dr_launch_plan(label):
    """K2's and K4's plan is the first of DR_PLANS whose CTA fits, else
    C=16 spilled; every plan's shared memory is the kernel's."""
    (m, n, nb, wb), (cluster, form) = DR[label]
    plan = conic_dr.dr_launch_plan(m, n, nb, H100, wb)
    got = "spilled" if plan.spill else ("resident" if plan.resident
                                        else "streaming")
    assert (plan.cluster, got) == (cluster, form)
    if not plan.spill:
        assert plan.smem_bytes == conic_dr.dr_smem_bytes(
            m, n, nb, plan.cluster, plan.resident, wb) <= H100
        first = next(p for p in conic_dr.DR_PLANS
                     if conic_dr.dr_smem_bytes(m, n, nb, *p, wb) <= H100)
        assert (plan.cluster, plan.resident) == first
    else:
        assert plan.smem_bytes == 0 and not plan.resident


def test_dr_shared_memory_by_form():
    """At dim-1020 C=7 and C=8 hold A's slice (227 and 204 KB), C=6 does
    not; C=16 holds it in 115 KB."""
    m, n, nb = 340, 1020, 3
    assert conic_dr.dr_smem_bytes(m, n, nb, 7, True) <= H100
    assert conic_dr.dr_smem_bytes(m, n, nb, 8, True) <= H100
    assert conic_dr.dr_smem_bytes(m, n, nb, 6, True) > H100
    assert conic_dr.dr_smem_bytes(m, n, nb, 16, True) < 120_000


def test_dr_streaming_takes_every_shape_the_one_block_kernel_took():
    """The last plan (C=16, streaming) needs less than one block per lane
    needed (6 m + 4 n + 3 nb floats and 32 warps' scratch of 6), so no
    shape the one-block K2 and K4 held in shared memory spills."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        m, n = int(rng.integers(1, 9000)), int(rng.integers(1, 14000))
        nb = int(rng.integers(0, n // 2 + 1))
        for wb in (True, False):
            if 4 * (6 * m + 4 * n + 3 * nb + 32 * 6) <= H100:
                assert not conic_dr.dr_launch_plan(m, n, nb, H100, wb).spill


def test_dr_launch_plan_on_a_smaller_card():
    """With 100 KB a block, dim-1020 streams at C=6; with less than the
    streaming form needs, the plan spills at C=16, with no shared
    memory."""
    plan = conic_dr.dr_launch_plan(340, 1020, 3, 100_000)
    assert (plan.cluster, plan.resident, plan.spill) == (6, False, False)
    assert conic_dr.dr_launch_plan(340, 1020, 3, 2_000) == delta.DeltaPlan(
        16, False, 0, spill=True)


# -- where the port spills, the reference takes its XLA route ----------------

@pytest.mark.parametrize("entry,m,n,nb,form", [
    ("delta", 15_000, 1, 0, "spilled"), ("delta", 2, 500_000, 0, "spilled"),
    ("sprint", 15_000, 1, 0, "spilled"), ("dr", 1, 30_000, 15_000, "resident"),
    ("dr", 10_000, 10, 0, "streaming"), ("dr", 12_000, 10, 0, "spilled"),
    ("conic_delta", 20_000, 30, 0, "spilled"),
    ("conic_delta", 1, 30_000, 15_000, "spilled")],
    ids=["K1-tall", "K1-wide", "K6-tall", "K2K4-blocks", "K2K4-tall",
         "K2K4-taller", "K3-tall", "K3-blocks"])
def test_shapes_the_reference_sends_to_xla_run_in_the_kernel_on_the_card(
        entry, m, n, nb, form):
    """Shapes the reference's gate refuses (its kernel does not fit VMEM,
    so it runs its plain XLA version): the port's kernel runs them, in
    the form its launch plan gives (K2/K4 hold 15,000 SOC(2) blocks with
    m=1 in a cluster's shared memory; the others stream through L2 or
    spill)."""
    plan = {"delta": lambda: delta.delta_launch_plan(m, n, H100),
            "sprint": lambda: sp.sprint_launch_plan(m, n, H100),
            "dr": lambda: conic_dr.dr_launch_plan(m, n, nb, H100),
            "conic_delta": lambda: cd.conic_delta_launch_plan(
                m, n, nb, H100)}[entry]()
    ref = {"delta": lambda: _ref_delta(m, n),
           "sprint": lambda: _ref_sprint(m, n),
           "dr": lambda: _ref_conic(m, n, nb, True, 12),
           "conic_delta": lambda: _ref_conic(m, n, nb, True, 16)}[entry]
    got = "spilled" if plan.spill else ("resident" if plan.resident
                                        else "streaming")
    assert got == form and not ref()


@pytest.mark.parametrize("entry", ["delta", "sprint", "dr", "conic_delta"])
def test_smoke_shapes_take_the_kernel_on_both(entry):
    port = {"delta": delta.delta_launch_plan(50, 2000, H100).resident,
            "sprint": sp.sprint_launch_plan(50, 2000, H100).resident,
            "dr": conic_dr.dr_launch_plan(340, 1020, 3, H100).resident,
            "conic_delta": cd.conic_delta_launch_plan(
                340, 1020, 3, H100).resident}[entry]
    ref = {"delta": _ref_delta(50, 2000), "sprint": _ref_sprint(50, 2000),
           "dr": _ref_conic(340, 1020, 3, True, 12),
           "conic_delta": _ref_conic(340, 1020, 3, True, 16)}[entry]
    assert port and ref


# -- the column partition and the cone blocks' CTAs ---------------------------

def test_block_spans_and_touched_blocks():
    """Wide n=1500 at C=7 (nc=216): SOC(600) spans CTAs 0-2 (three
    slices), the second SOC(600) CTAs 2-5, RSOC(50) CTA 5; each CTA's
    blocks are those whose columns meet its slice."""
    co = cone_operands(ConeSpec(soc=(600, 600), rsoc=(50,), nonneg=250))
    spans, touched = cd.cluster_block_spans(co.start, co.length, 1500, 7)
    assert spans == [(0, 2), (2, 5), (5, 5)]
    assert touched == [(0, 1), (0, 1), (0, 2), (1, 2), (1, 2), (1, 3), (3, 3)]
    nc = cd.delta_cols_per_cta(1500, 7)
    for r, (k_lo, k_hi) in enumerate(touched):
        for k in range(3):
            lo, hi = int(co.start[k]), int(co.start[k] + co.length[k])
            meets = lo < min(1500, (r + 1) * nc) and hi > r * nc
            assert meets == (k_lo <= k < k_hi)


def test_block_spans_with_one_dimensional_socs_and_empty_ctas():
    """1-d SOCs are orthant elements between blocks; a CTA past n owns no
    columns and touches no block; a two-element block can straddle."""
    co = cone_operands(ConeSpec(soc=(3, 1, 2, 1, 3), nonneg=2))
    n = 12
    spans, touched = cd.cluster_block_spans(co.start, co.length, n, 5)
    assert cd.delta_cols_per_cta(n, 5) == 4
    # blocks at [0,3), [4,6), [7,10)
    assert co.start.tolist() == [0, 4, 7]
    assert spans == [(0, 0), (1, 1), (1, 2)]
    assert touched == [(0, 1), (1, 3), (2, 3), (0, 0), (0, 0)]
