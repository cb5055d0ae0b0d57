#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`abip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  It imports no JAX.  Phases, each printing its own lines and its
duration:

1. build the seven kernel sources from the checkout, one `nvcc` each,
   side by side: K1 `csrc/admm_delta.cu` (LP delta chunk), K6 and K7
   `csrc/admm_sprint.cu` (LP stopping and plain sprint), K2
   `csrc/conic_ladder.cu` (conic phase 1), K4 `csrc/conic_sprint.cu`
   (conic one-stage sprint), K3 `csrc/conic_delta.cu` (conic delta
   chunk), K5 `csrc/bcsr_spmv.cu` (sparse product over the stored
   entries), K8 `csrc/barrier_step.cu` (fused barrier step); K1, K2,
   K3, K4, K6 and K7 run one thread-block cluster per lane; the build
   prints each kernel's registers and spills;
2. host LP driver: hold K5 against its plain version, the tile product
   and scipy's f64 product (A and A' of the smoke instance, ragged
   shapes, rows of widely differing lengths; f64 and f32);
   solve three fresh smoke LPs (m=1000, n=10000, density 0.1, the shape
   of `benchmarks/results/r05_lp_m1000_tpu.json`) through `solve_lp`'s
   workspace on a CSR A, as a user calls it (BCSR layout, dense
   Cholesky), against scipy's HiGHS (run in worker processes while the
   card solves); the same driver with linsys="cg" at
   m=200; time K5 cold and warm against its plain version and cuSPARSE
   (int64 and int32 indices), and at each group size; profile one
   solve;
3. LP batch: hold K1 (one thread-block cluster per lane) against its
   plain PyTorch version on mid-solve anchors (B=16 at the smoke shape
   m=50, n=2000, a ragged m=37, n=411, and m=200, n=3000, where A and
   Ninv are read through L2; T=64, thresh=0; then thresholds that stop
   lanes mid-chunk); solve a fresh B=16 smoke batch through
   `solve_lp_batch` (eps=1e-6, chunk T=1536) against scipy's HiGHS;
   time it, and one chunk at each cluster size and spilled; profile it;
4. conic: hold K2 against its plain version on phase 1 from the cold
   start (dim-1020 B=16 and a small primal-form batch with a diagonal
   Q), and K3 on mid-solve anchors, each in the form its launch plan
   picks (T=64, thresh=0; then thresholds that stop lanes mid-chunk);
   solve a fresh B=16 dim-1020 batch through
   `solve_qcp_batch(engine="sprint2")` with the options of
   `tools/conic_bench.py` against the instances' known optima; time it,
   one K2 launch and one K3 chunk against their plain versions (K2 at
   cluster sizes 4, 6, 8 and 16, K3 at every cluster size, each in every
   residency whose CTA fits the card and spilled, with the clusters the
   card holds at once), and the f64 pieces; profile one solve;
5. the sprint engines: hold K6 and K7 against their plain version on
   mid-solve states (the LP shapes of phase 3; T=64 and T=32, then
   thresholds that stop lanes mid-chunk); solve fresh B=16 smoke
   batches with `solve_lp_batch` (`SOLVE_KW` with engine "sprint2",
   sprint_T=32, sprint_mu_switch=1e-4) with the delta endgame (K6 + K1:
   solved, timed as a median of 3, profiled), the steps endgame, and the
   sprint engine under cadence "cond" (K7), each against HiGHS; time K6
   and K7, at cluster sizes 4, 5, 6, 8 and 16 and spilled too; hold K4
   against its
   plain version in its plan's form (the conic cases of phase
   4, from the cold start and at k0=64, then mid-chunk stops); solve a
   fresh dim-1020 batch with `phase1="sprint"` (K4 + K3) against the
   known optima, time it as a median of 3 and profile one solve; hold K8
   against its plain version in f32 and f64, including the prox
   arguments where the reference's guarded form fails; time K4 (at
   cluster sizes 4, 6, 8 and 16 in every residency that fits and
   spilled) and K8;
6. the shape repair: every kernel takes every shape, spilling its
   layout to a global workspace where no shared memory holds a CTA.
   With the launch plans held to no shared memory
   (`device.limit_shared_memory(0)`), hold K1, K2, K3, K4, K6 and K7
   spilled against their plain versions (the parity checks of phases
   3-5) and solve fresh LP sprint2 + delta and conic phase1="sprint"
   batches that way; then a conic batch of n=14,500 (10 SOC(5), 5
   RSOC(4), the rest nonneg, m=50), whose lane one block per lane could
   not hold in shared memory, solved on the card through the kernels
   (K2 with A streamed through L2 at C=6): every lane Solved within 1e-5
   of its known optimum, as the reference solves it;
7. the single-instance front door: three fresh dim-1020 instances
   through `solve_qcp` with conic defaults (dense "chol", Woodbury form)
   and again with dense_mode="inverse_mixed", rho_y=1e-3; a diagonal Q
   and a full PSD Q (the primal form); one n=5100 instance of
   `tools/conic_bench.family(scale=25)`, where linsys "auto" takes the CG
   Schur solver; a warm start, a checkpointed and resumed solve and
   `update_problem` on one workspace; every file of the committed
   cblib_mini (.cbf), conic_mini (.mat) and netlib_mini (.mps, sparse,
   K5 counted) suites through the CLI's own functions, and one
   `python -m abip_tpu_torch FILE.cbf --json`; each against its known
   optimum (the .mps against scipy's HiGHS) within 1e-5; then a profile
   of one dim-1020 solve (busy share, launches per ADMM iteration, top
   device operations);
8. the rest of the batched conic driver, at dim-1020 as phase 4: sprint2
   with straggler compaction (B=16 with compact_period 0 and 2048 in
   turns, B=48 at the defaults, phase1="sprint" compacted), K3 held to
   its plain version at the first compaction round's bucket (duplicated
   lanes, the prepared setup sliced to it); the steps endgame and the
   steps engine at B=16 (`tools/conic_bench.py`'s options, profiled over
   its first barrier stages), precision "f64" and a full PSD Q at B=4;
   `solve_qcp_device` at its defaults; `host_polish` of a k_cap-stopped
   lane on the card; `solve_qcp_het_batch` over the conic_mini and
   cblib_mini suites, as one padded batch and per instance; the LASSO and
   SVM front doors (`solve_lasso`, `solve_lasso_batch` against a FISTA
   oracle, `solve_svm` in both forms against each other).  Each part
   prints its wall, ADMM counts and K2/K3/K4 launches;
9. the rest of the single-card port: B=8 same-pattern PageRank families
   (`tools/pagerank_batch_bench._family`'s construction) at n = 1e4 and
   1e5 through `solve_lp_batch_coo` (every lane at 1'x = 1 within 1e-5;
   profiled over the first 3 barrier stages); 48 smoke LPs through the
   lane-swap stream (B=16, seg_chunks=32, qres_period=64) and through
   three fixed delta batches, each against HiGHS; 8 smoke LPs through
   the thread pool at 1 and 4 workers (equal bit for bit, K1 counted,
   then held to its plain version from a worker thread's stream);
   restarted PDHG on every netlib_mini .mps (`solve_mps(method="pdhg")`)
   and cblib_mini .cbf and on a B=16 mixed-precision smoke batch;
   crossover (`python -m abip_tpu_torch blend01.mps --crossover --json`,
   then every netlib_mini ADMM solve of phase 7); `solve_lp_grad` on a
   smoke LP (the gradient against y and central differences, one
   batched forward) and `solve_lasso_grad` (against a central
   difference);
10. the multi-card layer on a one-rank NCCL group (`one_rank_nccl`: NCCL
   that cannot form fails the run, no gloo fallback), each at full size
   against its unsharded run: `make_sharded_kkt_solver` on the host
   LP's A made dense (m=1000, n=10000, f64) against a dense solve of the
   KKT system on the card; `LPWorkspace.shard(linsys="dense")` on that
   instance (equal status and counts, pobj to 1e-9, within 1e-5 of
   HiGHS) and `shard(linsys="cg")` at m=200; `ConicWorkspace.shard` on a
   dim-1020 instance through the CG Schur solver; `solve_lp_batch(mesh=)`
   on the B=16 smoke batch (K1, counted as `mesh_launches`) and
   `solve_lp_pdhg_batch(mesh=)` on phase 9's batch.  It prints each wall
   and the ratio sharded/unsharded: on one rank the collectives'
   overhead, not scaling;
11. the validators and examples: K2 and K3 held to their plain versions
   on the fuzz_conic zero_mixed and mixed batches (free and zero cone
   blocks, dim 21, m 7, 18 lanes; K2 over its first iteration in trips
   of 1, as the tool launches it, and on the whole of phase 1 in trips of
   PROBE with the noise floor; K3 at its first launch of the tool's
   run); `tools.fuzz_conic` with
   --batched --engine sprint2 on every class (FUZZ_PER_CLASS lanes, each
   class cut before its first lane over FUZZ_LANE_CAP lockstep
   iterations in r05), each lane beside
   `benchmarks/results/r05_conic_fuzz_ladder.jsonl`; its host driver and
   PDHG routes on FUZZ_HOST_CLASSES; every file of mittelmann_mini and
   mip17_mini through `solve_mps` with dense=False (K5 held to its plain
   version on each A and A' that packs BCSR, counted as
   `suite_launches`) and dense, against HiGHS; beside these,
   BESIDE_WORKERS at a time, each a process of its own on the card: the
   eight examples of `abip_tpu_torch/examples/` and `python -m
   abip_tpu_torch.tools.fuzz_scipy`.  Every run must exit 0 and every
   validator count no mismatch.

    python3 chip_smoke.py --ab PARENT

times K2 and K4 in this checkout and in the checkout at PARENT (the
parent commit, unpacked with `git archive`), each in a process of its
own, in the order this, PARENT, this, and prints their times.

Each main path runs with its kernels' launch counts set to 0 just
before it and read just after (K5 also on the MPS route of phase 7,
`mps_route_launches`; K2, K3 and K4 on phase 8's paths,
`batched_rest_launches`; K1 in phase 9's thread pool,
`pool_launches`, and over phase 10's mesh, `mesh_launches`; K2 and K3
per fuzz_conic class, `fuzz_launches`; K5 on phase 11's suites,
`suite_launches`).  Exits nonzero, printing no result, without a card or
on any failure.  The last three lines are the kernel summary
(JSON, with each kernel's bound on this card), the card's name and power
limit, and the result (JSON).
"""
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE = dict(m=50, n_rand=1950)
SOLVE_KW = dict(eps=1e-6, max_ipm=200, max_admm=200_000, solver="inverse",
                qres_period=1536, avg_period=20, precision="mixed",
                engine="delta", cadence="chunk")
B = 16
PROBE = 8
# every kernel source of the port, built side by side
SOURCES = ("admm_delta", "admm_sprint", "conic_ladder", "conic_sprint",
           "conic_delta", "bcsr_spmv", "barrier_step")
# the LP sprint engines: `bench.py`'s smoke options with the sprint2 knobs
SPRINT_KW = dict(SOLVE_KW, engine="sprint2", sprint_T=32,
                 sprint_mu_switch=1e-4)
# a phase-1 barrier for the LP sprint kernels' parity (they run above the
# 1e-4 switch)
SPRINT_LAM = 1e-3
# Kernel vs plain version: rtol 2e-5 plus 1e-5 of each output's largest
# magnitude (at least 1).  Both run f32 reductions in different orders;
# each sits about that far from an f64 run of the same recurrence.
RTOL, REL_SCALE = 2e-5, 1e-5
# the stricter tolerance of the reference's own kernel test, reported
STRICT_RTOL, STRICT_ATOL = 2e-5, 1e-6
# The kernel may be no less accurate than the plain version: its largest
# distance from the f64 run is at most this multiple of the plain one's.
ACC_RATIO = 3.0

# The conic path: `tools/conic_bench.family(scale=5)` and the options of
# `tools/conic_bench.py:338-373` (sprint2: ladder phase 1, delta endgame).
CONIC_SPEC = dict(soc=(125, 125), rsoc=(20,), nonneg=750)   # n = 1020
CONIC_M = 340                                               # n // 3
CONIC_KW = dict(engine="sprint2", eps=1e-6, precision="mixed",
                normalize=True, rho_y=1e-3, max_admm=1_000_000,
                solver="inverse", inner_crit_period=512, probe_period=8)
# the small primal-form batch with a diagonal Q (m > n/2)
SMALL_SPEC = dict(soc=(5,), rsoc=(4,), nonneg=10)
SMALL_M = 12
# The conic f32 recurrences amplify rounding in y, the free block
# (y = (wy - A zx) / rho_y): its absolute term is REL_SCALE / rho_y of
# the scale.  The inner criterion at the last probe (slot 2 of the
# output row) is an f32 noise-floor value: after phase 1 at dim-1020
# both f32 versions of the ladder sit 10-25% from an f64 run's value
# (NVIDIA H100 80GB HBM3, 700 W); the decisions taken on it (t_done,
# stages, mu) are checked for equality, its value to rtol 0.25.
Y_AMPLIFY = 1.0 / CONIC_KW["rho_y"]
ERR_RTOL = 0.25
# The JAX package run on a CPU, seeds 8000-8015 with CONIC_KW (ADMM
# iterations per lane; its IPM counts were 10-12 per lane).
JAX_CPU_ADMM = (272, 240, 1216, 2416, 392, 656, 288, 456, 3088, 296, 176,
                184, 176, 120, 408, 1496)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def smoke_batch(seed0, count=B, **shape):
    from bench import reference_smoke_lp

    data = [reference_smoke_lp(seed=seed0 + i, **(shape or SMOKE))
            for i in range(count)]
    return data, tuple(np.stack(x) for x in zip(*data))


def mid_solve_state(torch, stacks, dev, steps=200, sprint=False):
    """The port's f64 setup of a batch (the delta engine's, or with
    `sprint` the sprint engine's) and a state advanced by absolute f64
    ADMM steps through three barrier stages."""
    from abip_tpu_torch import hsd
    from abip_tpu_torch.ops.admm_delta import _mv, _rmv
    from abip_tpu_torch.parallel.batched import setup_delta, setup_steps

    As, bs, cs = (torch.as_tensor(x, dtype=torch.float64, device=dev)
                  for x in stacks)
    S = (setup_steps(As, bs, cs, sprint=True, solver="inverse") if sprint
         else setup_delta(As, bs, cs))
    nb, m, n = As.shape
    l = m + n + 1
    rho_y, alpha = 1e-3, 1.8

    def step(u, v, mu):
        r = u + v
        q = torch.cat([rho_y * r[:, :m], r[:, m:m + n]], 1) \
            - r[:, l - 1:] * S.h
        q = q - ((q * S.g).sum(-1) / (S.g_th + 1.0))[:, None] * S.h
        wx = -q[:, m:]
        z_y = S.solve64(q[:, :m] + _mv(S.A_s, wx))
        z_x = _rmv(S.A_s, z_y) - wx
        tau_t = r[:, l - 1] + (z_y * S.h[:, :m]).sum(-1) \
            + (z_x * S.h[:, m:]).sum(-1)
        u_t = torch.cat([z_y, z_x, tau_t[:, None]], 1)
        return hsd.admm_update(u, v, u, u_t, mu, alpha, m)

    u = torch.cat([torch.zeros((nb, m), dtype=torch.float64, device=dev),
                   torch.ones((nb, l - m), dtype=torch.float64, device=dev)],
                  1)
    v = u.clone()
    for mu in (1.0, 1e-2, 1e-4):
        for _ in range(steps):
            u, v = step(u, v, mu)
    return S, u, v


def make_anchor(torch, S, u, v, thresh):
    from abip_tpu_torch.ops.admm_delta import delta_anchor

    nb, l = u.shape
    z = torch.zeros_like(u)
    return delta_anchor(
        S.A_s, S.solve64, S.h, S.g, S.g_th, 1e-3, 1e-5, 1.8, thresh, u, v,
        z, z, torch.zeros((nb,), dtype=torch.int32, device=u.device),
        float("inf"), A32=S.A32, Ninv32=S.Ninv32)


def compare(ker, plain, label):
    """Raise unless every kernel output is within the stated tolerance of
    the plain version's; return the largest absolute difference and
    whether the stricter reference tolerance held too."""
    names = ("dy", "dx", "dvx", "dsy", "dsx", "dsvx", "row")
    worst, strict = 0.0, True
    for name, k, p in zip(names, ker, plain):
        k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
        if not np.isfinite(k).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        diff = np.abs(k - p)
        worst = max(worst, float(diff.max()))
        atol = REL_SCALE * max(1.0, float(np.abs(p).max()))
        if (diff > RTOL * np.abs(p) + atol).any():
            raise AssertionError(
                f"{label}: kernel {name} differs from the plain version by "
                f"{float(diff.max()):.3e} (allowed rtol {RTOL} + atol "
                f"{atol:.3e})")
        strict &= bool((diff <= STRICT_RTOL * np.abs(p) + STRICT_ATOL).all())
    return worst, strict


# K1's parity shapes: the smoke shape, a ragged one, and one whose CTAs
# cannot hold A's slice and Ninv, so that they read them through L2
K1_CASES = (("smoke B=16 m=50 n=2000", SMOKE, B),
            ("ragged B=5 m=37 n=411", dict(m=37, n_rand=374), 5),
            ("L2-streaming B=4 m=200 n=3000", dict(m=200, n_rand=2800), 4))


# a cluster plan's form, by (resident, spill)
FORMS = {(True, False): "resident", (False, False): "A through L2",
         (False, True): "A through L2, spilled"}


def k1_parity(torch, dev, label, shape, nb):
    """K1 against its plain version on mid-solve anchors of one shape:
    T=64 at thresh=0 (equal t_done, every output within the stated
    tolerance, at most ACC_RATIO times the plain version's distance from
    an f64 run); then thresholds just above each lane's criterion after
    64 iterations, which stop lanes mid-chunk (t_done within one probe).
    Returns the largest |kernel - plain|."""
    from abip_tpu_torch.ops.admm_delta import (
        _delta_compute, delta_chunk_cuda, delta_launch_plan,
        delta_max_active_clusters)

    _, stacks = smoke_batch(500, nb, **shape)
    S, u, v = mid_solve_state(torch, stacks, dev)
    anc = make_anchor(torch, S, u, v, 0.0)
    _, m, n = anc.A.shape
    plan = delta_launch_plan(m, n)
    if not plan.spill and label.startswith("L2") == plan.resident:
        raise AssertionError(f"{label}: plan {plan}")
    t_max = torch.full((nb,), 64, dtype=torch.int32, device=dev)
    ker = delta_chunk_cuda(anc, t_max, PROBE)
    plain = _delta_compute(anc, t_max, PROBE)
    torch.cuda.synchronize()
    if not torch.equal(ker[6][:, 5], plain[6][:, 5]):
        raise AssertionError(f"{label}: t_done differs")
    err, strict = compare(ker, plain, label)
    exact = _delta_compute(type(anc)(*[x.double() for x in anc]), t_max, PROBE)
    kerr = max(float((k.double() - e).abs().max()) for k, e in zip(ker, exact))
    perr = max(float((p.double() - e).abs().max())
               for p, e in zip(plain, exact))
    if kerr > ACC_RATIO * perr:
        raise AssertionError(
            f"{label}: kernel is {kerr:.3e} from the f64 run, more than "
            f"{ACC_RATIO}x the plain version's {perr:.3e}")
    print(f"parity K1 {label} T=64 ({plan.cluster} CTAs a lane, "
          f"{FORMS[plan.resident, plan.spill]}, "
          f"{plan.smem_bytes} B shared memory, "
          f"{delta_max_active_clusters(m, n, plan)} clusters at once): "
          f"max|kernel-plain|={err:.3e} (rtol {RTOL} + {REL_SCALE}*scale: "
          f"ok; rtol {STRICT_RTOL} atol {STRICT_ATOL}: "
          f"{'ok' if strict else 'exceeded'}); vs f64 run: kernel "
          f"{kerr:.3e}, plain {perr:.3e} (kernel at most {ACC_RATIO}x: ok); "
          f"t_done equal")
    anc = make_anchor(torch, S, u, v, 1.05 * plain[6][:, 4].double())
    t_max = torch.full((nb,), 256, dtype=torch.int32, device=dev)
    tk = delta_chunk_cuda(anc, t_max, PROBE)[6][:, 5].cpu().numpy()
    tp = _delta_compute(anc, t_max, PROBE)[6][:, 5].cpu().numpy()
    tk, tp = tk.astype(int).tolist(), tp.astype(int).tolist()
    if min(tp) >= 256:
        raise AssertionError(f"{label} stop case: no lane stopped mid-chunk")
    if max(abs(a - b) for a, b in zip(tk, tp)) > PROBE:
        raise AssertionError(f"{label} stop case: t_done {tk} vs plain {tp}")
    print(f"parity K1 {label} stop-mid-chunk T=256: t_done kernel {tk} plain "
          f"{tp} (within one probe)")
    return err


def phase_kernel_parity(torch, dev):
    return max(k1_parity(torch, dev, *case) for case in K1_CASES)


def solve(torch, stacks, dev):
    from abip_tpu_torch.parallel.batched import solve_lp_batch

    return solve_lp_batch(*stacks, device=dev, **SOLVE_KW)


def phase_main_path(torch, dev):
    from abip_tpu_torch.ops.admm_delta import (delta_chunk_cuda,
                                               delta_launch_plan)
    from abip_tpu_torch.utils.timing import wall_s

    data, stacks = smoke_batch(1000)
    delta_chunk_cuda.launches = 0
    sec, res = wall_s(lambda: solve(torch, stacks, dev))
    launches = delta_chunk_cuda.launches
    status = res.status.cpu().numpy()
    iters = res.admm_iters.cpu().numpy()
    solved = int((status == 1).sum())
    print(f"main path B=16 smoke eps=1e-6 T=1536: solved {solved}/{B}, "
          f"ADMM iterations total {int(iters.sum())} mean {iters.mean():.1f}"
          f", IPM mean {res.ipm_iters.double().mean().item():.1f}, wall "
          f"{sec:.3f} s (first solve, includes warm-up), "
          f"{iters.sum() / sec:.1f} ADMM it/s, K1 launches {launches} "
          f"({delta_launch_plan(*stacks[0].shape[1:])})")
    lp_vs_highs(data, res, "main path")
    if launches <= 0:
        raise AssertionError("main path did not launch the kernel")
    return launches


def highs_worst_gap(data, pobjs, label):
    """Raise unless every objective is within 1e-5 relative of scipy's
    HiGHS; returns the largest relative gap."""
    from scipy.optimize import linprog

    worst = 0.0
    for i, ((A, b, c), p) in enumerate(zip(data, pobjs)):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        if ref.status != 0:
            raise AssertionError(f"scipy failed on instance {i}: "
                                 f"{ref.message}")
        rel = abs(p - ref.fun) / max(1.0, abs(ref.fun))
        worst = max(worst, rel)
        if not rel <= 1e-5:
            raise AssertionError(f"{label} instance {i}: pobj {p} vs HiGHS "
                                 f"{ref.fun} (rel {rel:.2e})")
    return worst


def lp_vs_highs(data, res, label):
    """Raise unless every lane is Solved, finite and within 1e-5 relative
    of scipy's HiGHS."""
    status = res.status.cpu().numpy()
    pobj = res.pobj.cpu().numpy()
    if (status != 1).any():
        raise AssertionError(f"{label}: statuses {status.tolist()}")
    if not (np.isfinite(res.x.cpu().numpy()).all() and np.isfinite(pobj).all()):
        raise AssertionError(f"{label}: non-finite solution")
    worst = highs_worst_gap(data, pobj, label)
    print(f"{label} vs scipy HiGHS: {len(data)}/{len(data)} solved, max "
          f"relative objective gap {worst:.3e} (limit 1e-5)")


# the cluster sizes K1 is timed at (16 is beyond the portable 8)
K1_CLUSTERS = (4, 5, 6, 8, 16)


def phase_timing(torch, dev, card):
    from abip_tpu_torch.ops.admm_delta import (
        DeltaPlan, _delta_compute, delta_chunk_cuda, delta_launch_plan,
        delta_max_active_clusters, delta_smem_bytes)
    from abip_tpu_torch.utils.timing import cuda_ms, wall_s

    walls = []
    for seed0 in (2000, 3000, 4000):
        _, stacks = smoke_batch(seed0)
        sec, res = wall_s(lambda: solve(torch, stacks, dev))
        its = int(res.admm_iters.sum())
        ok = int((res.status == 1).sum())
        walls.append((sec, its, ok))
        print(f"timing solve seeds {seed0}+: {sec:.4f} s, {its} ADMM it, "
              f"{its / sec:.1f} it/s, {B / sec:.3f} inst/s, solved {ok}/{B}")
    sec, its, ok = sorted(walls)[1]
    print(f"timing solve median of 3 [{card}]: {sec:.4f} s, "
          f"{its / sec:.1f} ADMM it/s aggregate, {B / sec:.3f} instances/s")
    _, stacks = smoke_batch(5000)
    S, u, v = mid_solve_state(torch, stacks, dev)
    anc = make_anchor(torch, S, u, v, 0.0)
    t_max = torch.full((B,), 1536, dtype=torch.int32, device=dev)
    _, m, n = anc.A.shape
    plan = delta_launch_plan(m, n)
    # each cluster size K1 can take, resident, on the same anchors
    for size in K1_CLUSTERS:
        p = DeltaPlan(size, True, delta_smem_bytes(m, n, size, True))
        t = cuda_ms(lambda: delta_chunk_cuda(anc, t_max, PROBE, plan=p),
                    iters=5)
        print(f"timing K1 chunk T=1536 B=16 m=50 n=2000 C={size} [{card}]: "
              f"{t:.3f} ms ({t * 1e3 / 1536:.2f} us/iteration), resident, "
              f"{p.smem_bytes} B shared memory, "
              f"{delta_max_active_clusters(m, n, p)} clusters at once")
    p = delta_launch_plan(m, n, 0)
    t = cuda_ms(lambda: delta_chunk_cuda(anc, t_max, PROBE, plan=p), iters=3)
    print(f"timing K1 chunk T=1536 B=16 m=50 n=2000 C={p.cluster} [{card}]: "
          f"{t:.3f} ms ({t * 1e3 / 1536:.2f} us/iteration), spilled (the "
          f"layout in global memory), "
          f"{delta_max_active_clusters(m, n, p)} clusters at once")
    ms = cuda_ms(lambda: delta_chunk_cuda(anc, t_max, PROBE), iters=5)
    plain_ms = cuda_ms(lambda: _delta_compute(anc, t_max, PROBE), iters=3)
    # per iteration A'dz and A dwx (two A passes) and the Ninv apply; per
    # probe four more A passes (current and averaged criterion)
    outs = delta_chunk_cuda(anc, t_max, PROBE)
    t_done = outs[6][:, 5].int().tolist()
    bms, by = kernel_bound(list(anc) + [t_max], outs, outs[6][:, 5],
                           4 * m * n + 2 * m * m + 8 * m * n / PROBE)
    print(f"timing K1 chunk T=1536 B=16 m=50 n=2000 [{card}]: kernel "
          f"{ms:.3f} ms ({ms * 1e3 / 1536:.2f} us/iteration; the plan's "
          f"C={plan.cluster}), plain version {plain_ms:.3f} ms, bound "
          f"{bms:.4f} ms ({by}); t_done per lane {t_done}")
    # the f64 pieces around the kernel, each issued from the host as the
    # solver issues them (event time includes the device's waits)
    from abip_tpu_torch import hsd
    from abip_tpu_torch.ops.admm_delta import _mv, _rmv
    from abip_tpu_torch.parallel.batched import setup_delta

    As, bs, cs = (torch.as_tensor(x, device=dev) for x in stacks)
    _, m, n = As.shape
    setup_ms = cuda_ms(lambda: setup_delta(As, bs, cs), iters=3)
    anchor_ms = cuda_ms(lambda: make_anchor(torch, S, u, v, 0.0))
    check_ms = cuda_ms(lambda: hsd.lp_residuals(
        u, v, lambda x: _mv(S.A_s, x), lambda y: _rmv(S.A_s, y), S.b_s,
        S.c_s, S.pr_scale, S.dr_scale, S.obj_scale, S.nm_b0, S.nm_c0, m, n))
    print(f"timing f64 pieces B=16 [{card}]: setup {setup_ms:.3f} ms per "
          f"batch, anchor {anchor_ms:.3f} ms and residual check "
          f"{check_ms:.3f} ms per chunk")
    return ms, plain_ms, bms, by


def profile_solve(torch, run, kernels, label):
    """Device time of one solve by kernel, from the profiler; `kernels`
    maps a label to a substring (or a tuple of substrings) of kernel
    names.  Only the device is recorded, and only its kernel events are
    summed.  The busy share is given against the profiled wall and
    against an unprofiled run of the same solve just before it.
    Returns {"launches", "busy_us", "sec", "plain_sec"}, or None where
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from abip_tpu_torch.utils.timing import wall_s

    plain_sec, _ = wall_s(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sec, _ = wall_s(run)

    def dev_us(e):
        for key in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, key):
                return float(getattr(e, key))
        return 0.0

    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
              if str(getattr(e, "device_type", "CUDA")).endswith("CUDA")]
    total = sum(us for _, us, _ in events)
    if total <= 0.0:
        print(f"profile {label}: the profiler recorded no device time (not "
              "measured)")
        return None
    shares, named = [], 0.0
    for name, subs in kernels.items():
        subs = (subs,) if isinstance(subs, str) else subs
        us = sum(t for k, t, _ in events if any(s in k for s in subs))
        named += us
        shares.append(f"{name} {us / 1e3:.1f} ms = {100 * us / total:.1f}%")
    shares.append(f"the rest {(total - named) / 1e3:.1f} ms = "
                  f"{100 * (total - named) / total:.1f}%")
    print(f"profile {label} (wall {sec:.3f} s under the profiler, "
          f"{plain_sec:.3f} s without): device busy {total / 1e3:.1f} ms = "
          f"{100 * total / 1e6 / sec:.1f}% of the profiled wall, "
          f"{100 * total / 1e6 / plain_sec:.1f}% of the unprofiled one; "
          f"{', '.join(shares)} of device time")
    for key, us, count in sorted(events, key=lambda e: -e[1])[:6]:
        print(f"profile   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    return {"launches": sum(c for _, _, c in events), "busy_us": total,
            "sec": sec, "plain_sec": plain_sec}


def phase_profile(torch, dev):
    _, stacks = smoke_batch(6000)
    profile_solve(torch, lambda: solve(torch, stacks, dev),
                  {"K1": "delta_cluster_kernel"}, "one LP solve")


# ---------------------------------------------------------------------------
# the conic path
# ---------------------------------------------------------------------------

def conic_batch(seed0=None, count=B, spec=None, m=CONIC_M, diag_q=False,
                fuzz=None):
    """(cones, (As, bs, cs, Qs or None), optima) of `count` instances:
    `randcone` (with `diag_q`, `randqcp` with a diagonal Q) from the
    seeds seed0, seed0 + 1, ..., or, with `fuzz`, the first `count`
    instances of that `tools.fuzz_conic` class."""
    from abip_tpu_torch.cones import ConeSpec
    from abip_tpu_torch.tools.fuzz_conic import instances
    from abip_tpu_torch.tools.generate import randcone, randqcp

    if fuzz is not None:
        cones, data = instances(fuzz, count)
    else:
        cones = ConeSpec(**(spec or CONIC_SPEC))
        data = []     # (name, A, b, c, Q or None, optimum), as instances
        for i in range(count):
            if diag_q:
                name, A, b, c, Q, _, star = randqcp("q", m, cones, seed0 + i,
                                                    q_rank="diag")
            else:
                name, A, b, c, _, star = randcone("c", m, cones, seed0 + i)
                Q = None
            data.append((name, A, b, c, Q, star))
    Qs = None if data[0][4] is None else np.stack([d[4] for d in data])
    stacks = tuple(np.stack([d[k] for d in data]) for k in (1, 2, 3))
    return cones, stacks + (Qs,), np.asarray([d[-1] for d in data])


def conic_prepared(torch, cones, stacks, dev):
    from abip_tpu_torch.parallel.batched_qcp import prepare_conic_batch

    As, bs, cs, Qs = (None if x is None else torch.as_tensor(
        x, dtype=torch.float64, device=dev) for x in stacks)
    return prepare_conic_batch(As, bs, cs, Qs, cones=cones,
                               rho_y=CONIC_KW["rho_y"], precision="mixed")


def _hinv(torch, P):
    if P.dss.form == "woodbury":
        return P.dss.H_inv
    return torch.zeros_like(P.c)


def cold_ladder_operands(torch, P, cones):
    """The operands of phase 1's first ladder launch (cold start, mu=1,
    tol=4, k0=0), as the solver packs them."""
    from abip_tpu_torch.cones import ConeLayout
    from abip_tpu_torch.ops.conic_dr import ladder_operands

    nb, m, n = P.A.shape
    x0 = ConeLayout(cones).interior_point(torch.float64, P.A.device)
    u = torch.cat([torch.zeros((nb, m), dtype=torch.float64, device=P.A.device),
                   x0.expand(nb, n),
                   torch.ones((nb, 1), dtype=torch.float64,
                              device=P.A.device)], dim=1).float()
    Qd = P.Q_diag if P.Q_diag is not None else torch.zeros_like(P.c)
    return ladder_operands(
        P.A.float(), P.dss.Minv64.float(), _hinv(torch, P).float(),
        P.r_vec.float(), P.b.float(), P.c.float(), Qd.float(), P.D.float(),
        P.E.float(), CONIC_KW["rho_y"], 1.0, 1.0, P.a_coef, 1.0, 4.0, 1e-3,
        CONIC_KW["eps"], P.sc_b, P.sc_c, P.nm_inf_b0, P.nm_inf_c0, 1.8, u,
        u.clone(), 0.0)


def conic_phase1_state(torch, P, cones, **over):
    """The solver's phase 1 (ladder) run to the 1e-3 switch with
    CONIC_KW's options (`over` replaces some): a mid-solve state for the
    delta chunk."""
    from abip_tpu_torch.parallel.batched_qcp import _solve

    kw = {k: v for k, v in CONIC_KW.items() if k not in ("engine",
                                                          "normalize")}
    kw.update(over)
    r = _solve(None, None, None, P.Q_diag, cones=cones, engine="ladder",
               mu_stop=1e-3, prepared=P, **kw)
    if (r.status != 0).any() or (r.mu >= 1e-3).any():
        raise AssertionError(f"phase 1 did not stop at the switch: status "
                             f"{r.status.tolist()}, mu {r.mu.tolist()}")
    return r


def conic_anchor(torch, P, cones, st, thresh, q_init=float("inf")):
    from abip_tpu_torch.cones import ConeLayout
    from abip_tpu_torch.ops.conic_delta import conic_delta_anchor

    m = P.A.shape[1]
    return conic_delta_anchor(
        P.A, P.dss.solve, P.Q_diag, P.r_vec[:, :m], P.r_vec[:, m:], P.b,
        P.c, P.a_coef, CONIC_KW["rho_y"], 1.0, 1.0, st.mu, 1.8, thresh,
        st.u_raw, st.v_raw, q_init, ConeLayout(cones), P.A.float(),
        P.dss.Minv64.float(), _hinv(torch, P).float())


def compare_conic(ker, plain, names, label, amplified=("y", "dy"),
                  rel_scale=REL_SCALE, floor=None):
    """Raise unless every kernel output is within the stated tolerance of
    the plain version's: rtol 2e-5 plus `rel_scale` of the output's
    largest magnitude, that absolute term times 1/rho_y for the conic
    free block (`amplified`) and at least `floor[name]` where given (a
    number, or one per column), and ERR_RTOL for the inner criterion
    (slot 2 of the row).  Return the largest absolute difference."""
    worst = 0.0
    for name, k, p in zip(names, ker, plain):
        k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
        if not np.isfinite(k).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        diff = np.abs(k - p)
        worst = max(worst, float(diff.max()))
        atol = rel_scale * max(1.0, float(np.abs(p).max()))
        if name in amplified:
            atol *= Y_AMPLIFY
        least = np.broadcast_to((floor or {}).get(name, 0.0), p.shape[1:])
        allowed = RTOL * np.abs(p) + np.maximum(atol, least)
        if name == "row":
            allowed[:, 2] = np.maximum(ERR_RTOL * np.abs(p[:, 2]), least[2])
        if (diff > allowed).any():
            i = np.unravel_index(np.argmax(diff - allowed), diff.shape)
            raise AssertionError(
                f"{label}: kernel {name}{list(i)} = {k[i]!r} differs from the "
                f"plain version's {p[i]!r} by more than {allowed[i]:.3e}")
    return worst


def accuracy_vs_f64(ker, plain, exact, label):
    """(kernel, plain) largest distances from the f64 run; raise unless
    the kernel's is at most ACC_RATIO times the plain version's."""
    kerr = max(float((k.double() - e).abs().max()) for k, e in zip(ker, exact))
    perr = max(float((p.double() - e).abs().max())
               for p, e in zip(plain, exact))
    if kerr > ACC_RATIO * perr:
        raise AssertionError(
            f"{label}: kernel is {kerr:.3e} from the f64 run, more than "
            f"{ACC_RATIO}x the plain version's {perr:.3e}")
    return kerr, perr


CONIC_CASES = (("dim-1020 B=16 Woodbury", dict(seed0=8400)),
               ("small primal diag-Q B=5 m=12 n=19",
                dict(seed0=40, count=5, spec=SMALL_SPEC, m=SMALL_M,
                     diag_q=True)))


def dr_form_plan(torch, P, co, form):
    """The `DeltaPlan` of K2/K4 for a prepared batch in `form` =
    (cluster, resident) or (cluster, "spill"); None for the launch plan's
    own form."""
    from abip_tpu_torch.ops.admm_delta import DeltaPlan
    from abip_tpu_torch.ops.conic_dr import dr_smem_bytes

    if form is None:
        return None
    cluster, resident = form
    if resident == "spill":
        return DeltaPlan(cluster, False, 0, spill=True)
    _, m, n = P.A.shape
    return DeltaPlan(cluster, resident, dr_smem_bytes(
        m, n, co.start.shape[0], cluster, resident,
        P.dss.form == "woodbury"))


# the ladder row's continuous slots (tau, kappa, err, tol); t_done, mu and
# stages are decisions, held equal
LADDER_ROW_CONTINUOUS = (0, 1, 2, 5)


def ladder_noise_floor(names, plain, exact):
    """{output: least absolute term} of K2's noise floor: ACC_RATIO times
    the plain ladder's own largest distance from the f64 run, per output,
    and for the row per continuous slot (0 on the decisions)."""
    floor = {}
    for n, p, e in zip(names, plain, exact):
        far = ACC_RATIO * (p.double() - e).abs().amax(0).cpu().numpy()
        if n == "row":
            keep = np.zeros_like(far)
            keep[list(LADDER_ROW_CONTINUOUS)] = far[
                list(LADDER_ROW_CONTINUOUS)]
            floor[n] = keep
        else:
            floor[n] = float(far.max())
    return floor


def ladder_parity(torch, dev, label, case, form=None, noise_floor=False,
                  T=2048, probe=PROBE):
    """K2 against the plain ladder on phase 1 from the cold start of one
    batch (T iterations at most, in trips of `probe`), in the form of its
    launch plan (or in `form`, as `dr_form_plan` takes it): equal
    t_done, stages and mu; the stated tolerance; at most ACC_RATIO times
    the plain version's distance from an f64 run.  With `noise_floor`,
    the absolute terms are at least `ladder_noise_floor`'s (where the
    f32 ladder is that noisy, as on fuzz_conic's small batches over the
    whole phase 1, any other f32 order of the sums lands that far
    apart).  Returns the largest |kernel - plain|."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_dr import (LadderOperands,
                                             _dr_ladder_compute, ladder_cuda)

    cones, stacks, _ = conic_batch(**case)
    P = conic_prepared(torch, cones, stacks, dev)
    op = cold_ladder_operands(torch, P, cones)
    co = cone_operands(cones, dev)
    plan = dr_form_plan(torch, P, co, form)
    print(f"K2 {label}: {dr_plan_line(torch, P, co, 'ladder', plan)}")
    t_max = torch.full((op.A.shape[0],), T, dtype=torch.int32, device=dev)
    run = dict(probe=probe, psi=1.0, woodbury=P.dss.form == "woodbury")
    ker = ladder_cuda(op, co, t_max, plan=plan, **run)
    plain = _dr_ladder_compute(op, co, t_max, **run)
    exact = _dr_ladder_compute(LadderOperands(*[x.double() for x in op]), co,
                               t_max, **run)
    torch.cuda.synchronize()
    for col, what in ((3, "t_done"), (6, "stages"), (4, "mu")):
        if not torch.equal(ker[4][:, col], plain[4][:, col]):
            raise AssertionError(
                f"K2 {label}: {what} differs: kernel "
                f"{ker[4][:, col].tolist()} plain {plain[4][:, col].tolist()}")
    names = ("y", "x", "vy", "vx", "row")
    floor = ladder_noise_floor(names, plain, exact) if noise_floor else None
    err = compare_conic(ker, plain, names, f"K2 {label}", floor=floor)
    kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K2 {label}")
    if noise_floor:        # y, the free block, on its own too
        accuracy_vs_f64(ker[:1], plain[:1], exact[:1], f"K2 {label} y")
    noise = "" if floor is None else (
        ", absolute terms at least " + ", ".join(
            f"{n} {np.max(v):.2e}" for n, v in floor.items())
        + " (the noise floor; the row's per continuous slot)")
    print(f"parity K2 {label} {P.dss.form} phase 1 (T={T}, probe {probe}, "
          f"mu_stop 1e-3): "
          f"t_done {int(ker[4][0, 3])}, stages {int(ker[4][0, 6])}, mu "
          f"{float(ker[4][0, 4]):.4e} equal on every lane; max|kernel-plain| "
          f"{err:.3e} (stated tolerance{noise}: ok); vs f64 run: kernel "
          f"{kerr:.3e}, plain {perr:.3e} (kernel at most {ACC_RATIO}x: ok)")
    return err


def delta_parity_at(torch, dev, label, P, cones, st, plan=None, T=64,
                    probe=PROBE):
    """K3 against the plain chunk from the state `st` (`u_raw`, `v_raw`,
    `mu` per lane) on the prepared setup `P`: T iterations in trips of
    `probe` with thresh=0, equal t_done, the stated tolerance and the
    accuracy ratio against an f64 run, in the form of the launch plan or
    of `plan`.  Returns (the anchor, the largest |kernel - plain|)."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_delta import (ConicDeltaAnchor,
                                                _conic_delta_compute,
                                                conic_delta_cuda)

    co = cone_operands(cones, dev)
    nb = P.A.shape[0]
    print(f"K3 {label}: {k3_plan_line(torch, P, co, plan)}")
    anc = conic_anchor(torch, P, cones, st, 0.0)
    t_max = torch.full((nb,), T, dtype=torch.int32, device=dev)
    run = dict(probe=probe, woodbury=P.dss.form == "woodbury")
    ker = conic_delta_cuda(anc, co, t_max, plan=plan, **run)
    plain = _conic_delta_compute(anc, co, t_max, **run)
    exact = _conic_delta_compute(ConicDeltaAnchor(*[x.double() for x in anc]),
                                 co, t_max, **run)
    torch.cuda.synchronize()
    if not torch.equal(ker[4][:, 3], plain[4][:, 3]):
        raise AssertionError(f"K3 {label}: t_done differs")
    err = compare_conic(ker, plain, ("dy", "dx", "dvy", "dvx", "row"),
                        f"K3 {label}")
    kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K3 {label}")
    print(f"parity K3 {label} {P.dss.form} B={nb} T={T} probe {probe}: "
          f"t_done equal; "
          f"max|kernel-plain| {err:.3e} (stated tolerance: ok); vs f64 run: "
          f"kernel {kerr:.3e}, plain {perr:.3e} (kernel at most {ACC_RATIO}x: "
          f"ok)")
    return anc, err


def delta_parity(torch, dev, label, case, plan=None):
    """K3 against the plain chunk on the state phase 1 hands to the
    endgame: T=64 with thresh=0 (equal t_done, the stated tolerance, the
    accuracy ratio), then thresholds that stop the lanes mid-chunk
    (`decisive_thresholds`; t_done within one probe), in the form of the
    launch plan, or of `plan`.  Returns the largest |kernel - plain|."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_delta import (_conic_delta_compute,
                                                conic_delta_cuda)

    cones, stacks, _ = conic_batch(**case)
    P = conic_prepared(torch, cones, stacks, dev)
    st = conic_phase1_state(torch, P, cones)
    co = cone_operands(cones, dev)
    nb = P.A.shape[0]
    anc, err = delta_parity_at(torch, dev, label, P, cones, st, plan)
    run = dict(probe=PROBE, woodbury=P.dss.form == "woodbury")
    thresh, t_stop, drop = decisive_thresholds(
        torch, lambda tm: _conic_delta_compute(anc, co, tm, **run)[4][:, 2],
        nb, dev)
    anc = conic_anchor(torch, P, cones, st, thresh)
    t_max = torch.full((nb,), 256, dtype=torch.int32, device=dev)
    tk = conic_delta_cuda(anc, co, t_max, plan=plan,
                          **run)[4][:, 3].int().tolist()
    tp = _conic_delta_compute(anc, co, t_max, **run)[4][:, 3].int().tolist()
    if tp != t_stop:
        raise AssertionError(f"K3 {label}: plain t_done {tp}, planned {t_stop}")
    if max(abs(a - b) for a, b in zip(tk, tp)) > PROBE:
        raise AssertionError(f"K3 {label}: t_done {tk} vs plain {tp}")
    print(f"parity K3 {label} stop-mid-chunk T=256: t_done kernel {tk} "
          f"plain {tp} (within one probe; each threshold splits a drop of at "
          f"least {min(drop):.3f}x in the plain criterion)")
    return err


def dr_plan_line(torch, P, co, kernel, plan=None):
    """K2's (`kernel="ladder"`) or K4's (`"sprint"`) launch plan for a
    prepared batch (or `plan`), the clusters the card holds at once, and
    the cone blocks that straddle CTAs."""
    from abip_tpu_torch.ops.conic_delta import cluster_block_spans
    from abip_tpu_torch.ops.conic_dr import (dr_launch_plan,
                                             dr_max_active_clusters)

    _, m, n = P.A.shape
    nb = co.start.shape[0]
    wb = P.dss.form == "woodbury"
    plan = plan or dr_launch_plan(m, n, nb, woodbury=wb)
    spans, _ = cluster_block_spans(co.start.cpu(), co.length.cpu(), n,
                                   plan.cluster)
    straddle = sum(lo != hi for lo, hi in spans)
    form = ("A resident, the inverse through L2" if plan.resident else
            "A and the inverse through L2" + (", spilled" if plan.spill
                                              else ""))
    held = dr_max_active_clusters(f"conic_{kernel}", m, n, nb, plan, wb)
    return (f"C={plan.cluster} ({form}, {plan.smem_bytes} B shared memory "
            f"per CTA, {held} clusters at once), {straddle} of {nb} cone "
            f"blocks straddle CTAs")


def k3_plan_line(torch, P, co, plan=None):
    """K3's launch plan for a prepared batch (or `plan`), the clusters the
    card holds at once, and the cone blocks that straddle CTAs."""
    from abip_tpu_torch.ops.conic_delta import (cluster_block_spans,
                                                conic_delta_launch_plan,
                                                conic_delta_max_active_clusters)

    _, m, n = P.A.shape
    nb = co.start.shape[0]
    wb = P.dss.form == "woodbury"
    plan = plan or conic_delta_launch_plan(m, n, nb, woodbury=wb)
    spans, _ = cluster_block_spans(co.start.cpu(), co.length.cpu(), n,
                                   plan.cluster)
    straddle = sum(lo != hi for lo, hi in spans)
    form = ("A resident, the inverse through L2" if plan.resident else
            "A and the inverse through L2" + (", spilled" if plan.spill
                                              else ""))
    return (f"C={plan.cluster} ({form}, {plan.smem_bytes} B shared memory "
            f"per CTA, {conic_delta_max_active_clusters(m, n, nb, plan, wb)} "
            f"clusters at once), {straddle} of {nb} cone blocks straddle CTAs")


def decisive_thresholds(torch, crit, nb, dev, T=64, min_drop=1.02):
    """Per lane, a threshold that a plain version's criterion crosses
    decisively within T iterations; `crit(t_max)` is that criterion of
    each lane after t_max iterations at threshold 0.  The criterion is
    not monotone, so a threshold just above its value at T may be grazed
    at an earlier probe by one f32 version and not by another.  Instead
    take the last probe k where the criterion drops at least 1.1x below
    its running minimum over the earlier probes (else the largest such
    drop, at least `min_drop`), and the geometric mean of the two as the
    threshold.  Returns (thresholds `(B,)`, the plain version's t_done
    with them, the drops)."""
    errs = torch.stack([
        crit(torch.full((nb,), t, dtype=torch.int32, device=dev)).double()
        for t in range(PROBE, T + 1, PROBE)], dim=1)
    prev_min = torch.cummin(errs, dim=1).values[:, :-1]
    drop = prev_min / errs[:, 1:]
    steps = torch.arange(drop.shape[1], device=drop.device)
    last = torch.where(drop >= 1.1, steps, -1).amax(dim=1)
    k = torch.where(last >= 0, last, drop.argmax(dim=1))
    best = drop.gather(1, k[:, None])[:, 0]
    if (best < min_drop).any():
        raise AssertionError(f"no decisive drop of the plain criterion within "
                             f"T={T}: {best.tolist()}")
    lanes = torch.arange(nb, device=errs.device)
    thresh = torch.sqrt(prev_min[lanes, k] * errs[lanes, k + 1])
    return thresh, ((k + 2) * PROBE).tolist(), best.tolist()


def solve_conic(torch, cones, stacks, dev):
    from abip_tpu_torch.parallel.batched_qcp import solve_qcp_batch

    return solve_qcp_batch(*stacks, cones=cones, device=dev, **CONIC_KW)


def phase_conic_main(torch, dev):
    """The conic main path on a fresh dim-1020 batch, K2 and K3 counted."""
    from abip_tpu_torch.ops.conic_delta import conic_delta_cuda
    from abip_tpu_torch.ops.conic_dr import ladder_cuda
    from abip_tpu_torch.utils.timing import wall_s

    cones, stacks, stars = conic_batch(8000)
    ladder_cuda.launches = 0
    conic_delta_cuda.launches = 0
    sec, res = wall_s(lambda: solve_conic(torch, cones, stacks, dev))
    l2, l3 = ladder_cuda.launches, conic_delta_cuda.launches
    status = res.status.cpu().numpy()
    admm = res.admm_iters.cpu().numpy()
    ipm = res.ipm_iters.cpu().numpy()
    solved = int((status == 1).sum())
    print(f"conic main path B=16 dim-1020 (m={CONIC_M}, n=1020) eps=1e-6 "
          f"sprint2: solved {solved}/{B}, ADMM iterations total "
          f"{int(admm.sum())} (max lane {int(admm.max())}), wall {sec:.3f} s "
          f"(first solve, includes warm-up), K2 launches {l2}, K3 launches "
          f"{l3}")
    print(f"conic per-lane ADMM, port on the card: {admm.tolist()}")
    print(f"conic per-lane ADMM, JAX package on a CPU: {list(JAX_CPU_ADMM)}")
    print(f"conic per-lane IPM, port on the card: {ipm.tolist()} (JAX on a "
          f"CPU: 10-12)")
    conic_vs_optima(res, stars, "conic main path")
    if l2 <= 0 or l3 <= 0:
        raise AssertionError(f"conic main path launched K2 {l2}x, K3 {l3}x")
    return l2, l3


def conic_vs_optima(res, stars, label):
    """Raise unless every lane is Solved, finite and within 1e-5 of its
    known optimum (relative to max(1, |optimum|))."""
    status = res.status.cpu().numpy()
    pobj = res.pobj.cpu().numpy()
    if (status != 1).any():
        raise AssertionError(f"{label}: statuses {status.tolist()}")
    if not (np.isfinite(res.x.cpu().numpy()).all()
            and np.isfinite(pobj).all()):
        raise AssertionError(f"{label}: non-finite solution")
    rel = np.abs(pobj - stars) / np.maximum(1.0, np.abs(stars))
    print(f"{label} vs known optima: {len(stars)}/{len(stars)} solved, max "
          f"relative objective gap {rel.max():.3e} (limit 1e-5)")
    if rel.max() > 1e-5:
        raise AssertionError(f"{label}: objectives off: {rel.tolist()}")


# the cluster sizes K3 is timed at, each in every residency that fits
K3_CLUSTERS = (4, 5, 6, 7, 8, 16)


def phase_conic_timing(torch, dev, card):
    from abip_tpu_torch import conic_ops
    from abip_tpu_torch.ops.admm_delta import DeltaPlan
    from abip_tpu_torch.ops.conic_delta import (_conic_delta_compute,
                                                conic_delta_cuda,
                                                conic_delta_launch_plan,
                                                conic_delta_smem_bytes)
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_dr import _dr_ladder_compute, ladder_cuda
    from abip_tpu_torch.utils.timing import cuda_ms, wall_s

    walls = []
    for seed0 in (8100, 8200, 8300):
        cones, stacks, _ = conic_batch(seed0)
        sec, res = wall_s(lambda: solve_conic(torch, cones, stacks, dev))
        its = int(res.admm_iters.sum())
        ok = int((res.status == 1).sum())
        walls.append((sec, its, ok))
        print(f"timing conic solve seeds {seed0}+: {sec:.4f} s, {its} ADMM "
              f"it (max lane {int(res.admm_iters.max())}), {B / sec:.3f} "
              f"inst/s, solved {ok}/{B}")
    sec, its, ok = sorted(walls)[1]
    print(f"timing conic solve median of 3 [{card}]: {sec:.4f} s, "
          f"{its / sec:.1f} ADMM it/s aggregate, {B / sec:.3f} instances/s")
    cones, stacks, _ = conic_batch(8600)
    P = conic_prepared(torch, cones, stacks, dev)
    co = cone_operands(cones, dev)
    op = cold_ladder_operands(torch, P, cones)
    t_max = torch.full((B,), 2048, dtype=torch.int32, device=dev)
    run = dict(probe=PROBE, psi=1.0, woodbury=True)
    dr_form_sweep(torch, dev, card, "ladder",
                  lambda p: ladder_cuda(op, co, t_max, plan=p, **run), P, co,
                  "K2 one phase-1 launch B=16 dim-1020", 5)
    k2_ms = cuda_ms(lambda: ladder_cuda(op, co, t_max, **run), iters=5)
    k2_plain = cuda_ms(lambda: _dr_ladder_compute(op, co, t_max, **run),
                       iters=3)
    # Woodbury form, per iteration: four A passes and one G^-1 pass; per
    # trip of PROBE iterations four more A passes (criterion, error ratio)
    m, n = op.A.shape[1:]
    outs = ladder_cuda(op, co, t_max, **run)
    k2_bound = kernel_bound(list(op) + list(co) + [t_max], outs,
                            outs[4][:, 3],
                            8 * m * n + 2 * m * m + 8 * m * n / PROBE)
    print(f"timing K2 one phase-1 launch B=16 dim-1020 (32 iterations, 4 "
          f"stages) [{card}]: kernel {k2_ms:.3f} ms (the plan's "
          f"{dr_plan_line(torch, P, co, 'ladder')}), plain version "
          f"{k2_plain:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    st = conic_phase1_state(torch, P, cones)
    anc = conic_anchor(torch, P, cones, st, 0.0)
    t_max = torch.full((B,), 512, dtype=torch.int32, device=dev)
    run = dict(probe=PROBE, woodbury=True)
    # every cluster size and residency whose CTA fits the card
    nb = co.start.shape[0]
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for size in K3_CLUSTERS:
        for resident in (False, True):
            nbytes = conic_delta_smem_bytes(m, n, nb, size, resident)
            if nbytes > limit:
                continue
            p = DeltaPlan(size, resident, nbytes)
            t = cuda_ms(lambda: conic_delta_cuda(anc, co, t_max, plan=p,
                                                 **run), iters=3)
            print(f"timing K3 chunk T=512 B=16 dim-1020 [{card}]: {t:.3f} ms "
                  f"({t * 1e3 / 512:.2f} us/iteration) at "
                  f"{k3_plan_line(torch, P, co, p)}")
    p = conic_delta_launch_plan(m, n, nb, 0)
    t = cuda_ms(lambda: conic_delta_cuda(anc, co, t_max, plan=p, **run),
                iters=3)
    print(f"timing K3 chunk T=512 B=16 dim-1020 [{card}]: {t:.3f} ms "
          f"({t * 1e3 / 512:.2f} us/iteration) at "
          f"{k3_plan_line(torch, P, co, p)}")
    k3_ms = cuda_ms(lambda: conic_delta_cuda(anc, co, t_max, **run), iters=5)
    k3_plain = cuda_ms(lambda: _conic_delta_compute(anc, co, t_max, **run),
                       iters=1)
    # the linear pipeline of K2 on deltas; per probe two more A passes
    outs = conic_delta_cuda(anc, co, t_max, **run)
    k3_bound = kernel_bound(list(anc) + list(co) + [t_max], outs,
                            outs[4][:, 3],
                            8 * m * n + 2 * m * m + 4 * m * n / PROBE)
    print(f"timing K3 chunk T=512 B=16 dim-1020 [{card}]: kernel "
          f"{k3_ms:.3f} ms ({k3_ms * 1e3 / 512:.2f} us/iteration; the plan's "
          f"{k3_plan_line(torch, P, co)}), plain version {k3_plain:.3f} ms "
          f"(one chunk), bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")
    As, bs, cs, _ = (None if x is None else torch.as_tensor(x, device=dev)
                     for x in stacks)
    m, n = CONIC_M, P.A.shape[2]
    prep_ms = cuda_ms(lambda: conic_prepared(torch, cones, stacks, dev),
                      iters=3)
    anchor_ms = cuda_ms(lambda: conic_anchor(torch, P, cones, st, 0.0))
    rho = torch.cat([torch.full((m,), CONIC_KW["rho_y"], dtype=torch.float64,
                                device=dev),
                     torch.ones(n + 1, dtype=torch.float64, device=dev)])

    def check():
        mv = lambda x: (P.A @ x[..., None])[..., 0]  # noqa: E731
        rmv = lambda y: (y[:, None, :] @ P.A)[:, 0]  # noqa: E731
        qt = torch.zeros_like  # no Q on this path
        vo = rho * st.v_raw
        r = conic_ops.conic_residuals(
            st.u_raw, vo, conic_ops.ConicResiduals.init(B, device=dev), mv,
            rmv, qt, P.b, P.c, P.D, P.E, P.sc_b, P.sc_c, 1.0, P.nm_inf_b0,
            P.nm_inf_c0, 1e-6, 1e-6, 1e-6, m, n)
        return r, conic_ops.inner_conv_check(st.u_raw, vo, mv, rmv, qt, P.b,
                                             P.c, m, n)

    check_ms = cuda_ms(check)
    print(f"timing conic f64 pieces B=16 dim-1020 [{card}]: prepare "
          f"{prep_ms:.3f} ms per batch, anchor {anchor_ms:.3f} ms and "
          f"residual check + f64 criterion {check_ms:.3f} ms per chunk")
    return (k2_ms, k2_plain) + k2_bound, (k3_ms, k3_plain) + k3_bound


# the cluster sizes K2 and K4 are timed at, each in every residency that
# fits, and spilled
DR_CLUSTERS = (4, 6, 8, 16)


def dr_form_sweep(torch, dev, card, kernel, run, P, co, what, iters):
    """Time one launch of K2 (`kernel="ladder"`) or K4 (`"sprint"`),
    `run(plan)`, at each of DR_CLUSTERS streaming, with A resident where
    its CTA fits the card, and spilled, with the clusters the card holds
    at once.  Returns {(cluster, form): ms}."""
    from abip_tpu_torch.utils.timing import cuda_ms

    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    out = {}
    for size in DR_CLUSTERS:
        for form in ((size, False), (size, True), (size, "spill")):
            p = dr_form_plan(torch, P, co, form)
            if p.smem_bytes > limit:
                continue
            t = cuda_ms(lambda: run(p), iters=iters)
            out[form] = t
            print(f"timing {what} [{card}]: {t:.3f} ms at "
                  f"{dr_plan_line(torch, P, co, kernel, p)}")
    return out


def phase_conic_profile(torch, dev):
    cones, stacks, _ = conic_batch(8700)
    profile_solve(torch, lambda: solve_conic(torch, cones, stacks, dev),
                  {"K2": "conic_ladder_cluster_kernel",
                   "K3": "conic_delta_cluster_kernel"}, "one conic solve")


def phase_conic_sprint_profile(torch, dev):
    cones, stacks, _ = conic_batch(8750)
    profile_solve(torch, lambda: solve_conic_sprint(torch, cones, stacks,
                                                    dev),
                  {"K4": "conic_sprint_cluster_kernel",
                   "K3": "conic_delta_cluster_kernel"},
                  "one conic phase1=sprint solve")


# ---------------------------------------------------------------------------
# the sprint engines: K6, K7 (LP), K4 (conic), K8 (barrier step)
# ---------------------------------------------------------------------------

def lp_sprint_operands(torch, S, u, v, thresh, lam=SPRINT_LAM):
    """The operands of one LP sprint launch from the sprint engine's setup
    `S` and an f64 state, as the solver packs them."""
    from abip_tpu_torch.ops.admm_sprint import sprint_operands

    return sprint_operands(S.A32, S.Ninv32, S.h, S.g, 1e-3,
                           1.0 / (S.g_th + 1.0), lam, 1.8, thresh, u, v)


LP_CASES = (("smoke B=16 m=50 n=2000", SMOKE, B),
            ("ragged B=5 m=37 n=411", dict(m=37, n_rand=374), 5))
# The LP sprints iterate the absolute iterate in f32 (no f64 anchor):
# two f32 versions of 64 iterations sit up to ~1e-4 of the iterate's
# largest magnitude apart, each as far from an f64 run
# (`tests/test_torch_admm_sprint.py`), so their values are held to rtol
# 2e-5 plus 1e-4 of the scale.  Their criterion qres is a residual of
# such iterates: at the cold start it is large and two f32 versions
# agree to ~2%; at a mid-solve state it is near its noise floor (up to 2x
# apart on the CPU), so it is held to ERR_RTOL at the cold start only.
LP_SPRINT_REL_SCALE = 1e-4
LP_COLD_LAM = 0.1


def lp_cold_state(torch, S):
    """The cold-start iterate u = v = (0, 1, 1) of the sprint setup `S`."""
    nb, m, n = S.A_s.shape
    u = torch.cat([torch.zeros((nb, m), dtype=torch.float64,
                               device=S.A_s.device),
                   torch.ones((nb, n + 1), dtype=torch.float64,
                              device=S.A_s.device)], dim=1)
    return u, u.clone()


def phase_lp_sprint_parity(torch, dev):
    """K6 and K7 against their plain version at the smoke shape and a
    ragged one: at a mid-solve state of the sprint engine's setup (lam =
    SPRINT_LAM) and at the cold start (lam = LP_COLD_LAM), K6 at T=64 with
    thresh=0 (equal t_done; the stated tolerance; at most ACC_RATIO
    times the plain version's distance from an f64 run) and K7 at
    T=sprint_T=32; then, from the smoke cold start, thresholds that stop
    lanes mid-chunk.  Returns the largest |kernel - plain| of K6 and of
    K7."""
    from abip_tpu_torch.ops.admm_sprint import (SprintOperands,
                                                _sprint_compute, sprint_cuda,
                                                sprint_stop_cuda)

    worst6 = worst7 = 0.0
    tol = dict(amplified=(), rel_scale=LP_SPRINT_REL_SCALE)
    for label, shape, nb in LP_CASES:
        _, stacks = smoke_batch(500, nb, **shape)
        S, u, v = mid_solve_state(torch, stacks, dev, sprint=True)
        for where, (su, sv), lam in (("mid-solve", (u, v), SPRINT_LAM),
                                     ("cold", lp_cold_state(torch, S),
                                      LP_COLD_LAM)):
            op = lp_sprint_operands(torch, S, su, sv, 0.0, lam=lam)
            op64 = SprintOperands(*[x.double() for x in op])
            tag = f"{label} {where} lam={lam}"
            tm = torch.full((nb,), 64, dtype=torch.int32, device=dev)
            ker = sprint_stop_cuda(op, tm, PROBE)
            plain = _sprint_compute(op, tm, PROBE)
            exact = _sprint_compute(op64, tm, PROBE)
            torch.cuda.synchronize()
            if not torch.equal(ker[3][:, 3], plain[3][:, 3]):
                raise AssertionError(f"K6 {tag}: t_done differs")
            q_rel = float(((ker[3][:, 2] - plain[3][:, 2]).abs()
                           / plain[3][:, 2].abs()).max())
            if where == "mid-solve":   # qres at its noise floor: reported
                ker, plain, exact = ([*o[:3], o[3][:, :2]]
                                     for o in (ker, plain, exact))
            names = ("y", "x", "vx", "row" if where == "cold" else "tau_kappa")
            err = compare_conic(ker, plain, names, f"K6 {tag}", **tol)
            kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K6 {tag}")
            worst6 = max(worst6, err)
            print(f"parity K6 {tag} T=64: t_done equal; max|kernel-plain| "
                  f"{err:.3e} (stated tolerance: ok); qres relative "
                  f"difference {q_rel:.2e}; vs f64 run: kernel {kerr:.3e}, "
                  f"plain {perr:.3e} (kernel at most {ACC_RATIO}x: ok)")
            tm = torch.full((nb,), 32, dtype=torch.int32, device=dev)
            # the plain sprint has no criterion: (y, x, vx, tau, kappa)
            ker, plain, exact = ([*o[:3], o[3][:, :2]] for o in (
                sprint_cuda(op, tm), _sprint_compute(op, tm, 0),
                _sprint_compute(op64, tm, 0)))
            torch.cuda.synchronize()
            err = compare_conic(ker, plain, ("y", "x", "vx", "tau_kappa"),
                                f"K7 {tag}", **tol)
            kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K7 {tag}")
            worst7 = max(worst7, err)
            print(f"parity K7 {tag} T=32: max|kernel-plain| {err:.3e} "
                  f"(stated tolerance: ok); vs f64 run: kernel {kerr:.3e}, "
                  f"plain {perr:.3e} (kernel at most {ACC_RATIO}x: ok)")
        if nb == B:
            smoke = S
    S = smoke
    u, v = lp_cold_state(torch, S)
    op = lp_sprint_operands(torch, S, u, v, 0.0, lam=LP_COLD_LAM)
    thresh, t_stop, drop = decisive_thresholds(
        torch, lambda tm: _sprint_compute(op, tm, PROBE)[3][:, 2], B, dev)
    op = lp_sprint_operands(torch, S, u, v, thresh, lam=LP_COLD_LAM)
    tm = torch.full((B,), 256, dtype=torch.int32, device=dev)
    tk = sprint_stop_cuda(op, tm, PROBE)[3][:, 3].int().tolist()
    tp = _sprint_compute(op, tm, PROBE)[3][:, 3].int().tolist()
    if tp != t_stop:
        raise AssertionError(f"K6 stop case: plain t_done {tp}, planned "
                             f"{t_stop}")
    if max(abs(a - b) for a, b in zip(tk, tp)) > PROBE:
        raise AssertionError(f"K6 stop case: t_done {tk} vs plain {tp}")
    print(f"parity K6 stop-mid-chunk B=16 cold start T=256: t_done kernel "
          f"{tk} plain {tp} (within one probe; each threshold splits a drop "
          f"of at least {min(drop):.3f}x in the plain criterion)")
    return worst6, worst7


def conic_cold_state(torch, P, cones):
    """The cold-start iterate (u = v) of a prepared batch, f32."""
    from abip_tpu_torch.cones import ConeLayout

    nb, m, n = P.A.shape
    x0 = ConeLayout(cones).interior_point(torch.float64, P.A.device)
    return torch.cat([torch.zeros((nb, m), dtype=torch.float64,
                                  device=P.A.device), x0.expand(nb, n),
                      torch.ones((nb, 1), dtype=torch.float64,
                                 device=P.A.device)], dim=1).float()


def conic_sprint_operands(torch, P, u, v, lam, thresh, k0):
    """The operands of one conic sprint launch, as the solver packs them."""
    from abip_tpu_torch.ops.conic_dr import dr_sprint_operands

    Qd = P.Q_diag if P.Q_diag is not None else torch.zeros_like(P.c)
    return dr_sprint_operands(
        P.A.float(), P.dss.Minv64.float(), _hinv(torch, P).float(),
        P.r_vec.float(), P.b.float(), P.c.float(), Qd.float(),
        CONIC_KW["rho_y"], 1.0, 1.0, P.a_coef, lam, 1.8, thresh, u, v, k0)


def conic_sprint_parity(torch, dev, label, case, form=None):
    """K4 against its plain version, in the form of its launch plan (or in
    `form`, as `dr_form_plan` takes it): T=64 at thresh=0 from the cold start (k0 = 0: the first
    iteration takes tau_t = 1; mu = 1), then 64 more from the plain
    version's state (k0 = 64, mu = 0.2); equal t_done, the stated
    tolerance, the accuracy ratio; then thresholds that stop lanes
    mid-chunk.  Returns the largest |kernel - plain|."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_dr import (DrSprintOperands,
                                             _dr_sprint_compute,
                                             dr_sprint_cuda)

    cones, stacks, _ = conic_batch(**case)
    P = conic_prepared(torch, cones, stacks, dev)
    co = cone_operands(cones, dev)
    nb = P.A.shape[0]
    plan = dr_form_plan(torch, P, co, form)
    print(f"K4 {label}: {dr_plan_line(torch, P, co, 'sprint', plan)}")
    run = dict(probe=PROBE, woodbury=P.dss.form == "woodbury")
    tm = torch.full((nb,), 64, dtype=torch.int32, device=dev)
    u = conic_cold_state(torch, P, cones)
    worst = 0.0
    for lam, k0, v in ((1.0, 0.0, u), (0.2, 64.0, None)):
        if v is None:   # continue from the plain version's state
            y, x, vy, vx, row = plain
            u = torch.cat([y, x, row[:, :1]], 1)
            v = torch.cat([vy, vx, row[:, 1:2]], 1)
        op = conic_sprint_operands(torch, P, u, v, lam, 0.0, k0)
        ker = dr_sprint_cuda(op, co, tm, plan=plan, **run)
        plain = _dr_sprint_compute(op, co, tm, **run)
        exact = _dr_sprint_compute(DrSprintOperands(*[x.double() for x in op]),
                                   co, tm, **run)
        torch.cuda.synchronize()
        if not torch.equal(ker[4][:, 3], plain[4][:, 3]):
            raise AssertionError(f"K4 {label}: t_done differs")
        err = compare_conic(ker, plain, ("y", "x", "vy", "vx", "row"),
                            f"K4 {label}")
        kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K4 {label}")
        worst = max(worst, err)
        print(f"parity K4 {label} {P.dss.form} T=64 k0={k0:.0f} mu={lam}: "
              f"t_done equal; max|kernel-plain| {err:.3e} (stated tolerance: "
              f"ok); vs f64 run: kernel {kerr:.3e}, plain {perr:.3e} (kernel "
              f"at most {ACC_RATIO}x: ok)")
    u = conic_cold_state(torch, P, cones)
    op = conic_sprint_operands(torch, P, u, u, 1.0, 0.0, 0.0)
    thresh, t_stop, drop = decisive_thresholds(
        torch, lambda t: _dr_sprint_compute(op, co, t, **run)[4][:, 2], nb,
        dev)
    op = conic_sprint_operands(torch, P, u, u, 1.0, thresh, 0.0)
    tm = torch.full((nb,), 256, dtype=torch.int32, device=dev)
    tk = dr_sprint_cuda(op, co, tm, plan=plan, **run)[4][:, 3].int().tolist()
    tp = _dr_sprint_compute(op, co, tm, **run)[4][:, 3].int().tolist()
    if tp != t_stop:
        raise AssertionError(f"K4 {label}: plain t_done {tp}, planned {t_stop}")
    if max(abs(a - b) for a, b in zip(tk, tp)) > PROBE:
        raise AssertionError(f"K4 {label}: t_done {tk} vs plain {tp}")
    print(f"parity K4 {label} stop-mid-chunk T=256: t_done kernel {tk} plain "
          f"{tp} (within one probe; each threshold splits a drop of at least "
          f"{min(drop):.3f}x in the plain criterion)")
    return worst


# K8 against its plain version: f64 within 1e-12 relative, f32 within
# 1e-6, plus that much of the inputs' largest magnitude absolute (v_new =
# v + u_new - rel cancels); the prox at the reference guard's fault
# points within 1e-6 relative of the f64 prox.
STEP_TOL = {"f32": 1e-6, "f64": 1e-12}
STEP_FAULT_T = (-1e-20, -1e-15)


def phase_barrier_step(torch, dev):
    """K8 on a 32,000-vector and a ragged 1,237-vector, f32 and f64, with
    the arguments t = -1e-20 and -1e-15 where the reference's guarded
    prox fails.  Returns (largest |kernel - plain| in f32, launches)."""
    from abip_tpu_torch import hsd
    from abip_tpu_torch.ops.prox import _ref_impl, barrier_step_cuda

    lam, alpha = 1e-4, 1.8
    barrier_step_cuda.launches = 0
    worst = 0.0
    for n in (32_000, 1_237):
        rng = np.random.default_rng(n)
        x = [rng.standard_normal(n) for _ in range(3)]
        x[0][:2] = np.asarray(STEP_FAULT_T) / alpha
        x[1][:2] = 0.0
        x[2][:2] = 0.0
        for kind, dt in (("f32", torch.float32), ("f64", torch.float64)):
            t = [torch.tensor(a, dtype=dt, device=dev) for a in x]
            ker = barrier_step_cuda(*t, lam, alpha)
            plain = _ref_impl(*t, lam, alpha)
            torch.cuda.synchronize()
            atol = STEP_TOL[kind] * max(np.abs(a).max() for a in x)
            diff = 0.0
            for k, p in zip(ker, plain):
                k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
                d = np.abs(k - p)
                if not np.isfinite(k).all() or (
                        d > STEP_TOL[kind] * np.abs(p) + atol).any():
                    raise AssertionError(f"K8 n={n} {kind}: |kernel-plain| "
                                         f"{d.max():.3e}")
                diff = max(diff, float(d.max()))
            # the prox argument as the kernel forms it, then the f64 prox
            t64 = (alpha * t[0][:2].double() + (1.0 - alpha) * t[1][:2].double()
                   - t[2][:2].double())
            want = hsd.barrier_prox(t64, lam).cpu().numpy()
            got = ker[0][:2].double().cpu().numpy()
            rel = np.abs(got - want) / want
            if (rel > 1e-6).any():
                raise AssertionError(f"K8 n={n} {kind}: prox at {STEP_FAULT_T}"
                                     f" {got.tolist()} vs f64 {want.tolist()}")
            if kind == "f32":
                worst = max(worst, diff)
            print(f"parity K8 n={n} {kind}: max|kernel-plain| {diff:.3e} "
                  f"(rtol {STEP_TOL[kind]} + that of the inputs' scale: ok); "
                  f"prox at t={list(STEP_FAULT_T)}: {got.tolist()} vs f64 "
                  f"{want.tolist()} (rel {rel.max():.1e}, limit 1e-6)")
    return worst, barrier_step_cuda.launches


def solve_sprint(torch, stacks, dev, **kw):
    from abip_tpu_torch.parallel.batched import solve_lp_batch

    return solve_lp_batch(*stacks, device=dev, **dict(SPRINT_KW, **kw))


def counted_solve(torch, fn, kernels):
    """(seconds, result, launches) of `fn()` with each kernel wrapper's
    count set to 0 just before and read just after."""
    from abip_tpu_torch.utils.timing import wall_s

    for k in kernels:
        k.launches = 0
    sec, res = wall_s(fn)
    return sec, res, [k.launches for k in kernels]


def phase_lp_sprint_main(torch, dev):
    """The LP sprint engines on fresh B=16 smoke batches against HiGHS:
    sprint2 with the delta endgame (K6 + K1; the main path of this
    slice), sprint2 with the default steps endgame (K6), and the sprint
    engine under cadence "cond" (K7).  Returns the launches of K6 and K1
    in the first, and of K7 in the last."""
    from abip_tpu_torch.ops.admm_delta import delta_chunk_cuda
    from abip_tpu_torch.ops.admm_sprint import sprint_cuda, sprint_stop_cuda

    runs = (("sprint2+delta", 1100, dict(endgame="delta")),
            ("sprint2+steps", 1200, dict()),
            ("sprint cond", 1300, dict(engine="sprint", cadence="cond")))
    out = {}
    for label, seed0, kw in runs:
        data, stacks = smoke_batch(seed0)
        sec, res, counts = counted_solve(
            torch, lambda: solve_sprint(torch, stacks, dev, **kw),
            (sprint_stop_cuda, sprint_cuda, delta_chunk_cuda))
        iters = res.admm_iters.cpu().numpy()
        print(f"LP {label} B=16 smoke eps=1e-6: ADMM total {int(iters.sum())} "
              f"(max lane {int(iters.max())}), IPM mean "
              f"{res.ipm_iters.double().mean().item():.1f}, wall {sec:.3f} s "
              f"(first solve), launches K6 {counts[0]}, K7 {counts[1]}, K1 "
              f"{counts[2]}")
        lp_vs_highs(data, res, f"LP {label}")
        out[label] = counts
    k6, k1 = out["sprint2+delta"][0], out["sprint2+delta"][2]
    k7 = out["sprint cond"][1]
    if min(k6, k1, out["sprint2+steps"][0], k7) <= 0:
        raise AssertionError(f"LP sprint paths missed a kernel: {out}")
    return k6, k1, k7


def phase_lp_sprint_timing(torch, dev, card):
    """sprint2 + delta: median of 3 fresh batches; K6 (one T=1536 chunk)
    and K7 (one T=32 sprint) against their plain version, with bounds."""
    from abip_tpu_torch.ops.admm_sprint import (
        DeltaPlan, _sprint_compute, sprint_cuda, sprint_launch_plan,
        sprint_max_active_clusters, sprint_smem_bytes, sprint_stop_cuda)
    from abip_tpu_torch.utils.timing import cuda_ms, wall_s

    walls = []
    for seed0 in (2100, 3100, 4100):
        _, stacks = smoke_batch(seed0)
        sec, res = wall_s(lambda: solve_sprint(torch, stacks, dev,
                                               endgame="delta"))
        its = int(res.admm_iters.sum())
        walls.append((sec, its))
        print(f"timing LP sprint2+delta seeds {seed0}+: {sec:.4f} s, {its} "
              f"ADMM it, solved {int((res.status == 1).sum())}/{B}")
    sec, its = sorted(walls)[1]
    print(f"timing LP sprint2+delta median of 3 [{card}]: {sec:.4f} s, "
          f"{its / sec:.1f} ADMM it/s aggregate, {B / sec:.3f} instances/s")
    _, stacks = smoke_batch(5000)
    S, u, v = mid_solve_state(torch, stacks, dev, sprint=True)
    op = lp_sprint_operands(torch, S, u, v, 0.0)
    _, m, n = op.A.shape
    # each cluster size, resident, on the same operands
    for size in K1_CLUSTERS:
        p = DeltaPlan(size, True, sprint_smem_bytes(m, n, size, True))
        t6 = cuda_ms(lambda: sprint_stop_cuda(
            op, torch.full((B,), 1536, dtype=torch.int32, device=dev), PROBE,
            plan=p), iters=3)
        t7 = cuda_ms(lambda: sprint_cuda(
            op, torch.full((B,), 32, dtype=torch.int32, device=dev), plan=p),
            iters=5)
        print(f"timing K6 T=1536 / K7 T=32 B=16 m=50 n=2000 C={size} "
              f"[{card}]: {t6:.3f} ms ({t6 * 1e3 / 1536:.2f} us/iteration) / "
              f"{t7:.3f} ms, resident, {p.smem_bytes} B shared memory, "
              f"{sprint_max_active_clusters(m, n, p)} clusters at once")
    p = sprint_launch_plan(m, n, 0)
    t6 = cuda_ms(lambda: sprint_stop_cuda(
        op, torch.full((B,), 1536, dtype=torch.int32, device=dev), PROBE,
        plan=p), iters=3)
    t7 = cuda_ms(lambda: sprint_cuda(
        op, torch.full((B,), 32, dtype=torch.int32, device=dev), plan=p),
        iters=5)
    print(f"timing K6 T=1536 / K7 T=32 B=16 m=50 n=2000 C={p.cluster} "
          f"[{card}]: {t6:.3f} ms ({t6 * 1e3 / 1536:.2f} us/iteration) / "
          f"{t7:.3f} ms, spilled (the layout in global memory)")
    plan = sprint_launch_plan(m, n)
    out = {}
    for name, T, probe, fn, flops in (
            ("K6", 1536, PROBE, lambda tm: sprint_stop_cuda(op, tm, PROBE),
             4 * m * n + 2 * m * m + 4 * m * n / PROBE),
            ("K7", 32, 0, lambda tm: sprint_cuda(op, tm),
             4 * m * n + 2 * m * m)):
        tm = torch.full((B,), T, dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: fn(tm), iters=5)
        plain = cuda_ms(lambda: _sprint_compute(op, tm, probe),
                        iters=1 if T > 100 else 3)
        outs = fn(tm)
        bms, by = kernel_bound(list(op) + [tm], outs, outs[3][:, 3], flops)
        print(f"timing {name} T={T} B=16 m=50 n=2000 [{card}]: kernel "
              f"{ms:.3f} ms ({ms * 1e3 / T:.2f} us/iteration; the plan's "
              f"C={plan.cluster}), plain version {plain:.3f} ms, bound "
              f"{bms:.4f} ms ({by})")
        out[name] = (ms, plain, bms, by)
    return out["K6"], out["K7"]


def phase_lp_sprint_profile(torch, dev):
    _, stacks = smoke_batch(6100)
    profile_solve(torch, lambda: solve_sprint(torch, stacks, dev,
                                              endgame="delta"),
                  {"K6": "sprint_cluster_kernel",
                   "K1": "delta_cluster_kernel"},
                  "one LP sprint2+delta solve")


def solve_conic_sprint(torch, cones, stacks, dev):
    from abip_tpu_torch.parallel.batched_qcp import solve_qcp_batch

    return solve_qcp_batch(*stacks, cones=cones, device=dev,
                           **dict(CONIC_KW, phase1="sprint"))


def phase_conic_sprint_main(torch, dev, card):
    """sprint2 with phase1="sprint" (K4 + K3) on a fresh dim-1020 B=16
    batch against the known optima, then the median of 3 fresh batches.
    Returns the launches of K4 and K3 in the first solve."""
    from abip_tpu_torch.ops.conic_delta import conic_delta_cuda
    from abip_tpu_torch.ops.conic_dr import dr_sprint_cuda

    from abip_tpu_torch.utils.timing import wall_s

    cones, stacks, stars = conic_batch(8800)
    sec, res, (l4, l3) = counted_solve(
        torch, lambda: solve_conic_sprint(torch, cones, stacks, dev),
        (dr_sprint_cuda, conic_delta_cuda))
    admm = res.admm_iters.cpu().numpy()
    print(f"conic sprint2 phase1=sprint B=16 dim-1020: ADMM total "
          f"{int(admm.sum())} (max lane {int(admm.max())}), IPM "
          f"{res.ipm_iters.cpu().numpy().tolist()}, wall {sec:.3f} s (first "
          f"solve), K4 launches {l4}, K3 launches {l3}")
    conic_vs_optima(res, stars, "conic phase1=sprint")
    if l4 <= 0 or l3 <= 0:
        raise AssertionError(f"conic phase1=sprint launched K4 {l4}x, K3 "
                             f"{l3}x")
    walls = []
    for seed0 in (8100, 8200, 8300):
        cones, stacks, stars = conic_batch(seed0)
        sec, res = wall_s(lambda: solve_conic_sprint(torch, cones, stacks,
                                                     dev))
        its = int(res.admm_iters.sum())
        walls.append((sec, its))
        print(f"timing conic phase1=sprint seeds {seed0}+: {sec:.4f} s, "
              f"{its} ADMM it (max lane {int(res.admm_iters.max())}), solved "
              f"{int((res.status == 1).sum())}/{B}")
    sec, its = sorted(walls)[1]
    print(f"timing conic phase1=sprint median of 3 [{card}]: {sec:.4f} s, "
          f"{its / sec:.1f} ADMM it/s aggregate, {B / sec:.3f} instances/s")
    return l4, l3


def phase_sprint_kernel_timing(torch, dev, card):
    """K4 (one T=512 chunk at dim-1020 B=16 from the cold start) and K8
    (32,000 elements, f32 and f64) against their plain versions, with
    bounds.  Returns the K4 and the f32 K8 tuples."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_dr import _dr_sprint_compute, dr_sprint_cuda
    from abip_tpu_torch.ops.prox import _ref_impl, barrier_step_cuda
    from abip_tpu_torch.utils.timing import cuda_ms, queued_ms

    cones, stacks, _ = conic_batch(8600)
    P = conic_prepared(torch, cones, stacks, dev)
    co = cone_operands(cones, dev)
    u = conic_cold_state(torch, P, cones)
    op = conic_sprint_operands(torch, P, u, u, 1.0, 0.0, 0.0)
    tm = torch.full((B,), 512, dtype=torch.int32, device=dev)
    run = dict(probe=PROBE, woodbury=P.dss.form == "woodbury")
    dr_form_sweep(torch, dev, card, "sprint",
                  lambda p: dr_sprint_cuda(op, co, tm, plan=p, **run), P, co,
                  "K4 chunk T=512 B=16 dim-1020", 3)
    ms = cuda_ms(lambda: dr_sprint_cuda(op, co, tm, **run), iters=5)
    plain = cuda_ms(lambda: _dr_sprint_compute(op, co, tm, **run), iters=1)
    outs = dr_sprint_cuda(op, co, tm, **run)
    # Woodbury form, per iteration four A passes and one G^-1 pass; per
    # trip of PROBE iterations two more A passes (the criterion)
    m, n = op.A.shape[1:]
    bms, by = kernel_bound(list(op) + list(co) + [tm], outs, outs[4][:, 3],
                           8 * m * n + 2 * m * m + 4 * m * n / PROBE)
    print(f"timing K4 chunk T=512 B=16 dim-1020 [{card}]: kernel {ms:.3f} ms "
          f"({ms * 1e3 / 512:.2f} us/iteration; the plan's "
          f"{dr_plan_line(torch, P, co, 'sprint')}), plain version "
          f"{plain:.3f} ms, bound {bms:.4f} ms ({by})")
    k4 = (ms, plain, bms, by)
    k8 = None
    for kind, dt in (("f32", torch.float32), ("f64", torch.float64)):
        x = [torch.randn(32_000, dtype=dt, device=dev) for _ in range(3)]
        ms = queued_ms(lambda: barrier_step_cuda(*x, 1e-4, 1.8))
        plain = queued_ms(lambda: _ref_impl(*x, 1e-4, 1.8))
        nbytes = 5 * x[0].numel() * x[0].element_size()
        bms, by = bound_ms(nbytes, 12.0 * x[0].numel(), kind)
        print(f"timing K8 n=32000 {kind} [{card}]: kernel {ms * 1e3:.2f} us, "
              f"plain {plain * 1e3:.2f} us, bound {bms * 1e3:.3f} us ({by})")
        if k8 is None:
            k8 = (ms, plain, bms, by)
    return k4, k8


# ---------------------------------------------------------------------------
# the shape repair: every kernel takes every shape, spilled where no shared
# memory holds a CTA
# ---------------------------------------------------------------------------

# n = 14,500 (10 SOC(5), 5 RSOC(4), 14,430 nonneg), m = 50: one block per
# lane of the first K2 held 6 m + 4 n + 3 nb floats in shared memory, more
# than a block's (it spilled); the cluster form streams A at C=6, since no
# CTA holds A's slice; the reference runs such a batch through its XLA
# versions and solves every lane (JAX package on a CPU, seeds 9300-9301:
# Solved, 208 and 184 ADMM iterations, within 4e-6 of the known optima).
REPAIR_SPEC = dict(soc=(5,) * 10, rsoc=(4,) * 5, nonneg=14_430)
REPAIR_M = 50
REPAIR_SEED = 9300


def phase_spilled(torch, dev):
    """With the launch plans held to no shared memory, every kernel
    spills: K1, K2, K3, K4, K6 and K7 against their plain versions (the
    parity checks of phases 3-5, in the spilled form), then fresh LP
    sprint2 + delta (K6 + K1) and conic phase1="sprint" (K4 + K3)
    batches solved that way against HiGHS and the known optima.
    Returns the largest |kernel - plain| of each kernel."""
    from abip_tpu_torch.device import limit_shared_memory
    from abip_tpu_torch.ops.admm_delta import delta_chunk_cuda
    from abip_tpu_torch.ops.admm_sprint import sprint_stop_cuda
    from abip_tpu_torch.ops.conic_delta import conic_delta_cuda
    from abip_tpu_torch.ops.conic_dr import dr_sprint_cuda

    with limit_shared_memory(0):
        errs = {"K1": phase_kernel_parity(torch, dev),
                "K2": max(ladder_parity(torch, dev, *c) for c in CONIC_CASES),
                "K3": max(delta_parity(torch, dev, *c) for c in CONIC_CASES),
                "K4": max(conic_sprint_parity(torch, dev, *c)
                          for c in CONIC_CASES)}
        errs["K6"], errs["K7"] = phase_lp_sprint_parity(torch, dev)
        data, stacks = smoke_batch(1400)
        sec, res, (l6, l1) = counted_solve(
            torch, lambda: solve_sprint(torch, stacks, dev, endgame="delta"),
            (sprint_stop_cuda, delta_chunk_cuda))
        print(f"spilled LP sprint2+delta B=16 smoke: wall {sec:.3f} s, ADMM "
              f"total {int(res.admm_iters.sum())}, launches K6 {l6}, K1 {l1}")
        lp_vs_highs(data, res, "spilled LP sprint2+delta")
        cones, stacks, stars = conic_batch(8900)
        sec, res, (l4, l3) = counted_solve(
            torch, lambda: solve_conic_sprint(torch, cones, stacks, dev),
            (dr_sprint_cuda, conic_delta_cuda))
        print(f"spilled conic phase1=sprint B=16 dim-1020: wall {sec:.3f} s, "
              f"ADMM total {int(res.admm_iters.sum())}, launches K4 {l4}, "
              f"K3 {l3}")
        conic_vs_optima(res, stars, "spilled conic phase1=sprint")
    if min(l6, l1, l4, l3) <= 0:
        raise AssertionError(f"spilled solves missed a kernel: K6 {l6}, K1 "
                             f"{l1}, K4 {l4}, K3 {l3}")
    print(f"spilled forms vs plain, max|kernel-plain|: {errs}")
    return errs


def phase_repair(torch, dev):
    """A B=2 conic batch at REPAIR_SPEC solved on the card through the
    kernels: phase 1 in K2 by its plan (A streamed through L2; one block
    per lane, the first K2's form, exceeded a block's shared memory), the
    endgame in K3 by its plan; every lane Solved within 1e-5 of its known
    optimum."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.device import smem_optin
    from abip_tpu_torch.ops.conic_delta import (conic_delta_cuda,
                                                conic_delta_launch_plan)
    from abip_tpu_torch.ops.conic_dr import ladder_cuda
    from abip_tpu_torch.utils.timing import wall_s

    cones, stacks, stars = conic_batch(REPAIR_SEED, count=2, spec=REPAIR_SPEC,
                                       m=REPAIR_M)
    n, nb = cones.dim, len(cones.soc) + len(cones.rsoc)
    one_block = 4 * (6 * REPAIR_M + 4 * n + 3 * nb)
    if one_block <= smem_optin(dev):
        raise AssertionError("the repair shape fits one block; pick a larger "
                             "one")
    P = conic_prepared(torch, cones, stacks, dev)
    plan = dr_plan_line(torch, P, cone_operands(cones, dev), "ladder")
    ladder_cuda.launches = conic_delta_cuda.launches = 0
    sec, res = wall_s(lambda: solve_conic(torch, cones, stacks, dev))
    print(f"repair B=2 conic m={REPAIR_M} n={n}: wall {sec:.3f} s, ADMM "
          f"{res.admm_iters.cpu().numpy().tolist()}, IPM "
          f"{res.ipm_iters.cpu().numpy().tolist()}, K2 launches "
          f"{ladder_cuda.launches} at {plan} (one block per lane would need "
          f"{one_block} B, a block has {smem_optin(dev)}), K3 launches "
          f"{conic_delta_cuda.launches} "
          f"({conic_delta_launch_plan(REPAIR_M, n, nb)})")
    conic_vs_optima(res, stars, "repair")
    if ladder_cuda.launches <= 0:
        raise AssertionError("repair: phase 1 did not launch K2")


# ---------------------------------------------------------------------------
# the single-instance front door: the host conic driver, io/ and the CLI
# ---------------------------------------------------------------------------

# fresh dim-1020 instances of CONIC_SPEC through `solve_qcp`, conic
# defaults (rho_y=1e-6, linsys "auto": dense "chol", Woodbury form)
FRONT_SEEDS = (8700, 8701, 8702)
FRONT_EPS = 1e-6
# `tools/conic_bench.family(scale=25)`: the smallest of that family where
# linsys="auto" takes the CG Schur solver (n > 4096); dense A is 69 MB
CG_SPEC = dict(soc=(625, 625), rsoc=(100,), nonneg=3750)    # n = 5100
CG_M = 1700
SUITES = os.path.join(ROOT, "benchmarks", "suites")
PROFILE_IPM = 8               # barrier stages of the profiled conic solve


def front_check(label, sol, star, sec=None):
    """Print one solve's line; raise unless it is Solved, finite and
    within 1e-5 of `star` relative to max(1, |star|)."""
    rel = abs(sol.pobj - star) / max(1.0, abs(star))
    wall = "" if sec is None else f"wall {sec:.3f} s, "
    print(f"{label}: {sol.status_name}, IPM {sol.ipm_iters}, ADMM "
          f"{sol.admm_iters}, {wall}setup {sol.setup_time:.3f} s, solve "
          f"{sol.solve_time:.3f} s, "
          f"{sol.admm_iters / max(sol.solve_time, 1e-12):.1f} ADMM it/s, "
          f"pobj {sol.pobj:.10g} vs {star:.10g}, relative gap {rel:.3e} "
          f"(limit 1e-5)")
    if sol.status_name != "Solved" or not (
            np.isfinite(sol.x).all() and np.isfinite(sol.pobj)) or rel > 1e-5:
        raise AssertionError(f"{label}: {sol.status_name}, relative gap "
                             f"{rel:.3e}")
    return rel


def phase_front_conic(torch, dev):
    """`solve_qcp` as a user calls it (default device) on fresh dim-1020
    instances: conic defaults, then dense_mode="inverse_mixed" with
    rho_y=1e-3; a diagonal Q and a full PSD Q (the primal form)."""
    from abip_tpu_torch import ConeSpec, ConicWorkspace, solve_qcp
    from abip_tpu_torch.tools.generate import randcone, randqcp
    from abip_tpu_torch.utils.timing import wall_s

    cones = ConeSpec(**CONIC_SPEC)
    data = [randcone("f", CONIC_M, cones, s) for s in FRONT_SEEDS]
    ws = ConicWorkspace(*data[0][1:4], cones)
    print(f"front door dim-1020 (m={CONIC_M}, n=1020) conic defaults: "
          f"{type(ws.solver).__name__} mode {ws.solver.mode} form "
          f"{ws.solver.form}")
    if (ws.solver.mode, ws.solver.form) != ("chol", "woodbury"):
        raise AssertionError("linsys 'auto' did not pick dense chol in the "
                             "Woodbury form at dim-1020")
    for label, kw in (("conic defaults", {}),
                      ("inverse_mixed rho_y=1e-3",
                       dict(dense_mode="inverse_mixed", rho_y=1e-3))):
        for (_, A, b, c, _, star), seed in zip(data, FRONT_SEEDS):
            sec, sol = wall_s(lambda: solve_qcp(A, b, c, cones,
                                                eps=FRONT_EPS, **kw))
            front_check(f"front door dim-1020 seed {seed} {label}", sol,
                        star, sec)
    _, A, b, c, Qd, _, star = randqcp("qd", CONIC_M, cones, 8710,
                                      q_rank="diag")
    sec, sol = wall_s(lambda: solve_qcp(A, b, c, cones, Q=Qd, eps=FRONT_EPS))
    front_check("front door dim-1020 diagonal Q", sol, star, sec)
    _, A, b, c, Q, _, star = randqcp("qf", CONIC_M, cones, 8711)
    ws = ConicWorkspace(A, b, c, cones, Q=Q)
    if ws.solver.form != "primal":
        raise AssertionError("a full Q did not take the primal form")
    sec, sol = wall_s(lambda: solve_qcp(A, b, c, cones, Q=Q, eps=FRONT_EPS))
    front_check("front door dim-1020 full PSD Q (primal form)", sol, star,
                sec)


def phase_front_cg(torch, dev):
    """One n=5100 instance, where linsys "auto" takes CGSchurSolver."""
    from abip_tpu_torch import ConeSpec, ConicWorkspace, conic_defaults
    from abip_tpu_torch.linsys.schur import CGSchurSolver
    from abip_tpu_torch.tools.generate import randcone
    from abip_tpu_torch.utils.timing import wall_s

    cones = ConeSpec(**CG_SPEC)
    _, A, b, c, _, star = randcone("cg", CG_M, cones, 8720)

    def run():
        ws = ConicWorkspace(A, b, c, cones,
                            settings=conic_defaults(eps=FRONT_EPS))
        return ws, ws.solve()

    sec, (ws, sol) = wall_s(run)
    if not isinstance(ws.solver, CGSchurSolver):
        raise AssertionError(f"n=5100 took {type(ws.solver).__name__}")
    front_check(f"front door CG n=5100 m={CG_M} ({type(ws.solver).__name__}, "
                f"avg CG iterations {sol.avg_cg_iters:.1f})", sol, star, sec)
    return sec


def phase_front_workspace(torch, dev):
    """Warm start, a checkpointed and resumed solve, and `update_problem`
    on one dim-1020 workspace: each Solved at its known optimum."""
    import tempfile

    from abip_tpu_torch import ConeSpec, ConicWorkspace, conic_defaults
    from abip_tpu_torch.tools.generate import _complementary_pair, randcone
    from abip_tpu_torch.utils.checkpoint import ConicCheckpoint
    from abip_tpu_torch.utils.timing import wall_s

    cones = ConeSpec(**CONIC_SPEC)
    _, A, b, c, _, star = randcone("w", CONIC_M, cones, 8730)
    ws = ConicWorkspace(A, b, c, cones, settings=conic_defaults(eps=FRONT_EPS))
    sec, cold = wall_s(ws.solve)
    front_check("front door workspace cold", cold, star, sec)
    sec, hot = wall_s(lambda: ws.solve(warm=(cold.x, cold.y, cold.s)))
    front_check("front door workspace warm-started from the cold solution",
                hot, star, sec)
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "conic")
        ConicWorkspace(A, b, c, cones, settings=conic_defaults(
            eps=FRONT_EPS, max_ipm_iters=4)).solve(checkpoint_path=ck,
                                                   checkpoint_every=1)
        state = ConicCheckpoint.load(ck)
        sec, res = wall_s(lambda: ws.solve(resume=state))
    front_check(f"front door workspace resumed after {state.ipm_iters} IPM / "
                f"{state.admm_iters} ADMM iterations", res, star, sec)
    # a second known optimum on the same A: a fresh complementary pair
    rng = np.random.default_rng(8731)
    xs, ss = _complementary_pair(cones, rng)
    b2, c2 = A @ xs, A.T @ rng.standard_normal(CONIC_M) + ss
    sec, upd = wall_s(lambda: ws.update_problem(b2, c2).solve())
    front_check("front door workspace update_problem (new b, c)", upd,
                float(c2 @ xs), sec)


def sedumi_certificate(path, sol, label):
    """Hold a solve of a SeDuMi file with no recorded optimum to a check
    of its own, in numpy on the file's own A, b, c and K (order [free,
    nonneg, soc...]): primal and dual residuals and the duality gap of the
    returned (x, y, s) within 1e-5, and x in K, s in K* (free's dual is
    0) within 1e-9 of max(1, |block|)."""
    from scipy.io import loadmat

    d = loadmat(path, simplify_cells=True)
    A = d["A"] if "A" in d else d["At"].T
    b, c = (np.ravel(d[k]).astype(float) for k in ("b", "c"))
    K = d["K"]
    if np.size(K.get("r", [])):
        raise AssertionError(f"{label}: the check does not cover K.r")
    x, y, s = sol.x, sol.y, sol.s
    pri, dual, gap = lp_certificate(A, b, c, sol)
    f, nl = int(np.sum(K.get("f", 0))), int(np.sum(K.get("l", 0)))
    viol = [np.abs(s[:f]).max(initial=0.0) / max(1.0, np.linalg.norm(s))]
    for v in (x, s):
        viol.append(-v[f:f + nl].min(initial=0.0))
    pos = f + nl
    for k in (int(q) for q in np.atleast_1d(K.get("q", [])) if q > 0):
        for v in (x, s):
            blk = v[pos:pos + k]
            viol.append((np.linalg.norm(blk[1:]) - blk[0])
                        / max(1.0, np.linalg.norm(blk)))
        pos += k
    worst = max(viol)
    print(f"{label}: {sol.status_name}, IPM {sol.ipm_iters}, ADMM "
          f"{sol.admm_iters}, pobj {sol.pobj:.10g} (no recorded optimum: "
          f"checked on the file's data) res_pri {pri:.3e}, res_dual "
          f"{dual:.3e}, gap {gap:.3e} (limit 1e-5), cone violation "
          f"{worst:.3e} (limit 1e-9)")
    if (sol.status_name != "Solved" or max(pri, dual, gap) > 1e-5
            or worst > 1e-9):
        raise AssertionError(f"{label}: {sol.status_name}, certificate off")


_MPS_HIGHS = {}     # .mps path -> HiGHS's objective in the user's sense


def mps_files_vs_highs(torch, dev, paths, label, dense=False,
                       mps_solves=None):
    """Each .mps file through `solve_mps(dense=dense)` on the card,
    against scipy's HiGHS on the presolved standard form within 1e-5
    relative; with dense=False, K5 held to its plain version on the
    file's A and A' first where the driver packs them BCSR, then counted.
    Records each file's standard form and standard-form solution in
    `mps_solves`.  Returns K5's launches."""
    from scipy.optimize import linprog

    from abip_tpu_torch.io.mps import read_mps
    from abip_tpu_torch.io.presolve import presolve_to_standard, solve_mps
    from abip_tpu_torch.ops.spmv import bcsr_matvec_cuda
    from abip_tpu_torch.problem import bcsr_fill_estimate

    k5 = 0
    for p in paths:
        name = os.path.basename(p).split(".", 1)[0]
        # the pattern of the equilibrated A is std.A's
        A = presolve_to_standard(read_mps(p)).A.tocsr()
        packed = not dense and bcsr_fill_estimate(A) > 0.05
        if packed:
            for what, M in (("A", A), ("A'", A.T.tocsr())):
                spmv_parity(torch, dev, f"{name}.mps {what} {M.shape[0]}x"
                            f"{M.shape[1]}", M, "f64")
        bcsr_matvec_cuda.launches = 0
        sol, std = solve_mps(p, dense=dense, eps=FRONT_EPS)
        launches = bcsr_matvec_cuda.launches
        if mps_solves is not None:
            mps_solves[name] = (std, sol.x_std)
        if (launches > 0) != packed:
            raise AssertionError(f"{name}.mps: K5 launches {launches}, "
                                 f"packed {packed}")
        k5 += launches
        if p not in _MPS_HIGHS:     # the dense and sparse routes share it
            ref = linprog(std.c, A_eq=std.A, b_eq=std.b, bounds=(0, None),
                          method="highs")
            if ref.status != 0:
                raise AssertionError(f"HiGHS failed on {name}: "
                                     f"{ref.message}")
            _MPS_HIGHS[p] = std.user_objective(ref.fun)
        star = _MPS_HIGHS[p]
        rel = abs(sol.pobj - star) / max(1.0, abs(star))
        print(f"{label} {name}.mps {std.A.shape[0]}x{std.A.shape[1]} "
              f"{'dense' if dense else 'sparse'}: {sol.status_name}, IPM "
              f"{sol.ipm_iters}, ADMM {sol.admm_iters}, solve "
              f"{sol.solve_time:.3f} s, K5 launches {launches}, pobj "
              f"{sol.pobj:.10g} vs HiGHS {star:.10g}, relative gap "
              f"{rel:.3e} (limit 1e-5)")
        if sol.status_name != "Solved" or rel > 1e-5:
            raise AssertionError(f"{name}.mps: {sol.status_name}, {rel:.3e}")
    return k5


def phase_front_files(torch, dev, mps_solves=None):
    """The committed suites through the CLI's own functions, on the card:
    every conic_mini .mat against its stored pobj_star (a file without
    one held to `sedumi_certificate`), every cblib_mini .cbf against
    optima.json in the instance's own sense (an instance without a
    recorded optimum against its certified SeDuMi twin), every
    netlib_mini .mps with dense=False against scipy's HiGHS on the
    presolved standard form, K5 held to its plain version on each packed
    A and A' and counted; then one `python -m abip_tpu_torch FILE.cbf
    --json` subprocess.  Records each .mps file's standard form and
    standard-form solution in `mps_solves` (phase 9's crossover starts
    from them).  Returns K5's launches on the MPS route."""
    import glob
    import time

    from abip_tpu_torch.io.cbf import solve_cbf
    from abip_tpu_torch.io.sedumi import solve_sedumi

    def base(p):
        return os.path.basename(p).rsplit(".", 1)[0]

    mats = {}
    t0 = time.perf_counter()
    for p in sorted(glob.glob(os.path.join(SUITES, "conic_mini", "*.mat"))):
        sol, ex = solve_sedumi(p, eps=FRONT_EPS, extra_fields=("pobj_star",))
        mats[base(p)] = sol.pobj
        star = ex["pobj_star"]
        if star is None:       # no recorded optimum: an independent check
            sedumi_certificate(p, sol, f"front door {base(p)}.mat")
            continue
        front_check(f"front door {base(p)}.mat", sol,
                    float(np.asarray(star).ravel()[0]))
    with open(os.path.join(SUITES, "cblib_mini", "optima.json")) as f:
        optima = json.load(f)
    for p in sorted(glob.glob(os.path.join(SUITES, "cblib_mini", "*.cbf"))):
        name = base(p)
        sol, _x, obj = solve_cbf(p, eps=FRONT_EPS)
        twin = name.replace("_rows", "").replace("_max", "")
        star = optima.get(name)
        if star is None:
            star = -mats[twin] if name.endswith("_max") else mats[twin]
        rel = abs(obj - star) / max(1.0, abs(star))
        print(f"front door {name}.cbf: {sol.status_name}, IPM "
              f"{sol.ipm_iters}, ADMM {sol.admm_iters}, objective (instance "
              f"sense) {obj:.10g} vs {star:.10g}"
              f"{'' if name in optima else ' (its certified .mat twin)'}, "
              "relative gap "
              f"{rel:.3e} (limit 1e-5)")
        if sol.status_name != "Solved" or rel > 1e-5:
            raise AssertionError(f"{name}.cbf: {sol.status_name}, {rel:.3e}")
    conic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k5 = mps_files_vs_highs(
        torch, dev, sorted(glob.glob(os.path.join(SUITES, "netlib_mini",
                                                  "*.mps"))),
        "front door", mps_solves=mps_solves)
    mps_s = time.perf_counter() - t0
    if k5 <= 0:
        raise AssertionError("the MPS route launched K5 no time")
    path = os.path.join(SUITES, "cblib_mini", "rand_soc_b_max.cbf")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "abip_tpu_torch", path,
                           "--json"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
        raise AssertionError("python -m abip_tpu_torch FILE.cbf failed")
    rec = json.loads(lines[-1])
    star = optima["rand_soc_b_max"]
    rel = abs(rec["objective"] - star) / max(1.0, abs(star))
    print(f"front door CLI `python -m abip_tpu_torch rand_soc_b_max.cbf "
          f"--json` ({time.perf_counter() - t0:.1f} s with start-up): "
          f"{lines[-1]}; objective vs {star:.10g}: relative gap {rel:.3e}")
    if rec["status"] != "Solved" or rel > 1e-5:
        raise AssertionError("the CLI's solve is off")
    print(f"front door files: 12 .mat + 12 .cbf in {conic_s:.1f} s, 12 .mps "
          f"in {mps_s:.1f} s, K5 launches on the MPS route {k5}")
    return k5


def phase_front_profile(torch, dev):
    """One dim-1020 solve, its workspace set up beforehand, cut at
    PROFILE_IPM barrier stages (the profiler's own processing grows with
    the ~440 launches of every ADMM iteration): the card's busy share,
    launches per ADMM iteration and the top device operations."""
    from abip_tpu_torch import ConeSpec, ConicWorkspace, conic_defaults
    from abip_tpu_torch.tools.generate import randcone

    cones = ConeSpec(**CONIC_SPEC)
    _, A, b, c, _, _ = randcone("p", CONIC_M, cones, 8740)
    ws = ConicWorkspace(A, b, c, cones, settings=conic_defaults(
        eps=FRONT_EPS, max_ipm_iters=PROFILE_IPM))
    out = {}

    def run():
        out["sol"] = ws.solve()

    prof = profile_solve(torch, run, {
        "cholesky_solve (trsm/trsv)": ("trsm", "trsv"),
        "gemv/gemm": ("gemv", "gemm", "Gemv", "Gemm"),
        "reductions": ("reduce", "Reduce", "norm")},
        f"one host conic solve dim-1020, first {PROFILE_IPM} barrier "
        "stages")
    if prof:
        it = out["sol"].admm_iters
        print(f"profile host conic: {prof['launches']} device launches over "
              f"{out['sol'].ipm_iters} IPM / {it} ADMM iterations = "
              f"{prof['launches'] / max(1, it):.1f} "
              f"per iteration; {1e3 * prof['plain_sec'] / max(1, it):.3f} ms "
              "per iteration unprofiled")


# ---------------------------------------------------------------------------
# phase 8: the rest of the batched conic driver, then LASSO and SVM
# ---------------------------------------------------------------------------

# `tools/conic_bench.py:338-340`: the batched steps engine's options
STEPS_KW = dict(engine="steps", eps=1e-6, precision="mixed", normalize=True,
                rho_y=1e-3, max_admm=1_000_000, solver="inverse",
                inner_crit_period=8)
STEPS_PROFILE_IPM = 3         # barrier stages of the profiled steps solve
# `benchmarks/ml_sweep.py` at scale 0.2: its (1000, 5000) LASSO cell and
# `sweep_svm`'s (500, 50) SVM, seeded m + n as there
LASSO_SHAPE = dict(m=200, n=1000)
SVM_SHAPE = dict(m=500, n=50)
# host_polish resumes at mu >= this: at dim-1020 a lane stopped by k_cap
# (its mu already below eps) resumed at mu = eps runs one barrier stage
# for over 20k ADMM iterations, in both packages on a CPU; from 1e-2 the
# ladder finishes in ~500
POLISH_MU_FLOOR = 1e-2
# the suites' tolerance: at eps=1e-6 rand_lp_rows.cbf ends 9.8e-6 from its
# optimum (the port on a CPU), too near the 1e-5 limit
HET_EPS = 1e-7


def counted(run, kernels):
    """(seconds, result, launches) of `run()`, each kernel's launch count
    set to 0 just before it and read just after."""
    from abip_tpu_torch.utils.timing import wall_s

    for k in kernels:
        k.launches = 0
    sec, res = wall_s(run)
    return sec, res, [k.launches for k in kernels]


def rest_line(label, sec, res, launches, card):
    admm = res.admm_iters.cpu().numpy()
    ipm = res.ipm_iters.cpu().numpy()
    print(f"{label} [{card}]: wall {sec:.3f} s, ADMM total {int(admm.sum())} "
          f"(max lane {int(admm.max())}), {admm.sum() / sec:.1f} ADMM it/s, "
          f"IPM {int(ipm.min())}-{int(ipm.max())}, launches {launches}")


class RoundLog:
    """Within the block, records the compaction rounds of sprint2 (each
    round's bucket size and shared cap) as they are launched."""

    def __enter__(self):
        from abip_tpu_torch.parallel import batched_qcp as bq

        self.rounds, self._bq, self._solve = [], bq, bq._solve

        def spy(*a, **kw):
            if kw.get("k_cap") is not None:
                self.rounds.append((kw["prepared"].A.shape[0], kw["k_cap"]))
            return self._solve(*a, **kw)

        bq._solve = spy
        return self

    def __exit__(self, *exc):
        self._bq._solve = self._solve


def phase_compaction(torch, dev, card):
    """Straggler compaction: a fresh dim-1020 B=16 batch (after an
    untimed solve of other seeds) with compact_period 0, 2048 and 256 in
    turns, three solves each, the medians answering whether compaction
    pays at B=16; B=48 at the defaults (compaction on above B=32);
    phase1="sprint" compacted at B=16.  Each against the known optima,
    K2/K3/K4 counted.  Returns {kernel: {path: launches}}."""
    from abip_tpu_torch import solve_qcp_batch
    from abip_tpu_torch.ops.conic_delta import conic_delta_cuda
    from abip_tpu_torch.ops.conic_dr import dr_sprint_cuda, ladder_cuda

    kernels = (ladder_cuda, conic_delta_cuda, dr_sprint_cuda)
    out = {"K2": {}, "K3": {}, "K4": {}}

    def note(path, launches):
        for name, n in zip(("K2", "K3", "K4"), launches):
            if n:
                out[name][path] = n

    cones, stacks, _ = conic_batch(8900)
    solve_qcp_batch(*stacks, cones=cones, device=dev,
                    **dict(CONIC_KW, compact_period=256))
    cones, stacks, stars = conic_batch(8920)
    walls = {0: [], 2048: [], 256: []}
    for cp in (0, 2048, 256, 256, 2048, 0, 0, 2048, 256):
        with RoundLog() as log:
            sec, res, launches = counted(lambda: solve_qcp_batch(
                *stacks, cones=cones, device=dev,
                **dict(CONIC_KW, compact_period=cp)), kernels)
        walls[cp].append(sec)
        label = f"sprint2 B=16 dim-1020 compact_period={cp}"
        conic_vs_optima(res, stars, label)
        if len(walls[cp]) == 1:
            rest_line(label, sec, res, launches, card)
            if cp:
                print(f"{label}: rounds (bucket, shared cap) {log.rounds}")
                note(f"sprint2 compact_period={cp} B=16", launches)
    print(f"compaction at B=16 dim-1020 [{card}]: median wall by "
          "compact_period " + ", ".join(
              f"{cp}: {sorted(w)[1]:.4f} s {[round(t, 4) for t in w]}"
              for cp, w in walls.items()))

    cones, stacks, stars = conic_batch(8940, count=48)
    with RoundLog() as log:
        sec, res, launches = counted(lambda: solve_qcp_batch(
            *stacks, cones=cones, device=dev, **CONIC_KW), kernels)
    label = "sprint2 B=48 dim-1020 defaults"
    rest_line(label, sec, res, launches, card)
    print(f"{label}: rounds (bucket, shared cap) {log.rounds}")
    conic_vs_optima(res, stars, label)
    if not log.rounds:
        raise AssertionError(f"{label}: no compaction round ran")
    note("sprint2 B=48 defaults", launches)

    cones, stacks, stars = conic_batch(8970)
    sec, res, launches = counted(lambda: solve_qcp_batch(
        *stacks, cones=cones, device=dev,
        **dict(CONIC_KW, phase1="sprint", compact_period=2048)), kernels)
    label = "sprint2 phase1=sprint B=16 dim-1020 compact_period=2048"
    rest_line(label, sec, res, launches, card)
    conic_vs_optima(res, stars, label)
    note("phase1=sprint compacted B=16", launches)
    for name, paths in out.items():
        if not sum(paths.values()):
            raise AssertionError(f"compaction paths launched {name} no time")
    return out


def phase_round_parity(torch, dev):
    """K3 at the shapes a compaction round gives it: the B=48 batch's
    phase-1 state, its unfinished lanes gathered into the round's
    power-of-two bucket (copies of active lanes fill it) with the
    prepared setup sliced to it, as `_solve_qcp_batch_twophase` does."""
    from types import SimpleNamespace

    from abip_tpu_torch.parallel.batched import _bucket

    cones, stacks, _ = conic_batch(8940, count=48)
    P = conic_prepared(torch, cones, stacks, dev)
    st = conic_phase1_state(torch, P, cones)
    active = np.flatnonzero(st.status.cpu().numpy() == 0)
    nb = _bucket(active.size)
    idx = torch.as_tensor(active[np.arange(nb) % active.size], device=dev)
    cap = min(int(st.admm_iters[idx].max()) + 2048, CONIC_KW["max_admm"])
    print(f"K3 first compaction round of B=48: {active.size} active lanes "
          f"in a bucket of {nb} ({nb - active.size} copies), shared cap "
          f"{cap}")
    _, err = delta_parity_at(
        torch, dev, f"compaction round B={nb}", P.take(idx), cones,
        SimpleNamespace(u_raw=st.u_raw[idx], v_raw=st.v_raw[idx],
                        mu=st.mu[idx]))
    return err


def phase_steps(torch, dev, card):
    """The steps endgame (sprint2, K2 then the anchored steps engine) and
    the steps engine itself at B=16 with `tools/conic_bench.py`'s options,
    with a device-only profile of its first STEPS_PROFILE_IPM barrier
    stages; precision "f64" at B=4; a full PSD Q at B=4 (mixed, the
    primal form).  Returns K2's launches on the steps endgame."""
    from abip_tpu_torch import ConeSpec, solve_qcp_batch
    from abip_tpu_torch.ops.conic_delta import conic_delta_cuda
    from abip_tpu_torch.ops.conic_dr import ladder_cuda
    from abip_tpu_torch.tools.generate import randqcp

    cones, stacks, stars = conic_batch(8990)
    sec, res, (l2, l3) = counted(lambda: solve_qcp_batch(
        *stacks, cones=cones, device=dev,
        **dict(CONIC_KW, endgame="steps")), (ladder_cuda, conic_delta_cuda))
    label = "sprint2 endgame=steps B=16 dim-1020"
    rest_line(label, sec, res, [l2, l3], card)
    conic_vs_optima(res, stars, label)
    if l2 <= 0 or l3:
        raise AssertionError(f"{label}: K2 {l2}x, K3 {l3}x")

    cones, stacks, stars = conic_batch(9010)
    sec, res = counted(lambda: solve_qcp_batch(
        *stacks[:3], cones=cones, device=dev, **STEPS_KW), ())[:2]
    label = "steps engine mixed B=16 dim-1020"
    rest_line(label, sec, res, [], card)
    conic_vs_optima(res, stars, label)
    out = {}

    def run():
        out["res"] = solve_qcp_batch(*stacks[:3], cones=cones, device=dev,
                                     **dict(STEPS_KW,
                                            max_ipm=STEPS_PROFILE_IPM))

    prof = profile_solve(torch, run, {
        "gemv/gemm": ("gemv", "gemm", "Gemv", "Gemm"),
        "reductions": ("reduce", "Reduce", "norm")},
        f"steps engine B=16 dim-1020, first {STEPS_PROFILE_IPM} barrier "
        "stages")
    if prof:
        it = int(out["res"].admm_iters.max())
        print(f"profile steps engine: {prof['launches']} device launches over "
              f"{it} lockstep ADMM iterations = "
              f"{prof['launches'] / max(1, it):.1f} per iteration; "
              f"{1e3 * prof['plain_sec'] / max(1, it):.3f} ms per iteration "
              "unprofiled")

    cones, stacks, stars = conic_batch(9030, count=4)
    sec, res = counted(lambda: solve_qcp_batch(
        *stacks[:3], cones=cones, device=dev,
        **dict(STEPS_KW, precision="f64")), ())[:2]
    label = "steps engine f64 B=4 dim-1020"
    rest_line(label, sec, res, [], card)
    conic_vs_optima(res, stars, label)

    cones = ConeSpec(**CONIC_SPEC)
    data = [randqcp("q", CONIC_M, cones, 9040 + i) for i in range(4)]
    As, bs, cs, Qs = (np.stack([d[k] for d in data]) for k in (1, 2, 3, 4))
    sec, res = counted(lambda: solve_qcp_batch(
        As, bs, cs, Qs, cones=cones, device=dev, **STEPS_KW), ())[:2]
    label = "steps engine mixed full PSD Q B=4 dim-1020"
    rest_line(label, sec, res, [], card)
    conic_vs_optima(res, np.array([d[-1] for d in data]), label)
    return l2


def phase_device_polish(torch, dev, card):
    """`solve_qcp_device` on one fresh dim-1020 instance at its defaults
    (cadence "cond", f64, inner_crit_period=1, no equilibration), and
    `host_polish` on the card of a lane the steps engine left at
    k_cap=100, resumed at mu >= POLISH_MU_FLOOR."""
    import time

    from abip_tpu_torch import ConeSpec, solve_qcp_batch
    from abip_tpu_torch.parallel import solve_qcp_device
    from abip_tpu_torch.parallel.batched_qcp import host_polish
    from abip_tpu_torch.tools.generate import randcone
    from abip_tpu_torch.utils.timing import wall_s

    cones = ConeSpec(**CONIC_SPEC)
    _, A, b, c, _, star = randcone("d", CONIC_M, cones, 9050)
    sec, r = wall_s(lambda: solve_qcp_device(A, b, c, cones=cones,
                                             eps=FRONT_EPS, device=dev))
    rel = abs(float(r.pobj) - star) / max(1.0, abs(star))
    print(f"solve_qcp_device dim-1020 defaults [{card}]: status "
          f"{int(r.status)}, IPM {int(r.ipm_iters)}, ADMM "
          f"{int(r.admm_iters)}, wall {sec:.3f} s, "
          f"{int(r.admm_iters) / sec:.1f} ADMM it/s, relative gap "
          f"{rel:.3e} (limit 1e-5)")
    if int(r.status) != 1 or rel > 1e-5 or not torch.isfinite(r.x).all():
        raise AssertionError("solve_qcp_device: off")

    _, A, b, c, _, star = randcone("p", CONIC_M, cones, 9060)
    res = solve_qcp_batch(A[None], b[None], c[None], cones=cones, device=dev,
                          k_cap=100, **STEPS_KW)
    if res.status.tolist() != [0]:
        raise AssertionError(f"k_cap=100 left status {res.status.tolist()}")
    t0 = time.perf_counter()
    sol = host_polish(A, b, c, cones, res, lane=0, eps=FRONT_EPS,
                      mu_floor=POLISH_MU_FLOOR, device=dev)
    front_check(f"host_polish on the card of a lane capped at ADMM "
                f"{int(res.admm_iters[0])}", sol, star,
                time.perf_counter() - t0)


def _status_name(code):
    from abip_tpu_torch.settings import Status

    return Status.name(int(code))


def phase_het(torch, dev, card):
    """`solve_qcp_het_batch` over the committed conic_mini (.mat) and
    cblib_mini (.cbf) suites, each as one padded batch and through the
    per-instance pool: every lane against its recorded optimum (a .mat
    without one held to `sedumi_certificate`, a .cbf without one to its
    .mat twin's objective)."""
    import glob
    from types import SimpleNamespace

    from scipy.io import loadmat

    from abip_tpu_torch.io.cbf import read_cbf
    from abip_tpu_torch.io.sedumi import load_sedumi_mat
    from abip_tpu_torch.parallel import solve_qcp_het_batch
    from abip_tpu_torch.utils.timing import wall_s

    def base(p):
        return os.path.basename(p).rsplit(".", 1)[0]

    mats = sorted(glob.glob(os.path.join(SUITES, "conic_mini", "*.mat")))
    cbfs = sorted(glob.glob(os.path.join(SUITES, "cblib_mini", "*.cbf")))
    with open(os.path.join(SUITES, "cblib_mini", "optima.json")) as f:
        optima = json.load(f)
    mat_probs, perms, mat_stars = [], [], []
    for p in mats:
        A, b, c, cones, perm = load_sedumi_mat(p)
        mat_probs.append((np.asarray(A), b, c, None, cones))
        perms.append(perm)
        star = loadmat(p, simplify_cells=True).get("pobj_star")
        mat_stars.append(None if star is None
                         else float(np.asarray(star).ravel()[0]))
    embs = [read_cbf(p) for p in cbfs]
    cbf_probs = [(e.A, e.b, e.c, None, e.cones) for e in embs]
    mat_pobj = {}
    kw = dict(eps=HET_EPS, inner_crit_period=16, device=dev)

    def summary(label, rels):
        print(f"{label}: {len(rels)} of {len(rels)} Solved, max relative "
              f"objective gap {max(rels):.3e} (limit 1e-5)")

    for route in ("batch", "pool"):
        sec, res = wall_s(lambda: solve_qcp_het_batch(mat_probs, route=route,
                                                      **kw))
        label = f"het batch conic_mini (12 .mat) route={route}"
        rest_line(label, sec, res, [], card)
        rels = []
        for k, p in enumerate(mats):
            m, n = mat_probs[k][0].shape
            inv = np.argsort(perms[k])
            sol = SimpleNamespace(
                x=res.x[k, :n].cpu().numpy()[inv],
                y=res.y[k, :m].cpu().numpy(),
                s=res.s[k, :n].cpu().numpy()[inv],
                status_name=_status_name(res.status[k]),
                ipm_iters=int(res.ipm_iters[k]),
                admm_iters=int(res.admm_iters[k]),
                pobj=float(res.pobj[k]))
            label = f"het {route} {base(p)}.mat"
            mat_pobj[base(p)] = sol.pobj
            if mat_stars[k] is None:
                sedumi_certificate(p, sol, label)
            else:
                rels.append(het_check(label, sol.status_name, sol.pobj,
                                      mat_stars[k]))
        summary(f"{label} with a recorded optimum", rels)
        sec, res = wall_s(lambda: solve_qcp_het_batch(cbf_probs, route=route,
                                                      **kw))
        label = f"het batch cblib_mini (12 .cbf) route={route}"
        rest_line(label, sec, res, [], card)
        rels = []
        for k, p in enumerate(cbfs):
            name = base(p)
            star = optima.get(name)
            if star is None:
                twin = mat_pobj[name.replace("_rows", "").replace("_max", "")]
                star = -twin if name.endswith("_max") else twin
            rels.append(het_check(f"het {route} {name}.cbf",
                                  _status_name(res.status[k]),
                                  embs[k].objective(float(res.pobj[k])),
                                  star))
        summary(f"{label} (instance sense; a missing optimum from the .mat "
                "twin)", rels)


def het_check(label, status_name, obj, star):
    rel = abs(obj - star) / max(1.0, abs(star))
    if status_name != "Solved" or not np.isfinite(obj) or rel > 1e-5:
        raise AssertionError(f"{label}: {status_name}, objective {obj!r} vs "
                             f"{star!r} ({rel:.3e})")
    return rel


def _spec_norm_sq(X, iters=60, seed=0):
    """`benchmarks/ml_sweep._spec_norm_sq`: the largest singular value
    squared by power iteration, with a 2% cushion."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(X.shape[1])
    v /= np.linalg.norm(v)
    s = 0.0
    for _ in range(iters):
        w = X.T @ (X @ v)
        s = np.linalg.norm(w)
        v = w / max(s, 1e-30)
    return s * 1.02


def ista_lasso(X, y, lam, iters=5000, tol=1e-10):
    """A copy of `benchmarks/ml_sweep.ista_lasso` (FISTA) as the LASSO
    oracle: min 1/2||Xw - y||^2 + lam ||w||_1."""
    L = _spec_norm_sq(X)
    w = np.zeros(X.shape[1])
    z = w.copy()
    t = 1.0
    obj_prev = np.inf
    for _ in range(iters):
        g = X.T @ (X @ z - y)
        w_new = z - g / L
        w_new = np.sign(w_new) * np.maximum(np.abs(w_new) - lam / L, 0.0)
        t_new = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        z = w_new + (t - 1) / t_new * (w_new - w)
        w, t = w_new, t_new
        obj = 0.5 * np.linalg.norm(X @ w - y) ** 2 + lam * np.abs(w).sum()
        if abs(obj_prev - obj) < tol * max(1.0, abs(obj)):
            break
        obj_prev = obj
    return w, obj


def phase_ml(torch, dev, card):
    """The LASSO and SVM front doors on the card: `solve_lasso` (the host
    conic driver) and `solve_lasso_batch` (a lambda grid of 8 as one
    steps-engine batch at its defaults) on `lasso_instance(m=200,
    n=1000)`, each against the FISTA oracle within 1e-5; `solve_svm` in
    both forms on `svm_instance(m=500, n=50)`, the two objectives within
    1e-5 of each other."""
    import time

    from benchmarks.generate import lasso_instance, svm_instance

    from abip_tpu_torch.problems import (solve_lasso, solve_lasso_batch,
                                         solve_svm)
    from abip_tpu_torch.utils.timing import wall_s

    m, n = LASSO_SHAPE["m"], LASSO_SHAPE["n"]
    X, y, lam = lasso_instance(m=m, n=n, seed=m + n)
    star = ista_lasso(X, y, lam)[1]
    t0 = time.perf_counter()
    _, obj, sol = solve_lasso(X, y, lam, eps=FRONT_EPS, device=dev)
    rel = het_check("solve_lasso", sol.status_name, obj, star)
    print(f"solve_lasso m={m} n={n} [{card}]: {sol.status_name}, IPM "
          f"{sol.ipm_iters}, ADMM {sol.admm_iters}, wall "
          f"{time.perf_counter() - t0:.3f} s, objective {obj:.10g} vs FISTA "
          f"{star:.10g}, relative gap {rel:.3e} (limit 1e-5)")
    lams = lam * np.geomspace(0.5, 2.0, 8)
    stars = np.array([ista_lasso(X, y, v)[1] for v in lams])
    sec, (W, objs, res) = wall_s(lambda: solve_lasso_batch(
        np.stack([X] * 8), np.stack([y] * 8), lams, eps=FRONT_EPS,
        device=dev))
    rest_line(f"solve_lasso_batch B=8 m={m} n={n} (a lambda grid)", sec, res,
              [], card)
    for k in range(8):
        het_check(f"solve_lasso_batch lane {k}",
                  _status_name(res.status[k]), objs[k], stars[k])
    print(f"solve_lasso_batch vs FISTA: max relative gap "
          f"{(np.abs(objs - stars) / np.maximum(1, np.abs(stars))).max():.3e}"
          " (limit 1e-5)")
    Xs, ys = svm_instance(m=SVM_SHAPE["m"], n=SVM_SHAPE["n"],
                          seed=SVM_SHAPE["m"] + SVM_SHAPE["n"])
    objs = {}
    for form in ("qp", "socp"):
        t0 = time.perf_counter()
        _, _, objs[form], sol = solve_svm(Xs, ys, 1.0, form=form,
                                          eps=FRONT_EPS, device=dev)
        print(f"solve_svm {form} m={SVM_SHAPE['m']} n={SVM_SHAPE['n']} "
              f"[{card}]: {sol.status_name}, IPM {sol.ipm_iters}, ADMM "
              f"{sol.admm_iters}, wall {time.perf_counter() - t0:.3f} s, "
              f"objective {objs[form]:.10g}")
        if sol.status_name != "Solved":
            raise AssertionError(f"solve_svm {form}: {sol.status_name}")
    het_check("solve_svm QP vs SOCP", "Solved", objs["qp"], objs["socp"])


# ---------------------------------------------------------------------------
# phase 9: the rest of the single-card port
# ---------------------------------------------------------------------------

# same-pattern PageRank families: `tools/pagerank_batch_bench._family`'s
# deg 6, alpha linspace(0.80, 0.87, B), seed 0, at the sizes its bench
# names (n = 1e4: 70k stored entries a lane, n = 1e5: 700k)
PR_SIZES = (10_000, 100_000)
PR_B = 8
PR_EPS = 1e-6
PR_PROFILE_IPM = 3            # barrier stages of the profiled family solve
# the lane-swap stream against fixed batches (`bench.reference_smoke_lp`)
STREAM_COUNT = 48
STREAM_KW = dict(B=16, seg_chunks=32, qres_period=64, eps=1e-6)
POOL_COUNT = 8
POOL_WORKERS = (1, 4)
PDHG_EPS = 1e-6
PDHG_BATCH_KW = dict(eps=1e-6, precision="mixed")
# differentiation: the gradient of pobj w.r.t. b against y and a central
# finite difference (step FD_STEP) on FD_COORDS coordinates of b; the
# LASSO's d||w||_1/dlam against one of step FD_LAM lam
GRAD_EPS = 1e-8
FD_COORDS = (0, 17, 41)
FD_STEP = 1e-2
FD_LAM = 1e-3
def pagerank_family(n, count, seed=0):
    """A same-pattern PageRank family as `tools/pagerank_batch_bench.
    _family` builds it (a copy: that tool's `main` imports JAX): the
    shared pattern (rows sorted), values (count, nnz), b, c."""
    import scipy.sparse as sp

    from benchmarks.generate import pagerank_lp

    rows = cols = None
    valss, bs, cs = [], [], []
    for a in np.linspace(0.80, 0.87, count):
        A, b, c = pagerank_lp(n=n, deg=6, alpha=float(a), seed=seed)
        Ac = sp.coo_matrix(A)
        order = np.lexsort((Ac.col, Ac.row))
        if rows is None:
            rows, cols = Ac.row[order].astype(np.int32), \
                Ac.col[order].astype(np.int32)
        valss.append(Ac.data[order])
        bs.append(b)
        cs.append(c)
    return rows, cols, np.stack(valss), np.stack(bs), np.stack(cs)


def phase_pagerank(torch, dev, card):
    """B=8 same-pattern PageRank families at n = 1e4 and 1e5 through
    `solve_lp_batch_coo` (eps=1e-6): every lane Solved with
    |1'x - 1| <= 1e-5 (the exact optimum); then a profile of the first
    PR_PROFILE_IPM barrier stages (launches, busy share, CG iterations
    per ADMM iteration)."""
    import time

    from abip_tpu_torch.parallel import solve_lp_batch_coo
    from abip_tpu_torch.utils.timing import wall_s

    for n in PR_SIZES:
        t0 = time.perf_counter()
        fam = pagerank_family(n, PR_B)
        build = time.perf_counter() - t0

        def run(max_ipm=200, info=None):
            return solve_lp_batch_coo(*fam, m=n, n=n, eps=PR_EPS,
                                      max_ipm=max_ipm, info=info)

        info = {}
        sec, res = wall_s(lambda: run(info=info))
        ones = res.x.sum(-1).cpu().numpy()
        admm = res.admm_iters.cpu().numpy()
        cg = info["cg_iters"].cpu().numpy()
        status = res.status.cpu().numpy()
        print(f"PageRank family B={PR_B} n={n} ({fam[0].size} stored entries "
              f"a lane, built in {build:.1f} s) [{card}]: wall {sec:.3f} s, "
              f"status {status.tolist()}, ADMM {admm.tolist()}, IPM "
              f"{res.ipm_iters.tolist()}, CG {cg.tolist()} "
              f"({cg.sum() / admm.sum():.2f} per ADMM iteration), "
              f"|1'x - 1| max {np.abs(ones - 1).max():.3e} (limit 1e-5)")
        if (status != 1).any() or not (np.abs(ones - 1) <= 1e-5).all():
            raise AssertionError(f"PageRank n={n}: status {status.tolist()}, "
                                 f"1'x {ones.tolist()}")
        pinfo, last = {}, {}

        def staged():
            last["res"] = run(PR_PROFILE_IPM, pinfo)

        prof = profile_solve(torch, staged, {},
                             f"PageRank B={PR_B} n={n}, first "
                             f"{PR_PROFILE_IPM} barrier stages")
        if prof is not None:
            r = last["res"]
            lock = int(r.admm_iters.max())
            cg_rate = float(pinfo["cg_iters"].sum()) / max(
                1, int(r.admm_iters.sum()))
            print(f"profile PageRank n={n}: {prof['launches']} launches over "
                  f"{lock} lockstep ADMM iterations = "
                  f"{prof['launches'] / max(1, lock):.1f} per iteration, "
                  f"{cg_rate:.2f} CG iterations per ADMM iteration, device "
                  "busy "
                  f"{100 * prof['busy_us'] / 1e6 / prof['plain_sec']:.1f}% of "
                  "the unprofiled wall")


def phase_stream(torch, dev, card):
    """48 fresh smoke LPs through the lane-swap stream (B=16, seg_chunks=32,
    qres_period=64) and through `solve_lp_batch` in fixed batches of 16
    (`SOLVE_KW`: delta, K1), each within 1e-5 of HiGHS."""
    from abip_tpu_torch.parallel import solve_lp_batch
    from abip_tpu_torch.parallel.segmented import solve_lp_stream
    from abip_tpu_torch.utils.timing import wall_s

    data, stacks = smoke_batch(9000, STREAM_COUNT)
    sec_s, (out, info) = wall_s(lambda: solve_lp_stream(data, **STREAM_KW))
    bad = [r["status"] for r in out if r["status"] != 1]
    if bad:
        raise AssertionError(f"stream: statuses {bad}")
    worst_s = highs_worst_gap(data, [r["pobj"] for r in out], "stream")
    print(f"stream {STREAM_COUNT} smoke LPs B={STREAM_KW['B']} seg_chunks="
          f"{STREAM_KW['seg_chunks']} qres_period={STREAM_KW['qres_period']} "
          f"[{card}]: wall {sec_s:.3f} s, {info['segments']} segments, ADMM "
          f"total {info['total_admm_iters']}, solved {info['solved']}/"
          f"{STREAM_COUNT}, vs HiGHS max relative gap {worst_s:.3e} "
          "(limit 1e-5)")
    secs, admm = [], 0
    for k in range(0, STREAM_COUNT, B):
        sec, res = wall_s(lambda: solve_lp_batch(
            *(x[k:k + B] for x in stacks), device=dev, **SOLVE_KW))
        lp_vs_highs(data[k:k + B], res, f"fixed batch {k // B}")
        secs.append(sec)
        admm += int(res.admm_iters.sum())
    print(f"fixed batches {len(secs)} x B={B} (delta, T=1536) [{card}]: "
          f"walls {[round(s, 4) for s in secs]} s, total {sum(secs):.3f} s, "
          f"ADMM total {admm}; the stream's wall / the batches' "
          f"{sec_s / sum(secs):.2f}")


def _lane_equal(torch, a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("x", "y", "s", "status", "ipm_iters", "admm_iters", "pobj"))


def phase_pool(torch, dev, card):
    """8 smoke LPs through `solve_lp_pool` (`SOLVE_KW`: the delta engine,
    K1 on each worker's CUDA stream) at workers 1 and 4: equal results,
    each within 1e-5 of HiGHS; then K1 held to its plain version on a
    mid-solve anchor issued from a worker thread's stream.  Returns K1's
    launches at each worker count."""
    from concurrent.futures import ThreadPoolExecutor

    from abip_tpu_torch.ops.admm_delta import delta_chunk_cuda
    from abip_tpu_torch.parallel import solve_lp_pool

    data, _ = smoke_batch(9100, POOL_COUNT)
    runs, launches = {}, {}
    for w in POOL_WORKERS:
        sec, out, (k1,) = counted(
            lambda: solve_lp_pool(data, workers=w, **SOLVE_KW),
            [delta_chunk_cuda])
        runs[w], launches[f"workers={w}"] = out, k1
        worst = highs_worst_gap(data, [float(r.pobj) for r in out],
                                f"pool {w}")
        admm = sum(int(r.admm_iters) for r in out)
        print(f"pool {POOL_COUNT} smoke LPs workers={w} [{card}]: wall "
              f"{sec:.3f} s, ADMM total {admm}, K1 launches {k1}, vs HiGHS "
              f"max relative gap {worst:.3e} (limit 1e-5)")
        if k1 <= 0:
            raise AssertionError(f"pool workers={w} launched K1 no time")
    same = [_lane_equal(torch, a, b) for a, b in zip(*runs.values())]
    print(f"pool workers=1 vs workers=4: {sum(same)}/{POOL_COUNT} instances "
          "equal bit for bit")
    if not all(same):
        raise AssertionError("the pool's results differ between worker "
                             "counts")

    def on_worker_stream():
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.default_stream(dev))
        with torch.cuda.stream(stream):
            return k1_parity(torch, dev, "smoke, from a worker thread's "
                             "stream", SMOKE, 4)

    with ThreadPoolExecutor(1) as ex:
        ex.submit(on_worker_stream).result()
    return launches


def phase_pdhg(torch, dev, card):
    """Restarted PDHG on the card: every netlib_mini .mps through
    `solve_mps(method="pdhg")` against HiGHS on its presolved form (as
    phase 7 holds it), every cblib_mini .cbf through `solve_qcp_pdhg`
    against optima.json (a file without one against the ADMM solve of
    its .cbf, phase 7's certified route), and a B=16 smoke batch through
    `solve_lp_pdhg_batch(precision="mixed")` against HiGHS; each Solved
    within 1e-5 relative.  Returns the batch's (stacks, state, wall) for
    phase 10."""
    import glob
    import time

    from scipy.optimize import linprog

    from abip_tpu_torch import solve_qcp_pdhg
    from abip_tpu_torch.io.cbf import read_cbf, solve_cbf
    from abip_tpu_torch.io.presolve import solve_mps
    from abip_tpu_torch.pdhg import solve_lp_pdhg_batch
    from abip_tpu_torch.utils.timing import wall_s

    def base(p):
        return os.path.basename(p).rsplit(".", 1)[0]

    def check(label, sol, obj, star, sec):
        rel = abs(obj - star) / max(1.0, abs(star))
        print(f"PDHG {label} [{card}]: {sol.status_name}, {sol.admm_iters} "
              f"PDHG iterations, wall {sec:.3f} s, objective {obj:.10g} vs "
              f"{star:.10g}, relative gap {rel:.3e} (limit 1e-5)")
        if sol.status_name != "Solved" or not rel <= 1e-5:
            raise AssertionError(f"PDHG {label}: {sol.status_name}, "
                                 f"{rel:.3e}")

    t0 = time.perf_counter()
    for p in sorted(glob.glob(os.path.join(SUITES, "netlib_mini", "*.mps"))):
        sec, (sol, std) = wall_s(lambda: solve_mps(p, method="pdhg",
                                                   eps=PDHG_EPS))
        ref = linprog(std.c, A_eq=std.A, b_eq=std.b, bounds=(0, None),
                      method="highs")
        check(f"{base(p)}.mps", sol, sol.pobj, std.user_objective(ref.fun),
              sec)
    mps_s = time.perf_counter() - t0
    with open(os.path.join(SUITES, "cblib_mini", "optima.json")) as f:
        optima = json.load(f)
    t0 = time.perf_counter()
    for p in sorted(glob.glob(os.path.join(SUITES, "cblib_mini", "*.cbf"))):
        emb = read_cbf(p)
        sec, sol = wall_s(lambda: solve_qcp_pdhg(emb.A, emb.b, emb.c,
                                                 emb.cones, eps=PDHG_EPS))
        star = optima.get(base(p))
        if star is None:
            star = solve_cbf(p, eps=FRONT_EPS)[2]
        check(f"{base(p)}.cbf", sol, emb.objective(sol.pobj), star, sec)
    cbf_s = time.perf_counter() - t0
    data, stacks = smoke_batch(9300)
    sec, st = wall_s(lambda: solve_lp_pdhg_batch(*stacks, **PDHG_BATCH_KW))
    status = st.status.cpu().numpy()
    if (status != 1).any():
        raise AssertionError(f"PDHG batch: statuses {status.tolist()}")
    worst = highs_worst_gap(data, st.pobj.tolist(), "PDHG batch")
    k = st.k.cpu().numpy()
    print(f"PDHG batch B={B} smoke mixed [{card}]: wall {sec:.3f} s, PDHG "
          f"iterations {k.tolist()} ({int(k.max())} lockstep, "
          f"{int(k.sum()) / sec:.1f} aggregate it/s), vs HiGHS max relative "
          f"gap {worst:.3e} (limit 1e-5)")
    print(f"PDHG suites [{card}]: 12 .mps in {mps_s:.1f} s, 12 .cbf in "
          f"{cbf_s:.1f} s")
    return stacks, st, sec


def phase_crossover(torch, dev, card, mps_solves):
    """`python -m abip_tpu_torch blend01.mps --crossover --json` as a
    subprocess: Solved, optimal_basis=True and the vertex objective within
    1e-7 relative of HiGHS; then `crossover` after each netlib_mini ADMM
    solve of phase 7 (`mps_solves`), counting the certified bases."""
    import time

    from scipy.optimize import linprog

    from abip_tpu_torch.crossover import crossover

    path = os.path.join(SUITES, "netlib_mini", "blend01.mps")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "abip_tpu_torch", path,
                           "--crossover", "--json"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    lines = proc.stdout.splitlines()
    cross = [ln for ln in lines if ln.startswith("crossover:")]
    recs = [ln for ln in lines if ln.startswith("{")]
    if proc.returncode or not cross or not recs:
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
        raise AssertionError("python -m abip_tpu_torch --crossover failed")
    fields = dict(f.split("=") for f in cross[0].split()[1:])
    std, _ = mps_solves["blend01"]
    ref = linprog(std.c, A_eq=std.A, b_eq=std.b, bounds=(0, None),
                  method="highs")
    star = std.user_objective(ref.fun)
    rel = abs(float(fields["vertex_obj"]) - star) / max(1.0, abs(star))
    print(f"crossover CLI `python -m abip_tpu_torch blend01.mps --crossover "
          f"--json` ({time.perf_counter() - t0:.1f} s with start-up): "
          f"{cross[0]}; {recs[-1]}; vertex vs HiGHS {star:.10g}: relative "
          f"gap {rel:.3e} (limit 1e-7)")
    if (fields["optimal_basis"] != "True" or not rel <= 1e-7
            or json.loads(recs[-1])["status"] != "Solved"):
        raise AssertionError("the CLI's crossover did not certify blend01")
    certified = []
    for name, (std, x_std) in sorted(mps_solves.items()):
        t0 = time.perf_counter()
        cr = crossover(std.A.toarray(), std.b, std.c, x_std)
        print(f"crossover {name}.mps after its ADMM solve: optimal_basis="
              f"{cr.optimal}, vertex objective "
              f"{std.user_objective(cr.pobj):.10g}, primal feasibility "
              f"{cr.primal_feas:.2e}, min reduced cost "
              f"{cr.min_reduced_cost:.2e} ({time.perf_counter() - t0:.2f} s)")
        if cr.optimal:
            certified.append(name)
    print(f"crossover: {len(certified)}/{len(mps_solves)} netlib_mini files "
          f"give an optimal basis (the reference's record "
          f"benchmarks/results/r02_netlib_mini_crossover: 12/12)")


def phase_grad(torch, dev, card):
    """`solve_lp_grad` on one smoke LP (m=50, n=2000, eps=GRAD_EPS, the
    delta engine of `SOLVE_KW`: K1), as one batched forward of b and its
    central-difference neighbours b +- FD_STEP e_i on FD_COORDS: the
    gradient of pobj w.r.t. b (lane 0's backward) equals y within 1e-6
    of y's scale and the central differences within 1e-4 of it;
    `solve_lasso_grad` on `lasso_instance(m=200, n=1000)`: d(||w||_1)/d
    lam against a central difference (step FD_LAM of lam) within 1e-3
    relative."""
    import time

    from benchmarks.generate import lasso_instance

    from abip_tpu_torch import solve_lasso_grad, solve_lp_grad
    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(seed=9200, **SMOKE)
    steps = [np.zeros_like(b)]
    for i in FD_COORDS:
        for sign in (1.0, -1.0):
            steps.append(np.zeros_like(b))
            steps[-1][i] = sign * FD_STEP
    bt = torch.tensor(b + np.stack(steps), device=dev, requires_grad=True)
    ct = torch.as_tensor(c, device=dev)
    opts = {k: v for k, v in SOLVE_KW.items() if k != "eps"}
    t0 = time.perf_counter()
    x, y, _ = solve_lp_grad(A, bt, c, eps=GRAD_EPS, **opts)
    pobj = x @ ct
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    pobj[0].backward()
    g = bt.grad[0].cpu().numpy()
    bwd = time.perf_counter() - t0
    p = pobj.detach().cpu().numpy()
    yv = y[0].detach().cpu().numpy()
    scale = np.abs(yv).max()
    err = np.abs(g - yv).max()
    fd = [(p[1 + 2 * k] - p[2 + 2 * k]) / (2 * FD_STEP)
          for k in range(len(FD_COORDS))]
    fd_err = max(abs(f - g[i]) for f, i in zip(fd, FD_COORDS))
    print(f"solve_lp_grad smoke m=50 n=2000 eps={GRAD_EPS} (delta engine, "
          f"{len(steps)} lanes: b and its central-difference neighbours) "
          f"[{card}]: forward {fwd:.3f} s, backward {bwd:.3f} s, pobj "
          f"{p[0]:.10g}; |d pobj/db - y| max {err:.3e} (limit 1e-6 x "
          f"{scale:.3e}); central differences (step {FD_STEP}) at "
          f"b{list(FD_COORDS)} {[round(float(f), 8) for f in fd]} vs gradient "
          f"{[round(float(g[i]), 8) for i in FD_COORDS]}, max gap "
          f"{fd_err:.3e} (limit 1e-4 x {scale:.3e})")
    if not (err <= 1e-6 * scale and fd_err <= 1e-4 * scale):
        raise AssertionError("solve_lp_grad: the gradient is off")
    m, n = LASSO_SHAPE["m"], LASSO_SHAPE["n"]
    X, yl, lam = lasso_instance(m=m, n=n, seed=m + n)
    lt = torch.tensor(float(lam), device=dev, requires_grad=True)
    t0 = time.perf_counter()
    w = solve_lasso_grad(X, yl, lt, eps=GRAD_EPS)
    l1 = w.abs().sum()
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    l1.backward()
    g = float(lt.grad)
    bwd = time.perf_counter() - t0
    h = FD_LAM * lam
    fp, fm = (float(solve_lasso_grad(X, yl, lam + s * h,
                                     eps=GRAD_EPS).abs().sum())
              for s in (1.0, -1.0))
    fd = (fp - fm) / (2 * h)
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    print(f"solve_lasso_grad m={m} n={n} lam={lam:.6g} eps={GRAD_EPS} "
          f"[{card}]: forward {fwd:.3f} s, backward {bwd:.3f} s, ||w||_1 "
          f"{float(l1.detach()):.10g}, d||w||_1/dlam {g:.8g} vs central "
          f"difference {fd:.8g}, relative gap {rel:.3e} (limit 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError("solve_lasso_grad: the gradient is off")


# ---------------------------------------------------------------------------
# the host LP driver and K5
# ---------------------------------------------------------------------------

# `benchmarks/results/r05_lp_m1000_tpu.json`'s at-scale LP shape
# phase 10: the multi-card layer on a one-rank NCCL group
MESH_RHO_Y = 1e-3
MESH_KKT_ATOL = 1e-7        # the reference's bar (`tests/test_parallel.py:72-84`)
MESH_DENSE_REL = 1e-9       # sharded dense pobj against the unsharded
MESH_BATCH_REL = 1e-10      # meshed batch pobj against the unmeshed
MESH_PDHG_RTOL = 1e-8       # the reference's (`tests/test_pdhg.py:135-142`)
MESH_CONIC_SEED = 8730


@contextlib.contextmanager
def one_rank_nccl(device_index=0):
    """A one-rank NCCL process group on card `device_index` (its
    `FileStore` in a temporary directory), checked with one
    `all_reduce`; yields `mesh(axis)`, a 1-D `DeviceMesh("cuda")` with
    that axis, and destroys the group on exit.  NCCL that cannot form
    raises: there is no gloo fallback.

    Unless the caller's environment says otherwise, PyTorch's NCCL
    flight recorder and heartbeat monitor are off
    (`TORCH_FR_BUFFER_SIZE=0`, `TORCH_NCCL_ENABLE_MONITORING=0`):
    a sharded host solve issues a collective every few operations, and
    with both on (PyTorch's defaults) phase 10's sharded solves took
    2.7-3.2x their unsharded walls on one rank."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    os.environ.setdefault("TORCH_FR_BUFFER_SIZE", "0")
    os.environ.setdefault("TORCH_NCCL_ENABLE_MONITORING", "0")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(device_index)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            if dist.get_backend() != "nccl":
                raise RuntimeError(f"backend {dist.get_backend()}, not nccl")
            probe = torch.ones(1, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            if probe.item() != 1.0:
                raise RuntimeError("a one-rank all_reduce changed its input")
            yield lambda axis: init_device_mesh(
                "cuda", (1,), mesh_dim_names=(axis,))
        finally:
            dist.destroy_process_group()


def phase_multi_card(torch, dev, card, pdhg_batch):
    """The multi-card layer (`parallel.sharded`, `LPWorkspace.shard`,
    `ConicWorkspace.shard`, the batch drivers' `mesh=`) on a one-rank
    NCCL group, each at full size and against its unsharded run: the
    KKT solver on the host LP's A made dense against an f64 dense solve
    of the KKT system; the dense host LP sharded with linsys "dense"
    (equal status and counts, pobj to 1e-9, within 1e-5 of HiGHS) and,
    at m=200, with "cg" (ADMM within max(5, 5%)); a dim-1020 conic
    instance through CG sharded (Solved within 1e-5 of its optimum,
    ADMM within max(5, 5%)); the B=16 smoke batch over the mesh (K1;
    statuses and counts equal, pobj to 1e-10) and phase 9's PDHG batch
    (pobj to rtol 1e-8).  On one rank the ratios measure the
    collectives' overhead, not scaling.  Returns K1's launches in the
    meshed batch."""
    import scipy.sparse as sp

    from bench import reference_smoke_lp

    from abip_tpu_torch import (ConeSpec, ConicWorkspace, LPWorkspace,
                                Settings, conic_defaults)
    from abip_tpu_torch.linsys.schur import CGSchurSolver
    from abip_tpu_torch.ops.admm_delta import delta_chunk_cuda
    from abip_tpu_torch.parallel import solve_lp_batch
    from abip_tpu_torch.parallel.sharded import make_sharded_kkt_solver
    from abip_tpu_torch.pdhg import solve_lp_pdhg_batch
    from abip_tpu_torch.tools.generate import randcone
    from abip_tpu_torch.utils.timing import wall_s

    def ratio(label, base_s, shard_s):
        print(f"mesh {label} [{card}]: unsharded {base_s:.3f} s, sharded "
              f"{shard_s:.3f} s, ratio {shard_s / base_s:.3f}")

    def counts_close(label, base, sh):
        if abs(sh.admm_iters - base.admm_iters) > max(
                5, 0.05 * base.admm_iters):
            raise AssertionError(f"mesh {label}: ADMM {sh.admm_iters} vs "
                                 f"unsharded {base.admm_iters}")

    with one_rank_nccl() as mesh:
        rows, batch = mesh("rows"), mesh("batch")

        A, b, c = reference_smoke_lp(seed=HOST_SEEDS[0], **HOST_LP)
        m, n = A.shape
        rng = np.random.default_rng(11)
        w_y, w_x = rng.standard_normal(m), rng.standard_normal(n)
        sec, (z_y, z_x, its) = wall_s(lambda: make_sharded_kkt_solver(
            A, MESH_RHO_Y, rows)(w_y, w_x))
        At = torch.as_tensor(A, device=dev)
        K = torch.cat([torch.cat([MESH_RHO_Y * torch.eye(
            m, dtype=At.dtype, device=dev), At], 1), torch.cat(
            [At.T, -torch.eye(n, dtype=At.dtype, device=dev)], 1)])
        z = torch.linalg.solve(K, torch.as_tensor(
            np.concatenate([w_y, w_x]), device=dev))
        del K
        err = max(float((z_y - z[:m]).abs().max()),
                  float((z_x - z[m:]).abs().max()))
        print(f"mesh KKT solver m={m} n={n} dense A (f64) [{card}]: {its} "
              f"CG iterations, {sec:.3f} s, max |z - dense KKT solve| "
              f"{err:.3e} (limit {MESH_KKT_ATOL}, largest |z| "
              f"{float(z.abs().max()):.3e})")
        if not err <= MESH_KKT_ATOL:
            raise AssertionError("mesh KKT solver: off the dense solve")

        def host(A, b, c, shard=None, **kw):
            ws = LPWorkspace(A, b, c, Settings(eps=HOST_EPS, **kw))
            if shard is not None:
                ws.shard(rows, linsys=shard)
            return ws.solve()

        base_s, base = wall_s(lambda: host(A, b, c))
        sh_s, sh = wall_s(lambda: host(A, b, c, shard="dense"))
        fun, hs = highs(sp.csr_matrix(A), b, c)
        rel = abs(sh.pobj - fun) / max(1.0, abs(fun))
        print(f"mesh host LP m={m} dense, shard(linsys='dense'): "
              f"{sh.status_name}, IPM {sh.ipm_iters}, ADMM {sh.admm_iters} "
              f"(unsharded {base.status_name}, {base.ipm_iters}, "
              f"{base.admm_iters}), pobj rel to unsharded "
              f"{abs(sh.pobj - base.pobj) / abs(base.pobj):.3e} (limit "
              f"{MESH_DENSE_REL}), vs HiGHS {rel:.3e} (limit 1e-5)")
        ratio(f"host LP m={m} dense", base_s, sh_s)
        if (sh.status_name != "Solved" or base.status_name != "Solved"
                or (sh.ipm_iters, sh.admm_iters)
                != (base.ipm_iters, base.admm_iters)
                or abs(sh.pobj - base.pobj) > MESH_DENSE_REL * abs(base.pobj)
                or rel > 1e-5):
            raise AssertionError("mesh host LP dense: off the unsharded "
                                 "solve or HiGHS")

        A2, b2, c2 = host_lp(22, **HOST_CG)
        A2 = A2.toarray()
        base_s, base = wall_s(lambda: host(A2, b2, c2, linsys="cg"))
        sh_s, sh = wall_s(lambda: host(A2, b2, c2, shard="cg",
                                       linsys="cg"))
        print(f"mesh host LP cg m=200: {sh.status_name}, ADMM "
              f"{sh.admm_iters} (unsharded {base.admm_iters}, limit max(5, "
              f"5%)), avg CG {sh.avg_cg_iters:.2f}")
        ratio("host LP cg m=200", base_s, sh_s)
        if sh.status_name != "Solved":
            raise AssertionError(f"mesh host LP cg: {sh.status_name}")
        counts_close("host LP cg", base, sh)

        cones = ConeSpec(**CONIC_SPEC)
        _, Ac, bc, cc, _, star = randcone("mesh", CONIC_M, cones,
                                          MESH_CONIC_SEED)

        def conic(shard):
            ws = ConicWorkspace(Ac, bc, cc, cones, settings=conic_defaults(
                eps=FRONT_EPS, linsys="cg"))
            if not isinstance(ws.solver, CGSchurSolver):
                raise AssertionError("linsys='cg' did not take the CG Schur "
                                     "solver")
            if shard:
                ws.shard(rows)
            return ws.solve()

        base_s, base = wall_s(lambda: conic(False))
        sh_s, sh = wall_s(lambda: conic(True))
        front_check(f"mesh conic dim-1020 CG shard (avg CG "
                    f"{sh.avg_cg_iters:.1f}; unsharded ADMM "
                    f"{base.admm_iters})", sh, star, sh_s)
        ratio("conic dim-1020 CG", base_s, sh_s)
        counts_close("conic CG", base, sh)

        data, stacks = smoke_batch(1000)
        base_s, base = wall_s(lambda: solve(torch, stacks, dev))
        delta_chunk_cuda.launches = 0
        sh_s, sh = wall_s(lambda: solve_lp_batch(*stacks, mesh=batch,
                                                 device=dev, **SOLVE_KW))
        launches = delta_chunk_cuda.launches
        same = all(torch.equal(getattr(sh, f), getattr(base, f))
                   for f in ("status", "ipm_iters", "admm_iters"))
        prel = float(((sh.pobj - base.pobj).abs() / base.pobj.abs()).max())
        print(f"mesh LP batch B={B} delta over the mesh: statuses "
              f"{sh.status.tolist()}, ADMM total {int(sh.admm_iters.sum())}"
              f", counts equal to the unmeshed batch: {same}, max pobj rel "
              f"{prel:.3e} (limit {MESH_BATCH_REL}), K1 launches "
              f"{launches}")
        ratio(f"LP batch B={B} delta", base_s, sh_s)
        if not same or not prel <= MESH_BATCH_REL or launches <= 0 or bool(
                (sh.status != 1).any()):
            raise AssertionError("mesh LP batch: off the unmeshed batch")

        stacks9, st9, base_s = pdhg_batch
        sh_s, st = wall_s(lambda: solve_lp_pdhg_batch(
            *stacks9, mesh=batch, **PDHG_BATCH_KW))
        prel = float(((st.pobj - st9.pobj).abs() / st9.pobj.abs()).max())
        print(f"mesh PDHG batch B={B} mixed over the mesh: statuses "
              f"{st.status.tolist()}, iterations equal: "
              f"{torch.equal(st.k, st9.k)}, max pobj rel {prel:.3e} "
              f"(limit {MESH_PDHG_RTOL})")
        ratio(f"PDHG batch B={B}", base_s, sh_s)
        if not torch.equal(st.status, st9.status) or not prel <= \
                MESH_PDHG_RTOL:
            raise AssertionError("mesh PDHG batch: off the unmeshed batch")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the validators and examples
# ---------------------------------------------------------------------------

# fuzz_conic --batched --engine sprint2 at the size of
# `benchmarks/results/r05_conic_fuzz_ladder.jsonl` (18 a class), so each
# verdict compares seed for seed with that JAX run, but each class only
# up to its first lane that took more than FUZZ_LANE_CAP lockstep ADMM
# iterations in r05.  The tool keeps the JAX tool's inner_crit_period=1,
# so every lockstep iteration is one K3 launch between host-issued f64
# work (the steps engine of a full Q likewise): 6.2-9.4 ms each on an
# H100 (PERF.md), and a lane of r05's 2,673-2,903 (rsoc i=9, nonneg
# i=7), 4,411 (soc i=11), 9,416 (mixed i=9), 132,340 (nonneg i=10) or
# 194,568 (qp_lowrank i=5) iterations would take from 20 seconds to half
# an hour.  The whole r05 size runs through the tool
# itself (`python -m abip_tpu_torch.tools.fuzz_conic --batched --engine
# sprint2 --per-class 18`; PERF.md).
FUZZ_PER_CLASS = 18
FUZZ_LANE_CAP = 2000
FUZZ_R05 = os.path.join(ROOT, "benchmarks", "results",
                        "r05_conic_fuzz_ladder.jsonl")
# the host driver and PDHG routes of fuzz_conic on the classes with free
# and zero blocks, one instance a class (cut from 2 to hold the smoke's
# wall)
FUZZ_HOST_CLASSES = ("free_mixed", "mixed", "zero_mixed")
FUZZ_HOST_PER_CLASS = 1
FUZZ_SCIPY_PER_CLASS = 5
# K2 and K3 held to their plain versions on the first launches of these
# fuzz_conic batches (free and zero blocks; dim 21, m 7)
FUZZ_PARITY_CLASSES = ("zero_mixed", "mixed")
MPS_SUITES = ("mittelmann_mini", "mip17_mini")
EXAMPLES = os.path.join(ROOT, "abip_tpu_torch", "examples")
# the examples and the fuzz_scipy CLI run in processes of their own beside
# the rest of phase 11, this many at a time, each within BESIDE_LIMIT_S:
# their walls, three at a time on an H100, sum to 360-400 s (PERF.md),
# which the smoke's limit does not hold one after another
BESIDE_WORKERS = 3
BESIDE_LIMIT_S = 600


def phase_fuzz_parity(torch, dev):
    """K2 and K3 against their plain versions on the fuzz_conic batches of
    FUZZ_PARITY_CLASSES (18 lanes each, free and zero blocks, prepared as
    the tool's batched call prepares them).  K2 as the tool launches it
    (inner_crit_period=1, so trips of 1), over its first iteration, whose
    end takes the first stage decision, at the stated tolerance; then
    the whole of phase 1 (T=2048) in trips of PROBE, held with the noise
    floor (`ladder_parity`): there the plain f32 ladder sits 5e-4 to
    5e-3 from an f64 run, beyond the stated absolute term, and in trips
    of 1 it takes some stage decisions an iteration apart from K2.  K3:
    its first launch in the tool's run, one iteration from the state the
    tool's phase 1 hands over, at the stated tolerance.  Returns their
    largest |kernel - plain|."""
    k2, k3 = 0.0, 0.0
    for cls in FUZZ_PARITY_CLASSES:
        case = dict(fuzz=cls, count=FUZZ_PER_CLASS)
        label = f"fuzz_conic {cls} B={FUZZ_PER_CLASS}"
        k2 = max(k2, ladder_parity(torch, dev, label, case, T=1, probe=1))
        k2 = max(k2, ladder_parity(torch, dev, label, case, noise_floor=True))
        cones, stacks, _ = conic_batch(**case)
        P = conic_prepared(torch, cones, stacks, dev)
        st = conic_phase1_state(torch, P, cones, inner_crit_period=1)
        k3 = max(k3, delta_parity_at(torch, dev, label, P, cones, st, T=1,
                                     probe=1)[1])
    return k2, k3


def phase_fuzz_conic(torch, dev, card):
    """`tools.fuzz_conic` with --batched --engine sprint2 on the card,
    class by class (FUZZ_PER_CLASS lanes, up to FUZZ_LANE_CAP): every
    instance within 50*eps of its exact optimum, KKT and cone membership;
    each lane's status, verdict and ADMM count beside r05's (the JAX
    package on a CPU).  Returns {class: K2 launches}, {class: K3
    launches}."""
    from abip_tpu_torch.ops.conic_delta import conic_delta_cuda
    from abip_tpu_torch.ops.conic_dr import ladder_cuda
    from abip_tpu_torch.tools import fuzz_conic

    with open(FUZZ_R05) as f:
        r05 = {(r["class"], r["i"]): r for r in map(json.loads, f)
               if "class" in r}
    k2, k3, recs = {}, {}, []
    for cls in fuzz_conic.class_names():
        per = next((i for i in range(FUZZ_PER_CLASS)
                    if r05[cls, i]["admm"] > FUZZ_LANE_CAP), FUZZ_PER_CLASS)
        sec, out, (k2[cls], k3[cls]) = counted(
            lambda: fuzz_conic.run_class(cls, per, batched=True,
                                         engine="sprint2"),
            (ladder_cuda, conic_delta_cuda))
        recs += out
        admm = [r["admm"] for r in out]
        differ = [(r["i"], r["admm"], r05[cls, r["i"]]["admm"]) for r in out
                  if (r["status"], r["ok"], r["admm"]) != (
                      r05[cls, r["i"]]["status"], r05[cls, r["i"]]["ok"],
                      r05[cls, r["i"]]["admm"])]
        print(f"fuzz_conic sprint2 {cls} B={per} [{card}]: {sec:.3f} s, ok "
              f"{sum(r['ok'] for r in out)}/{per}, ADMM sum {sum(admm)} max "
              f"{max(admm)}, K2 launches {k2[cls]}, K3 launches {k3[cls]}, "
              f"lanes off r05 (i, ADMM, r05 ADMM): {differ or 'none'}")
        if fuzz_conic.class_engine(cls, "sprint2") == "sprint2" and \
                k2[cls] <= 0:
            raise AssertionError(f"fuzz_conic {cls}: sprint2 launched K2 "
                                 "no time")
    if sum(k3.values()) <= 0:
        raise AssertionError("fuzz_conic sprint2 launched K3 no time")
    bad = [r for r in recs if not r["ok"]]
    print("fuzz_conic --batched --engine sprint2: " + json.dumps(
        {"total": len(recs), "mismatches": len(bad),
         "per_class": FUZZ_PER_CLASS, "eps": 1e-6}))
    if bad:
        raise AssertionError(f"fuzz_conic sprint2 mismatches: {bad}")
    return k2, k3


def phase_fuzz_host(torch, dev):
    """`tools.fuzz_conic` through the host conic driver and through conic
    PDHG on FUZZ_HOST_CLASSES, FUZZ_HOST_PER_CLASS instances each, on the
    card: each route's summary must count no mismatch."""
    from abip_tpu_torch.tools import fuzz_conic

    for method in fuzz_conic.METHODS:
        recs = []
        for cls in FUZZ_HOST_CLASSES:
            recs += fuzz_conic.run_class(cls, FUZZ_HOST_PER_CLASS,
                                         method=method)
        for r in recs:
            print(f"fuzz_conic {method} {r['class']} i={r['i']}: "
                  f"{r['status']}, ADMM {r['admm']}, {r['time']} s, obj_err "
                  f"{r.get('obj_err', float('nan')):.3e}, kkt "
                  f"{r.get('kkt', float('nan')):.3e}")
        bad = [r for r in recs if not r["ok"]]
        print(f"fuzz_conic --method {method}: " + json.dumps(
            {"total": len(recs), "mismatches": len(bad),
             "per_class": FUZZ_HOST_PER_CLASS, "eps": 1e-6}))
        if bad:
            raise AssertionError(f"fuzz_conic {method} mismatches: {bad}")


def phase_mps_suites(torch, dev, dense=False):
    """Every file of mittelmann_mini and mip17_mini through `solve_mps`
    on the card (`mps_files_vs_highs`): dense=False holds K5 to its plain
    version on each A and A' that packs BCSR and counts its launches.
    Returns K5's launches."""
    import glob

    k5 = 0
    for suite in MPS_SUITES:
        paths = sorted(glob.glob(os.path.join(SUITES, suite, "*.mps*")))
        k5 += mps_files_vs_highs(torch, dev, paths, suite, dense)
    if not dense and k5 <= 0:
        raise AssertionError("no suite file launched K5")
    return k5


def beside_commands():
    """(label, argv) of phase 11's runs beside the main process, the
    longest first: the eight examples and `tools.fuzz_scipy` at
    FUZZ_SCIPY_PER_CLASS."""
    import glob

    paths = sorted(glob.glob(os.path.join(EXAMPLES, "*.py")))
    if len(paths) != 8:
        raise AssertionError(f"expected 8 examples, found {len(paths)}")
    longest = ("06_diff.py", "08_parametric_serving.py")
    examples = [(f"example {os.path.basename(p)}", [sys.executable, p])
                for p in sorted(paths, key=lambda p: os.path.basename(p)
                                not in longest)]
    return examples[:2] + [
        ("fuzz_scipy", [sys.executable, "-m",
                        "abip_tpu_torch.tools.fuzz_scipy", "--per-class",
                        str(FUZZ_SCIPY_PER_CLASS)])] + examples[2:]


@contextlib.contextmanager
def running_beside(commands):
    """Run each (label, argv) on the card in a process of its own beside
    this one, BESIDE_WORKERS at a time in the order given, each killed
    after BESIDE_LIMIT_S; yields [(label, future of (returncode, output,
    seconds))].  At exit every process still running is killed and those
    not started never start."""
    import tempfile
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    lock, stop, procs = threading.Lock(), threading.Event(), []

    def run(argv):
        with tempfile.TemporaryFile("w+") as out:
            with lock:
                if stop.is_set():
                    return None, "not started", 0.0
                t0 = time.perf_counter()
                proc = subprocess.Popen(argv, cwd=ROOT, stdout=out,
                                        stderr=subprocess.STDOUT, text=True)
                procs.append(proc)
            try:
                proc.wait(timeout=BESIDE_LIMIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            out.seek(0)
            return proc.returncode, out.read(), time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=BESIDE_WORKERS)
    try:
        yield [(label, pool.submit(run, argv)) for label, argv in commands]
    finally:
        with lock:
            stop.set()
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        pool.shutdown(wait=True, cancel_futures=True)


def phase_beside(runs, card):
    """Wait for each run of `running_beside`; print its last lines (and
    fuzz_scipy's verdicts per class) and raise unless every run exited 0
    and fuzz_scipy's summary counts every LP and no mismatch."""
    failed = []
    for label, future in runs:
        rc, text, sec = future.result()
        lines = [ln for ln in text.splitlines() if ln.strip()]
        print(f"{label} rc {rc} in {sec:.1f} s [{card}]: "
              f"{' | '.join(lines[-3:])}")
        if label == "fuzz_scipy":
            recs = [json.loads(ln) for ln in lines
                    if ln.startswith('{"class"')]
            for cls in dict.fromkeys(r["class"] for r in recs):
                rs = [r for r in recs if r["class"] == cls]
                print(f"fuzz_scipy {cls}: ok {sum(r['ok'] for r in rs)}/"
                      f"{len(rs)}, status {sorted({r['status'] for r in rs})}"
                      f", ADMM {[r['admm'] for r in rs]}")
            summary = json.loads(lines[-1]) if lines and \
                lines[-1].startswith("{") else {}
            if summary.get("mismatches") != 0 or summary.get("total") != \
                    len(recs) or len(recs) != 6 * FUZZ_SCIPY_PER_CLASS:
                failed.append(label)
        if rc != 0:
            print(text[-3000:], file=sys.stderr)
            failed.append(label)
    if failed:
        raise AssertionError(f"runs beside failed: {sorted(set(failed))}")


HOST_LP = dict(m=1000, n_rand=9000, density=0.1)
HOST_SEEDS = (11, 12, 13)
HOST_CG = dict(m=200, n_rand=1800, density=0.1)
HOST_EPS = 1e-6
PROFILE_ADMM = 600
# K5 against its plain version and scipy: f64 within 1e-12 of |A| |x| per
# row (both sum the same products in other orders); f32 within 1e-5 of it.
SPMV_TOL = {"f64": 1e-12, "f32": 1e-5}
# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and the peaks outside the
# tensor cores (the kernels here use none)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def bound_ms(nbytes, flops, kind):
    """(least milliseconds the card needs, what bounds it): bytes over the
    memory rate against operations over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def kernel_bound(inputs, outputs, t_done, flops_per_iteration):
    """`bound_ms` of an f32 chunk kernel: every input tensor read once and
    every output written once, against the iterations this launch ran
    (the sum of `t_done` over lanes) times its operations per iteration."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs)
                 + list(outputs) if hasattr(t, "element_size"))
    iters = float(t_done.double().sum())
    return bound_ms(nbytes, iters * flops_per_iteration, "f32")


def host_lp(seed, **shape):
    """(A, b, c) of `bench.reference_smoke_lp` with A as CSR."""
    import scipy.sparse as sp

    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(seed=seed, **(shape or HOST_LP))
    return sp.csr_matrix(A), b, c


def spmv_cases():
    """(label, scipy CSR matrix) of K5's parity cases: A and A' of the
    host-LP smoke instance, ragged shapes (m not a multiple of 8, n not a
    multiple of 128, empty block rows, rows with fewer tiles than the
    widest), and rows whose lengths differ widely (empty rows, 1-entry
    rows, one dense row)."""
    import scipy.sparse as sp

    A = host_lp(HOST_SEEDS[0])[0]
    R = sp.random(37, 300, density=0.2, random_state=np.random.RandomState(5),
                  format="lil")
    R[8:24, :] = 0.0                        # block rows 1 and 2 empty
    R[30:, 128:] = 0.0                      # last block row: fewer tiles
    W = sp.random(3, 1000, density=0.5, random_state=np.random.RandomState(6))
    return (("smoke A 1000x10000", A), ("smoke A' 10000x1000", A.T.tocsr()),
            ("ragged 37x300", sp.csr_matrix(R)),
            ("ragged A' 300x37", sp.csr_matrix(R).T.tocsr()),
            ("one block row 3x1000", sp.csr_matrix(W)),
            ("skewed rows 300x5000", skewed_rows()))


def skewed_rows(m=300, n=5000, seed=7):
    """Row i stores about n (i / m)^3 entries: empty and 1-entry rows at
    the top, a dense row at the bottom."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    lens = np.minimum(n, (n * (np.arange(m) / (m - 1)) ** 3).astype(int))
    lens[5:10] = 1
    lens[-1] = n
    cols = [np.sort(rng.choice(n, k, replace=False)) for k in lens]
    indptr = np.concatenate([[0], np.cumsum(lens)])
    return sp.csr_matrix((rng.standard_normal(int(lens.sum())),
                          np.concatenate(cols), indptr), shape=(m, n))


def spmv_parity(torch, dev, label, A, kind):
    """K5 on one matrix against its plain version (over the stored
    entries), the tile product the reference computes and scipy's f64
    product, with NaN past the end of x (never read); raises beyond
    SPMV_TOL.  Returns the largest |kernel - plain|."""
    from abip_tpu_torch.ops.spmv import (BCSRMatrix, _bcsr_ref, _csr_ref,
                                         bcsr_matvec_cuda)

    dt = {"f64": torch.float64, "f32": torch.float32}[kind]
    m, n = A.shape
    x64 = np.random.default_rng(9).standard_normal(n)
    scale = abs(A) @ np.abs(x64)                 # |A| |x| per row
    ref = A @ x64
    B = BCSRMatrix.from_scipy(A, dtype=dt, device=dev)
    buf = torch.full((n + 64,), float("nan"), dtype=dt, device=dev)
    buf[:n] = torch.as_tensor(x64, dtype=dt, device=dev)
    ker = bcsr_matvec_cuda(B, buf[:n])
    plain = _csr_ref(B, buf[:n])
    tiles = _bcsr_ref(B, buf[:n])
    torch.cuda.synchronize()
    k, p, t = (v.double().cpu().numpy() for v in (ker, plain, tiles))
    if not np.isfinite(k).all():
        raise AssertionError(f"K5 {label} {kind}: non-finite output")
    tol = SPMV_TOL[kind] * scale + 1e-300
    err = np.abs(k - p)
    if ((err > tol).any() or (np.abs(k - t) > tol).any()
            or (kind == "f64" and (np.abs(k - ref) > tol).any())):
        raise AssertionError(
            f"K5 {label} {kind}: |kernel-plain| {err.max():.3e}, "
            f"|kernel-tiles| {np.abs(k - t).max():.3e}, |kernel-scipy| "
            f"{np.abs(k - ref).max():.3e} beyond {SPMV_TOL[kind]} |A||x|")
    print(f"parity K5 {label} {kind} (nnz {B.nnz}, G={B.group}): "
          f"max|kernel-plain| {err.max():.3e}, max|kernel-tiles| "
          f"{np.abs(k - t).max():.3e}, max|kernel-scipy f64| "
          f"{np.abs(k - ref).max():.3e} (limit {SPMV_TOL[kind]} |A||x|, "
          f"largest {scale.max():.3e}: ok)")
    return float(err.max())


def phase_spmv_parity(torch, dev):
    """K5 on every case of `spmv_cases`, f64 and f32.  Returns the largest
    f64 |kernel - plain| (the driver's working type)."""
    worst = 0.0
    for label, A in spmv_cases():
        worst = max(worst, spmv_parity(torch, dev, label, A, "f64"))
        spmv_parity(torch, dev, label, A, "f32")
    return worst


def lp_certificate(A, b, c, sol):
    """res_pri, res_dual, rel_gap of the returned (x, y, s), in f64."""
    x, y, s = sol.x, sol.y, sol.s
    pri = np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b))
    dual = np.linalg.norm(A.T @ y + s - c) / (1 + np.linalg.norm(c))
    cx, by = c @ x, b @ y
    return pri, dual, abs(cx - by) / (1 + abs(cx) + abs(by))


_HIGHS_RUNS = {}    # highs_key -> objective: one HiGHS run an LP


def highs_key(A, b, c):
    """The key of an LP in `_HIGHS_RUNS`: its shape, b and c (a seeded
    instance is fixed by them)."""
    import hashlib

    return (A.shape, hashlib.sha256(np.ascontiguousarray(b).tobytes()
                                    + np.ascontiguousarray(c).tobytes())
            .hexdigest())


def highs(A, b, c):
    """(optimal objective, seconds) of scipy's HiGHS interior point (with
    crossover) on the LP; an LP this run already gave HiGHS is not
    solved again."""
    import time

    from scipy.optimize import linprog

    key = highs_key(A, b, c)
    t0 = time.perf_counter()
    if key not in _HIGHS_RUNS:
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                      method="highs-ipm")
        if ref.status != 0:
            raise AssertionError(f"scipy HiGHS failed: {ref.message}")
        _HIGHS_RUNS[key] = ref.fun
    return _HIGHS_RUNS[key], time.perf_counter() - t0


def host_lp_highs(seed):
    """`highs` on the host LP of `seed` (for a worker process)."""
    return highs(*host_lp(seed))


def solve_host(torch, A, b, c, **kw):
    """One `solve_lp` on the card, as a user calls it (default device),
    with K5 counted from 0; returns (seconds, solution, workspace, K5
    launches)."""
    from abip_tpu_torch import LPWorkspace, Settings
    from abip_tpu_torch.ops.spmv import bcsr_matvec_cuda
    from abip_tpu_torch.utils.timing import wall_s

    def run():
        ws = LPWorkspace(A, b, c, Settings(eps=HOST_EPS, **kw))
        return ws, ws.solve()

    bcsr_matvec_cuda.launches = 0
    sec, (ws, sol) = wall_s(run)
    return sec, sol, ws, bcsr_matvec_cuda.launches


def phase_host_lp(torch, dev):
    """The host LP driver at full width: `solve_lp`'s workspace on a CSR A
    of the smoke shape, three fresh seeds, each against scipy's HiGHS
    (18-25 s a run on the card's host, so each seed's runs in a worker
    process of its own while the card solves).  Returns the first
    solve's K5 launches."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    first = None
    with ProcessPoolExecutor(len(HOST_SEEDS), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        refs = {seed: pool.submit(host_lp_highs, seed) for seed in HOST_SEEDS}
        for seed in HOST_SEEDS:
            A, b, c = host_lp(seed)
            sec, sol, ws, launches = solve_host(torch, A, b, c)
            layout = ws.A_op.layout
            print(f"host LP seed {seed} m=1000 n=10000 nnz={A.nnz}: "
                  f"{sol.status_name}, IPM {sol.ipm_iters}, ADMM "
                  f"{sol.admm_iters}, wall {sec:.3f} s (setup "
                  f"{sol.setup_time:.3f} s, solve {sol.solve_time:.3f} s), "
                  f"{sol.admm_iters / sol.solve_time:.1f} ADMM it/s, layout "
                  f"{layout}, linsys {ws.linsys_kind}, K5 launches "
                  f"{launches} ({launches / max(1, sol.admm_iters):.2f} per "
                  "ADMM iteration)")
            if layout != "bcsr" or ws.linsys_kind != "dense":
                raise AssertionError(f"host LP: layout {layout}, linsys "
                                     f"{ws.linsys_kind}; expected bcsr, "
                                     "dense")
            if sol.status_name != "Solved" or launches <= 0:
                raise AssertionError(f"host LP seed {seed}: "
                                     f"{sol.status_name}, K5 launched "
                                     f"{launches}x")
            if not (np.isfinite(sol.x).all() and np.isfinite(sol.pobj)):
                raise AssertionError(f"host LP seed {seed}: non-finite "
                                     "solution")
            fun, hs = refs[seed].result()
            _HIGHS_RUNS[highs_key(A, b, c)] = fun
            rel = abs(sol.pobj - fun) / max(1.0, abs(fun))
            print(f"host LP seed {seed} vs scipy HiGHS ({hs:.1f} s in a "
                  f"worker process): pobj {sol.pobj:.10g} vs {fun:.10g}, "
                  f"relative gap {rel:.3e} (limit 1e-5)")
            if rel > 1e-5:
                raise AssertionError(f"host LP seed {seed}: objective off")
            if first is None:
                first = launches
    return first


def phase_host_cg(torch, dev):
    """The same driver with linsys="cg" on the m=200 smoke: PCG's products
    launch K5 too."""
    A, b, c = host_lp(22, **HOST_CG)
    sec, sol, ws, launches = solve_host(torch, A, b, c, linsys="cg")
    fun, hs = highs(A, b, c)
    rel = abs(sol.pobj - fun) / max(1.0, abs(fun))
    print(f"host LP cg m=200 n=2000: {sol.status_name}, IPM "
          f"{sol.ipm_iters}, ADMM {sol.admm_iters}, avg_cg_iters "
          f"{sol.avg_cg_iters:.2f}, wall {sec:.3f} s, layout "
          f"{ws.A_op.layout}, K5 launches {launches}; vs HiGHS relative gap "
          f"{rel:.3e} (limit 1e-5)")
    if sol.status_name != "Solved" or rel > 1e-5 or launches <= 0:
        raise AssertionError(f"host LP cg: {sol.status_name}, rel {rel:.3e}, "
                             f"K5 {launches}x")


# bytes written between two launches for a cold time: beyond the 50 MB L2
FLUSH_BYTES = 64 << 20
# K5 group sizes timed on A and A' (the packing picks one per matrix)
K5_GROUPS = (16, 32, 64, 128, 256)


def phase_spmv_timing(torch, dev, card):
    """K5 per launch on A and A' of the smoke instance, cold (FLUSH_BYTES
    written between launches) and warm (back to back, as the solver's
    alternating A and A' can find them in L2), against its plain version
    and cuSPARSE (`torch.mv` on a CSR tensor, the yardstick) with int64
    and with int32 indices; each group size of K5_GROUPS warm; the bound
    counts the bytes of the stored entries (vals, colidx, rowptr) and of x
    and y.  Returns (cold ms, plain ms, cuSPARSE int32 cold ms, bound ms,
    bound_by) of A."""
    import dataclasses

    from abip_tpu_torch.ops.spmv import BCSRMatrix, _csr_ref, bcsr_matvec_cuda
    from abip_tpu_torch.utils.timing import queued_ms

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_warm(fn):
        return (queued_ms(fn, between=flush.zero_), queued_ms(fn))

    out = None
    A = host_lp(HOST_SEEDS[0])[0]
    for label, M in (("A", A), ("A'", A.T.tocsr())):
        m, n = M.shape
        Bm = BCSRMatrix.from_scipy(M, dtype=torch.float64, device=dev)
        x = torch.randn(n, dtype=torch.float64, device=dev)
        lib = {}
        for it in (torch.int64, torch.int32):
            csr = torch.sparse_csr_tensor(
                Bm.rowptr.to(it), Bm.colidx.to(it), Bm.vals, size=(m, n))
            lib[it] = cold_warm(lambda: torch.mv(csr, x))
        ms = cold_warm(lambda: bcsr_matvec_cuda(Bm, x))
        plain = queued_ms(lambda: _csr_ref(Bm, x))
        groups = {g: queued_ms(lambda: bcsr_matvec_cuda(
            dataclasses.replace(Bm, group=g), x)) for g in K5_GROUPS}
        nbytes = sum(t.numel() * t.element_size()
                     for t in (Bm.vals, Bm.colidx, Bm.rowptr, x)) + 8 * m
        bms, by = bound_ms(nbytes, 2.0 * Bm.nnz, "f64")
        warm_note = ("under the HBM bound: the operands stayed in L2"
                     if ms[1] < bms else
                     f"{100 * bms / ms[1]:.0f}% of the bound")
        print(f"timing K5 {label} f64 nnz {Bm.nnz} G={Bm.group} "
              f"({nbytes / 1e6:.2f} MB stored entries, x, y) [{card}]: kernel "
              f"cold {ms[0] * 1e3:.2f} us ({100 * bms / ms[0]:.0f}% of the "
              f"bound), warm {ms[1] * 1e3:.2f} us ({warm_note}); cuSPARSE CSR "
              f"int64 cold {lib[torch.int64][0] * 1e3:.2f} warm "
              f"{lib[torch.int64][1] * 1e3:.2f} us, int32 cold "
              f"{lib[torch.int32][0] * 1e3:.2f} warm "
              f"{lib[torch.int32][1] * 1e3:.2f} us; plain {plain * 1e3:.1f} "
              f"us; bound {bms * 1e3:.2f} us ({by}); warm by group size "
              + ", ".join(f"G={g} {t * 1e3:.2f}" for g, t in groups.items())
              + " us")
        if out is None:
            out = (ms[0], plain, lib[torch.int32][0], bms, by)
    return out


def phase_host_profile(torch, dev):
    """One host LP solve, its workspace set up beforehand, cut at
    PROFILE_ADMM iterations (the profiler's own processing grows with the
    ~45 events of every iteration)."""
    from abip_tpu_torch import LPWorkspace, Settings

    A, b, c = host_lp(HOST_SEEDS[1])
    ws = LPWorkspace(A, b, c, Settings(eps=HOST_EPS,
                                       max_admm_iters=PROFILE_ADMM))
    profile_solve(torch, ws.solve,
                  {"K5": ("csr_spmv_kernel",),
                   "cholesky_solve (trsm/trsv)": ("trsm", "trsv")},
                  "one host LP solve")


def kernel_name(mangled):
    """`name<args>` of a kernel from its mangled name: the length-prefixed
    identifier ending in "kernel" and its integer and bool template
    arguments (a kernel's form: 0 resident, 1 streaming, 2 spilled)."""
    import re

    for m in re.finditer("kernel", mangled):
        end = m.end()
        for start in range(end - 6, 0, -1):
            size = str(end - start)
            if mangled[start - len(size):start] == size:
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
                targs = re.findall(r"L[ib](\d+)E", args.group(1)) if args \
                    else []
                return mangled[start:end] + (f"<{', '.join(targs)}>"
                                             if targs else "")
    return mangled


def ptxas_summary(log):
    """Each kernel's registers and spills from `nvcc -Xptxas -v`'s log:
    'name<form>: R registers, S B spill stores, L B spill loads'."""
    import re

    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = kernel_name(m.group(1)), "no spill line"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


AB_SNIPPET = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from abip_tpu_torch.cones import cone_operands
from abip_tpu_torch.ops.conic_dr import dr_sprint_cuda, ladder_cuda
from abip_tpu_torch.utils.timing import cuda_ms
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
cones, stacks, _ = cs.conic_batch(8600)
P = cs.conic_prepared(torch, cones, stacks, dev)
co = cone_operands(cones, dev)
op2 = cs.cold_ladder_operands(torch, P, cones)
t2 = torch.full((cs.B,), 2048, dtype=torch.int32, device=dev)
u = cs.conic_cold_state(torch, P, cones)
op4 = cs.conic_sprint_operands(torch, P, u, u, 1.0, 0.0, 0.0)
t4 = torch.full((cs.B,), 512, dtype=torch.int32, device=dev)
k2 = [cuda_ms(lambda: ladder_cuda(op2, co, t2, probe=cs.PROBE, psi=1.0,
                                  woodbury=True), iters=5) for _ in range(3)]
k4 = [cuda_ms(lambda: dr_sprint_cuda(op4, co, t4, probe=cs.PROBE,
                                     woodbury=True), iters=3)
      for _ in range(3)]
print("AB " + json.dumps({"K2": k2, "K4": k4}))
"""


def ab_parent(parent):
    """K2 (one phase-1 launch) and K4 (one T=512 chunk) at dim-1020 B=16,
    three times five (three) launches each, in this checkout and in
    `parent`, each in a process of its own: this, parent, this."""
    card = card_line()
    for tree in (ROOT, os.path.abspath(parent), ROOT):
        proc = subprocess.run([sys.executable, "-c", AB_SNIPPET], cwd=tree,
                              capture_output=True, text=True, check=False)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode or not line:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"A/B run in {tree} failed")
        times = json.loads(line[0][3:])
        which = "parent" if tree != ROOT else "change"
        print(f"A/B {which} ({tree}) [{card}]: K2 ms "
              f"{[round(t, 3) for t in times['K2']]}, K4 ms "
              f"{[round(t, 3) for t in times['K4']]}")
    return 0


def main():
    import time

    # cuBLAS picks its kernels per workspace; a fixed configuration keeps
    # the thread pool's concurrent streams on the same ones (phase 9)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--ab"]:
        return ab_parent(sys.argv[2])
    from abip_tpu_torch.ops.build import load_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    t0 = time.perf_counter()
    built = load_all(SOURCES)
    print(f"build: {len(SOURCES)} sources side by side in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, lib in built.items():
        print(f"build {name}.cu: {lib.build_seconds:.1f} s [{card}] "
              f"{' | '.join(ptxas_summary(lib.log))}")

    k5_err = phase("K5 parity", phase_spmv_parity, torch, dev)
    k5_launches = phase("host LP main path", phase_host_lp, torch, dev)
    phase("host LP cg", phase_host_cg, torch, dev)
    k5 = phase("K5 timing", phase_spmv_timing, torch, dev, card)
    phase("host LP profile", phase_host_profile, torch, dev)

    k1_err = phase("K1 parity", phase_kernel_parity, torch, dev)
    k1_launches = phase("LP batch main path", phase_main_path, torch, dev)
    k1 = phase("LP batch timing", phase_timing, torch, dev, card)
    phase("LP batch profile", phase_profile, torch, dev)

    k2_err = phase("K2 parity", lambda: max(
        ladder_parity(torch, dev, *c) for c in CONIC_CASES))
    k3_err = phase("K3 parity", lambda: max(
        delta_parity(torch, dev, *c) for c in CONIC_CASES))
    k2_launches, k3_launches = phase("conic main path", phase_conic_main,
                                     torch, dev)
    k2, k3 = phase("conic timing", phase_conic_timing, torch, dev, card)
    phase("conic profile", phase_conic_profile, torch, dev)

    k6_err, k7_err = phase("K6/K7 parity", phase_lp_sprint_parity, torch, dev)
    k6_launches, _, k7_launches = phase(
        "LP sprint main paths", phase_lp_sprint_main, torch, dev)
    k6, k7 = phase("LP sprint timing", phase_lp_sprint_timing, torch, dev,
                   card)
    phase("LP sprint profile", phase_lp_sprint_profile, torch, dev)
    k4_err = phase("K4 parity", lambda: max(
        conic_sprint_parity(torch, dev, *c) for c in CONIC_CASES))
    k4_launches, _ = phase("conic phase1=sprint main path",
                           phase_conic_sprint_main, torch, dev, card)
    phase("conic phase1=sprint profile", phase_conic_sprint_profile, torch,
          dev)
    k8_err, k8_launches = phase("K8 parity", phase_barrier_step, torch, dev)
    k4, k8 = phase("K4/K8 timing", phase_sprint_kernel_timing, torch, dev,
                   card)
    phase("spilled forms", phase_spilled, torch, dev)
    phase("shape repair", phase_repair, torch, dev)

    t7 = time.perf_counter()
    phase("front door conic", phase_front_conic, torch, dev)
    phase("front door CG", phase_front_cg, torch, dev)
    phase("front door workspace", phase_front_workspace, torch, dev)
    mps_solves = {}
    k5_mps = phase("front door files", phase_front_files, torch, dev,
                   mps_solves)
    phase("front door profile", phase_front_profile, torch, dev)
    print(f"phase 7 (front door): {time.perf_counter() - t7:.1f} s")

    t8 = time.perf_counter()
    rest = phase("compaction", phase_compaction, torch, dev, card)
    k3_round_err = phase("K3 at a compaction round", phase_round_parity,
                         torch, dev)
    rest["K2"]["sprint2 endgame=steps B=16"] = phase(
        "steps engine", phase_steps, torch, dev, card)
    phase("solve_qcp_device and host_polish", phase_device_polish, torch, dev,
          card)
    phase("heterogeneous batches", phase_het, torch, dev, card)
    phase("LASSO and SVM", phase_ml, torch, dev, card)
    print(f"phase 8 (the batched conic rest): {time.perf_counter() - t8:.1f} s")

    t9 = time.perf_counter()
    phase("PageRank families", phase_pagerank, torch, dev, card)
    phase("stream against fixed batches", phase_stream, torch, dev, card)
    k1_pool = phase("thread pool", phase_pool, torch, dev, card)
    pdhg_batch = phase("PDHG", phase_pdhg, torch, dev, card)
    phase("crossover", phase_crossover, torch, dev, card, mps_solves)
    phase("differentiation", phase_grad, torch, dev, card)
    print(f"phase 9 (the rest of the single-card port): "
          f"{time.perf_counter() - t9:.1f} s")

    t10 = time.perf_counter()
    k1_mesh = phase("multi-card layer", phase_multi_card, torch, dev, card,
                    pdhg_batch)
    print(f"phase 10 (the multi-card layer): "
          f"{time.perf_counter() - t10:.1f} s")

    t11 = time.perf_counter()
    with running_beside(beside_commands()) as beside:
        k2_fuzz_err, k3_fuzz_err = phase(
            "K2/K3 parity on fuzz_conic batches", phase_fuzz_parity, torch,
            dev)
        k2_fuzz, k3_fuzz = phase("fuzz_conic sprint2", phase_fuzz_conic,
                                 torch, dev, card)
        phase("fuzz_conic host and PDHG", phase_fuzz_host, torch, dev)
        k5_suites = phase("mittelmann_mini and mip17_mini sparse",
                          phase_mps_suites, torch, dev)
        phase("mittelmann_mini and mip17_mini dense", phase_mps_suites,
              torch, dev, True)
        phase("examples and fuzz_scipy (beside)", phase_beside, beside,
              card)
    print(f"phase 11 (validators and examples): "
          f"{time.perf_counter() - t11:.1f} s")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, err, times, library=None,
              **more):
        ms, plain, bms, by = times
        return {"name": name, "route": "cuda",
                "source": f"abip_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "library_ms": library,
                **more}

    print(json.dumps({"kernels": [
        entry("delta_cluster_kernel", "admm_delta.cu",
              "abip_tpu/ops/admm_delta.py:287", k1_launches, k1_err, k1,
              pool_launches=k1_pool, mesh_launches=k1_mesh),
        entry("conic_ladder_cluster_kernel", "conic_ladder.cu",
              "abip_tpu/ops/conic_pallas.py:703", k2_launches, k2_err, k2,
              batched_rest_launches=rest["K2"], fuzz_launches=k2_fuzz,
              fuzz_max_abs_err=k2_fuzz_err),
        entry("conic_delta_cluster_kernel", "conic_delta.cu",
              "abip_tpu/ops/conic_delta.py:718", k3_launches, k3_err, k3,
              batched_rest_launches=rest["K3"],
              compaction_round_max_abs_err=k3_round_err,
              fuzz_launches=k3_fuzz, fuzz_max_abs_err=k3_fuzz_err),
        entry("conic_sprint_cluster_kernel", "conic_sprint.cu",
              "abip_tpu/ops/conic_pallas.py:379", k4_launches, k4_err, k4,
              batched_rest_launches=rest["K4"]),
        entry("csr_spmv_kernel", "bcsr_spmv.cu",
              "abip_tpu/ops/spmv_pallas.py:108", k5_launches, k5_err,
              (k5[0], k5[1], k5[3], k5[4]), library=k5[2],
              mps_route_launches=k5_mps, suite_launches=k5_suites),
        entry("sprint_cluster_kernel<stop>", "admm_sprint.cu",
              "abip_tpu/ops/admm_pallas.py:327", k6_launches, k6_err, k6),
        entry("sprint_cluster_kernel<plain>", "admm_sprint.cu",
              "abip_tpu/ops/admm_pallas.py:113", k7_launches, k7_err, k7),
        entry("barrier_step_kernel", "barrier_step.cu",
              "abip_tpu/ops/prox_pallas.py:42", k8_launches, k8_err, k8)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
