#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`abip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  It imports no JAX.  Phases, each printing its own lines:

1. build the three kernels from the checkout, one `nvcc` each, side by
   side: K1 `csrc/admm_delta.cu` (LP delta chunk), K2
   `csrc/conic_ladder.cu` (conic phase 1), K3 `csrc/conic_delta.cu`
   (conic delta chunk);
2. LP: hold K1 against its plain PyTorch version on mid-solve anchors
   (B=16 at the smoke shape m=50, n=2000 and a ragged m=37, n=411;
   T=64, thresh=0; then thresholds that stop lanes mid-chunk); solve a
   fresh B=16 smoke batch through `solve_lp_batch` (eps=1e-6, chunk
   T=1536) against scipy's HiGHS; time it; profile it;
3. conic: hold K2 against its plain version on phase 1 from the cold
   start (dim-1020 B=16 and a small primal-form batch with a diagonal
   Q), and K3 on mid-solve anchors (T=64, thresh=0; then thresholds that
   stop lanes mid-chunk); solve a fresh B=16 dim-1020 batch through
   `solve_qcp_batch(engine="sprint2")` with the options of
   `tools/conic_bench.py` against the instances' known optima; time
   it, one K2 launch and one K3 chunk against their plain versions, and
   the f64 pieces; profile one solve.

Exits nonzero, printing no result, without a card or on any failure.
The last three lines are the kernel summary (JSON), the card's name and
power limit, and the result (JSON).
"""
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


def mid_solve_state(torch, stacks, dev, steps=200):
    """The port's f64 setup of a batch and a state advanced by absolute
    f64 ADMM steps through three barrier stages."""
    from abip_tpu_torch import hsd
    from abip_tpu_torch.ops.admm_delta import _mv, _rmv
    from abip_tpu_torch.parallel.batched import setup_delta

    As, bs, cs = (torch.as_tensor(x, dtype=torch.float64, device=dev)
                  for x in stacks)
    S = setup_delta(As, bs, cs)
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


def phase_kernel_parity(torch, dev):
    from abip_tpu_torch.ops.admm_delta import _delta_compute, delta_chunk_cuda

    worst = 0.0
    cases = (("smoke B=16 m=50 n=2000", SMOKE, B),
             ("ragged B=5 m=37 n=411", dict(m=37, n_rand=374), 5))
    for label, shape, nb in cases:
        _, stacks = smoke_batch(500, nb, **shape)
        S, u, v = mid_solve_state(torch, stacks, dev)
        anc = make_anchor(torch, S, u, v, 0.0)
        t_max = torch.full((nb,), 64, dtype=torch.int32, device=dev)
        ker = delta_chunk_cuda(anc, t_max, PROBE)
        plain = _delta_compute(anc, t_max, PROBE)
        torch.cuda.synchronize()
        if not torch.equal(ker[6][:, 5], plain[6][:, 5]):
            raise AssertionError(f"{label}: t_done differs")
        err, strict = compare(ker, plain, label)
        exact = _delta_compute(
            type(anc)(*[x.double() for x in anc]), t_max, PROBE)
        kerr = max(float((k.double() - e).abs().max())
                   for k, e in zip(ker, exact))
        perr = max(float((p.double() - e).abs().max())
                   for p, e in zip(plain, exact))
        if kerr > ACC_RATIO * perr:
            raise AssertionError(
                f"{label}: kernel is {kerr:.3e} from the f64 run, more than "
                f"{ACC_RATIO}x the plain version's {perr:.3e}")
        worst = max(worst, err)
        print(f"parity {label} T=64: max|kernel-plain|={err:.3e} "
              f"(rtol {RTOL} + {REL_SCALE}*scale: ok; rtol {STRICT_RTOL} "
              f"atol {STRICT_ATOL}: {'ok' if strict else 'exceeded'}); "
              f"vs f64 run: kernel {kerr:.3e}, plain {perr:.3e} (kernel at "
              f"most {ACC_RATIO}x: ok); t_done equal")
        if label.startswith("smoke"):
            smoke = (S, u, v, plain)
    # thresholds just above each lane's qres after 64 iterations stop the
    # lanes mid-chunk
    S, u, v, plain64 = smoke
    anc = make_anchor(torch, S, u, v, 1.05 * plain64[6][:, 4].double())
    t_max = torch.full((B,), 256, dtype=torch.int32, device=dev)
    tk = delta_chunk_cuda(anc, t_max, PROBE)[6][:, 5].cpu().numpy()
    tp = _delta_compute(anc, t_max, PROBE)[6][:, 5].cpu().numpy()
    tk, tp = tk.astype(int).tolist(), tp.astype(int).tolist()
    if min(tp) >= 256:
        raise AssertionError("stop case: no lane stopped mid-chunk")
    if max(abs(a - b) for a, b in zip(tk, tp)) > PROBE:
        raise AssertionError(f"stop case: t_done {tk} vs plain {tp}")
    print(f"parity stop-mid-chunk B=16 T=256: t_done kernel {tk} plain {tp} "
          f"(within one probe)")
    return worst


def solve(torch, stacks, dev):
    from abip_tpu_torch.parallel.batched import solve_lp_batch

    return solve_lp_batch(*stacks, device=dev, **SOLVE_KW)


def phase_main_path(torch, dev):
    from scipy.optimize import linprog

    from abip_tpu_torch.ops.admm_delta import delta_chunk_cuda
    from abip_tpu_torch.utils.timing import wall_s

    data, stacks = smoke_batch(1000)
    delta_chunk_cuda.launches = 0
    sec, res = wall_s(lambda: solve(torch, stacks, dev))
    launches = delta_chunk_cuda.launches
    status = res.status.cpu().numpy()
    iters = res.admm_iters.cpu().numpy()
    pobj = res.pobj.cpu().numpy()
    solved = int((status == 1).sum())
    print(f"main path B=16 smoke eps=1e-6 T=1536: solved {solved}/{B}, "
          f"ADMM iterations total {int(iters.sum())} mean {iters.mean():.1f}"
          f", IPM mean {res.ipm_iters.double().mean().item():.1f}, wall "
          f"{sec:.3f} s (first solve, includes warm-up), "
          f"{iters.sum() / sec:.1f} ADMM it/s, K1 launches {launches}")
    if solved != B:
        raise AssertionError(f"main path: statuses {status.tolist()}")
    if not (np.isfinite(res.x.cpu().numpy()).all() and np.isfinite(pobj).all()):
        raise AssertionError("main path: non-finite solution")
    worst = 0.0
    for i, (A, b, c) in enumerate(data):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        if ref.status != 0:
            raise AssertionError(f"scipy failed on lane {i}: {ref.message}")
        rel = abs(pobj[i] - ref.fun) / max(1.0, abs(ref.fun))
        worst = max(worst, rel)
        if rel > 1e-5:
            raise AssertionError(f"lane {i}: pobj {pobj[i]} vs HiGHS "
                                 f"{ref.fun} (rel {rel:.2e})")
    print(f"main path vs scipy HiGHS: max relative objective gap "
          f"{worst:.3e} (limit 1e-5)")
    if launches <= 0:
        raise AssertionError("main path did not launch the kernel")
    return launches


def phase_timing(torch, dev, card):
    from abip_tpu_torch.ops.admm_delta import _delta_compute, delta_chunk_cuda
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
    ms = cuda_ms(lambda: delta_chunk_cuda(anc, t_max, PROBE), iters=5)
    plain_ms = cuda_ms(lambda: _delta_compute(anc, t_max, PROBE), iters=3)
    print(f"timing K1 chunk T=1536 B=16 m=50 n=2000 [{card}]: kernel "
          f"{ms:.3f} ms ({ms * 1e3 / 1536:.2f} us/iteration), plain "
          f"version {plain_ms:.3f} ms")
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
    return ms, plain_ms


def profile_solve(torch, run, kernels, label):
    """Device time of one solve by kernel, from the profiler; `kernels`
    maps a label to a substring of a kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    from abip_tpu_torch.utils.timing import wall_s

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sec, _ = wall_s(run)

    def dev_us(e):
        for key in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, key):
                return float(getattr(e, key))
        return 0.0

    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()]
    total = sum(us for _, us, _ in events)
    if total <= 0.0:
        print(f"profile {label}: the profiler recorded no device time (not "
              "measured)")
        return
    shares = []
    for name, sub in kernels.items():
        us = sum(t for k, t, _ in events if sub in k)
        shares.append(f"{name} {us / 1e3:.1f} ms = {100 * us / total:.1f}%")
    print(f"profile {label} (wall {sec:.3f} s under the profiler): device "
          f"busy {total / 1e3:.1f} ms = {100 * total / 1e6 / sec:.1f}% of the "
          f"wall; {', '.join(shares)} of device time")
    for key, us, count in sorted(events, key=lambda e: -e[1])[:6]:
        print(f"profile   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def phase_profile(torch, dev):
    _, stacks = smoke_batch(6000)
    profile_solve(torch, lambda: solve(torch, stacks, dev),
                  {"K1": "delta_chunk_kernel"}, "one LP solve")


# ---------------------------------------------------------------------------
# the conic path
# ---------------------------------------------------------------------------

def _complementary_pair(cones, rng):
    """Boundary x*, s* in K, K* with x*'s* = 0, block order [soc...,
    rsoc..., free, zero, nonneg]: a copy of
    `benchmarks/conic_mini._complementary_pair` (that module imports the
    JAX package), bit-identical for the same generator."""
    xs, ss = [], []
    for d in cones.soc:
        v = rng.standard_normal(d - 1) if d > 1 else np.zeros(0)
        nv = float(np.linalg.norm(v)) if d > 1 else rng.random() + 0.5
        xs.append(np.concatenate([[nv], v]))
        ss.append((rng.random() + 0.5) * np.concatenate([[nv], -v]))
    for d in cones.rsoc:
        z = rng.standard_normal(d - 2)
        p = rng.random() + 0.5
        q = float(z @ z) / (2.0 * p)
        xs.append(np.concatenate([[p, q], z]))
        ss.append((rng.random() + 0.5) * np.concatenate([[q, p], -z]))
    if cones.free:
        xs.append(rng.standard_normal(cones.free))
        ss.append(np.zeros(cones.free))
    if cones.zero:
        xs.append(np.zeros(cones.zero))
        ss.append(rng.standard_normal(cones.zero))
    if cones.nonneg:
        mask = rng.random(cones.nonneg) < 0.5
        pos = rng.random(cones.nonneg) + 0.5
        xs.append(np.where(mask, pos, 0.0))
        ss.append(np.where(mask, 0.0, pos))
    return np.concatenate(xs), np.concatenate(ss)


def randcone(name, m, cones, seed):
    """Random conic program with a known optimal objective: a copy of
    `benchmarks/conic_mini.randcone` on the port's `ConeSpec`."""
    rng = np.random.default_rng(seed)
    n = cones.dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0
    xstar, sstar = _complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    c = A.T @ ystar + sstar
    return name, A, b, c, cones, float(c @ xstar)


def randqcp_diag(name, m, cones, seed):
    """`benchmarks/conic_mini.randqcp(..., q_rank="diag")`: the same
    construction with a diagonal Q, pobj* = 0.5 x*'Qx* + c'x*."""
    rng = np.random.default_rng(seed)
    n = cones.dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0
    Q = rng.random(n) + 0.1
    xstar, sstar = _complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    c = A.T @ ystar + sstar - Q * xstar
    return name, A, b, c, Q, cones, 0.5 * float(xstar @ (Q * xstar)) + float(
        c @ xstar)


def conic_batch(seed0, count=B, spec=None, m=CONIC_M, diag_q=False):
    """(cones, (As, bs, cs, Qs or None), optima) of `count` instances."""
    from abip_tpu_torch.cones import ConeSpec

    cones = ConeSpec(**(spec or CONIC_SPEC))
    if diag_q:
        data = [randqcp_diag("q", m, cones, seed0 + i) for i in range(count)]
        Qs = np.stack([d[4] for d in data])
    else:
        data = [randcone("c", m, cones, seed0 + i) for i in range(count)]
        Qs = None
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


def conic_phase1_state(torch, P, cones):
    """The solver's phase 1 (ladder) run to the 1e-3 switch: a mid-solve
    state for the delta chunk."""
    from abip_tpu_torch.parallel.batched_qcp import _solve

    kw = {k: v for k, v in CONIC_KW.items() if k not in ("engine",
                                                          "normalize")}
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


def compare_conic(ker, plain, names, label):
    """Raise unless every kernel output is within the stated tolerance of
    the plain version's: rtol 2e-5 plus 1e-5 of the output's largest
    magnitude, that absolute term times 1/rho_y for the free block
    (y, dy), and ERR_RTOL for the inner criterion (slot 2 of the row).
    Return the largest absolute difference."""
    worst = 0.0
    for name, k, p in zip(names, ker, plain):
        k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
        if not np.isfinite(k).all():
            raise AssertionError(f"{label}: kernel {name} is not finite")
        diff = np.abs(k - p)
        worst = max(worst, float(diff.max()))
        atol = REL_SCALE * max(1.0, float(np.abs(p).max()))
        if name in ("y", "dy"):
            atol *= Y_AMPLIFY
        allowed = RTOL * np.abs(p) + atol
        if name == "row":
            allowed[:, 2] = ERR_RTOL * np.abs(p[:, 2])
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


def ladder_parity(torch, dev, label, case):
    """K2 against the plain ladder on phase 1 from the cold start of one
    batch: equal t_done, stages and mu; the stated tolerance; at most
    ACC_RATIO times the plain version's distance from an f64 run.
    Returns the largest |kernel - plain|."""
    from abip_tpu_torch.cones import cone_operands
    from abip_tpu_torch.ops.conic_dr import (LadderOperands,
                                             _dr_ladder_compute, ladder_cuda)

    cones, stacks, _ = conic_batch(**case)
    P = conic_prepared(torch, cones, stacks, dev)
    op = cold_ladder_operands(torch, P, cones)
    co = cone_operands(cones, dev)
    t_max = torch.full((op.A.shape[0],), 2048, dtype=torch.int32, device=dev)
    run = dict(probe=PROBE, psi=1.0, woodbury=P.dss.form == "woodbury")
    ker = ladder_cuda(op, co, t_max, **run)
    plain = _dr_ladder_compute(op, co, t_max, **run)
    exact = _dr_ladder_compute(LadderOperands(*[x.double() for x in op]), co,
                               t_max, **run)
    torch.cuda.synchronize()
    for col, what in ((3, "t_done"), (6, "stages"), (4, "mu")):
        if not torch.equal(ker[4][:, col], plain[4][:, col]):
            raise AssertionError(
                f"K2 {label}: {what} differs: kernel "
                f"{ker[4][:, col].tolist()} plain {plain[4][:, col].tolist()}")
    err = compare_conic(ker, plain, ("y", "x", "vy", "vx", "row"),
                        f"K2 {label}")
    kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K2 {label}")
    print(f"parity K2 {label} {P.dss.form} phase 1 (T=2048, mu_stop 1e-3): "
          f"t_done {int(ker[4][0, 3])}, stages {int(ker[4][0, 6])}, mu "
          f"{float(ker[4][0, 4]):.4e} equal on every lane; max|kernel-plain| "
          f"{err:.3e} (stated tolerance: ok); vs f64 run: kernel {kerr:.3e}, "
          f"plain {perr:.3e} (kernel at most {ACC_RATIO}x: ok)")
    return err


def delta_parity(torch, dev, label, case):
    """K3 against the plain chunk on the state phase 1 hands to the
    endgame: T=64 with thresh=0 (equal t_done, the stated tolerance, the
    accuracy ratio), then thresholds that stop the lanes mid-chunk
    (`decisive_thresholds`; t_done within one probe).  Returns the
    largest |kernel - plain|."""
    from abip_tpu_torch.ops.conic_delta import (ConicDeltaAnchor,
                                                _conic_delta_compute,
                                                conic_delta_cuda)
    from abip_tpu_torch.cones import cone_operands

    cones, stacks, _ = conic_batch(**case)
    P = conic_prepared(torch, cones, stacks, dev)
    st = conic_phase1_state(torch, P, cones)
    co = cone_operands(cones, dev)
    nb = P.A.shape[0]
    anc = conic_anchor(torch, P, cones, st, 0.0)
    t_max = torch.full((nb,), 64, dtype=torch.int32, device=dev)
    run = dict(probe=PROBE, woodbury=P.dss.form == "woodbury")
    ker = conic_delta_cuda(anc, co, t_max, **run)
    plain = _conic_delta_compute(anc, co, t_max, **run)
    exact = _conic_delta_compute(ConicDeltaAnchor(*[x.double() for x in anc]),
                                 co, t_max, **run)
    torch.cuda.synchronize()
    if not torch.equal(ker[4][:, 3], plain[4][:, 3]):
        raise AssertionError(f"K3 {label}: t_done differs")
    err = compare_conic(ker, plain, ("dy", "dx", "dvy", "dvx", "row"),
                        f"K3 {label}")
    kerr, perr = accuracy_vs_f64(ker, plain, exact, f"K3 {label}")
    print(f"parity K3 {label} {P.dss.form} T=64: t_done equal; "
          f"max|kernel-plain| {err:.3e} (stated tolerance: ok); vs f64 run: "
          f"kernel {kerr:.3e}, plain {perr:.3e} (kernel at most {ACC_RATIO}x: "
          f"ok)")
    thresh, t_stop, drop = decisive_thresholds(torch, anc, co, run)
    anc = conic_anchor(torch, P, cones, st, thresh)
    t_max = torch.full((nb,), 256, dtype=torch.int32, device=dev)
    tk = conic_delta_cuda(anc, co, t_max, **run)[4][:, 3].int().tolist()
    tp = _conic_delta_compute(anc, co, t_max, **run)[4][:, 3].int().tolist()
    if tp != t_stop:
        raise AssertionError(f"K3 {label}: plain t_done {tp}, planned {t_stop}")
    if max(abs(a - b) for a, b in zip(tk, tp)) > PROBE:
        raise AssertionError(f"K3 {label}: t_done {tk} vs plain {tp}")
    print(f"parity K3 {label} stop-mid-chunk T=256: t_done kernel {tk} "
          f"plain {tp} (within one probe; each threshold splits a drop of at "
          f"least {min(drop):.3f}x in the plain criterion)")
    return err


def decisive_thresholds(torch, anc, co, run, T=64, min_drop=1.02):
    """Per lane, a threshold that the plain chunk's criterion crosses
    decisively within T iterations.  The criterion is not monotone, so a
    threshold just above its value at T may be grazed at an earlier probe
    by one f32 version and not by another.  Instead take the last probe k
    where the criterion drops at least 1.1x below its running minimum over
    the earlier probes (else the largest such drop, at least `min_drop`),
    and the geometric mean of the two as the threshold.  Returns
    (thresholds `(B,)`, the plain chunk's t_done with them, the drops)."""
    from abip_tpu_torch.ops.conic_delta import _conic_delta_compute

    nb = anc.A.shape[0]
    errs = torch.stack([
        _conic_delta_compute(
            anc, co, torch.full((nb,), t, dtype=torch.int32,
                                device=anc.A.device), **run)[4][:, 2].double()
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
    pobj = res.pobj.cpu().numpy()
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
    if solved != B:
        raise AssertionError(f"conic main path: statuses {status.tolist()}")
    if not (np.isfinite(res.x.cpu().numpy()).all()
            and np.isfinite(pobj).all()):
        raise AssertionError("conic main path: non-finite solution")
    rel = np.abs(pobj - stars) / np.maximum(1.0, np.abs(stars))
    print(f"conic main path vs known optima: max relative objective gap "
          f"{rel.max():.3e} (limit 1e-5)")
    if rel.max() > 1e-5:
        raise AssertionError(f"conic objectives off: {rel.tolist()}")
    if l2 <= 0 or l3 <= 0:
        raise AssertionError(f"conic main path launched K2 {l2}x, K3 {l3}x")
    return l2, l3


def phase_conic_timing(torch, dev, card):
    from abip_tpu_torch import conic_ops
    from abip_tpu_torch.ops.conic_delta import (_conic_delta_compute,
                                                conic_delta_cuda)
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
    k2_ms = cuda_ms(lambda: ladder_cuda(op, co, t_max, **run), iters=5)
    k2_plain = cuda_ms(lambda: _dr_ladder_compute(op, co, t_max, **run),
                       iters=3)
    print(f"timing K2 one phase-1 launch B=16 dim-1020 (32 iterations, 4 "
          f"stages) [{card}]: kernel {k2_ms:.3f} ms, plain version "
          f"{k2_plain:.3f} ms")
    st = conic_phase1_state(torch, P, cones)
    anc = conic_anchor(torch, P, cones, st, 0.0)
    t_max = torch.full((B,), 512, dtype=torch.int32, device=dev)
    run = dict(probe=PROBE, woodbury=True)
    k3_ms = cuda_ms(lambda: conic_delta_cuda(anc, co, t_max, **run), iters=5)
    k3_plain = cuda_ms(lambda: _conic_delta_compute(anc, co, t_max, **run),
                       iters=1)
    print(f"timing K3 chunk T=512 B=16 dim-1020 [{card}]: kernel "
          f"{k3_ms:.3f} ms ({k3_ms * 1e3 / 512:.2f} us/iteration), plain "
          f"version {k3_plain:.3f} ms (one chunk)")
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
    return (k2_ms, k2_plain), (k3_ms, k3_plain)


def phase_conic_profile(torch, dev):
    cones, stacks, _ = conic_batch(8700)
    profile_solve(torch, lambda: solve_conic(torch, cones, stacks, dev),
                  {"K2": "conic_ladder_kernel", "K3": "conic_delta_kernel"},
                  "one conic solve")


def main():
    import time

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from abip_tpu_torch.ops.build import load_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = load_all(["admm_delta", "conic_ladder", "conic_delta"])
    print(f"build: three sources side by side in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, lib in built.items():
        regs = [ln.strip() for ln in lib.log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name}.cu: {lib.build_seconds:.1f} s [{card}] "
              f"{' | '.join(regs)}")

    k1_err = phase_kernel_parity(torch, dev)
    k1_launches = phase_main_path(torch, dev)
    k1_ms, k1_plain = phase_timing(torch, dev, card)
    phase_profile(torch, dev)

    k2_err = max(ladder_parity(torch, dev, *c) for c in CONIC_CASES)
    k3_err = max(delta_parity(torch, dev, *c) for c in CONIC_CASES)
    k2_launches, k3_launches = phase_conic_main(torch, dev)
    (k2_ms, k2_plain), (k3_ms, k3_plain) = phase_conic_timing(torch, dev,
                                                              card)
    phase_conic_profile(torch, dev)

    print(json.dumps({"kernels": [
        {"name": "delta_chunk_kernel", "route": "cuda",
         "source": "abip_tpu_torch/csrc/admm_delta.cu",
         "replaces": "abip_tpu/ops/admm_delta.py:287",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain},
        {"name": "conic_ladder_kernel", "route": "cuda",
         "source": "abip_tpu_torch/csrc/conic_ladder.cu",
         "replaces": "abip_tpu/ops/conic_pallas.py:703",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain},
        {"name": "conic_delta_kernel", "route": "cuda",
         "source": "abip_tpu_torch/csrc/conic_delta.cu",
         "replaces": "abip_tpu/ops/conic_delta.py:718",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
