#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`abip_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
`nvcc`.  It imports no JAX.  Phases, each printing its own lines:

1. build the delta-chunk kernel (`abip_tpu_torch/csrc/admm_delta.cu`)
   from the checkout;
2. hold the kernel against its plain PyTorch version on the card, on
   mid-solve anchors: B=16 at the smoke shape (m=50, n=2000) and a
   ragged shape (m=37, n=411), T=64, thresh=0; then thresholds that stop
   lanes mid-chunk;
3. solve a fresh B=16 smoke batch through `solve_lp_batch` with the
   options of the repository's benchmark (eps=1e-6, chunk T=1536) and
   check 16/16 solved, each objective against scipy's HiGHS, and that
   the kernel was launched;
4. time the whole solve (median of 3 fresh batches), one T=1536 chunk
   of the kernel against the plain version's, and the f64 pieces around
   the kernel (setup, anchor, residual check);
5. a profiler breakdown of one solve's device time.

Exits nonzero, printing no result, without a card or on any failure.
The last two lines are the kernel summary and the result, as JSON.
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


def phase_profile(torch, dev):
    """Device time of one solve by kernel, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from abip_tpu_torch.utils.timing import wall_s

    _, stacks = smoke_batch(6000)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sec, _ = wall_s(lambda: solve(torch, stacks, dev))

    def dev_us(e):
        for key in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, key):
                return float(getattr(e, key))
        return 0.0

    events = [(e.key, dev_us(e), e.count) for e in prof.key_averages()]
    total = sum(us for _, us, _ in events)
    if total <= 0.0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    k1 = sum(us for k, us, _ in events if "delta_chunk_kernel" in k)
    top = sorted(events, key=lambda e: -e[1])[:6]
    print(f"profile one solve (wall {sec:.3f} s under the profiler): device "
          f"busy {total / 1e3:.1f} ms = {100 * total / 1e6 / sec:.1f}% of the "
          f"wall; K1 {k1 / 1e3:.1f} ms = {100 * k1 / total:.1f}% of device "
          f"time")
    for key, us, count in top:
        print(f"profile   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from abip_tpu_torch.ops.build import load

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    built = load("admm_delta")
    regs = [ln.strip() for ln in built.log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build admm_delta.cu: {built.build_seconds:.1f} s [{card}] "
          f"{' | '.join(regs)}")

    max_err = phase_kernel_parity(torch, dev)
    launches = phase_main_path(torch, dev)
    ms, plain_ms = phase_timing(torch, dev, card)
    phase_profile(torch, dev)

    print(json.dumps({"kernels": [{
        "name": "delta_chunk_kernel", "route": "cuda",
        "source": "abip_tpu_torch/csrc/admm_delta.cu",
        "replaces": "abip_tpu/ops/admm_delta.py:287",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
