"""One run of one cell of the port's benchmark.

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration in `configs/<config>.json`, its traffic in
`traffic/<traffic>.json`, the entry that calls the program in
`entries/<problem>_<route>.py` (the configuration's `problem`, the
traffic's `route`), and each metric in `metrics/<metric>.py`.  A run

1. warms up on instances of the cell's shape drawn from fixed seeds, the
   same in every run, with the configuration's options under the
   traffic's `warmup_options` (a capped solve warms the same shapes),
   and counts all it did so far as set-up;
2. measures: the instances are made on the host between calls, fresh
   ones drawn from `--seed`, or, where the traffic names a `pool`, the
   pool's fixed calls (`batch` consecutive instances each) in an order
   drawn from `--seed`, cycle after cycle, so that every seed does the
   same work; each call of the entry, which moves them to the card,
   solves them and waits for the card, is timed; the window is the
   calls laid end to end, closed by the call in progress when
   `--seconds` have passed;
   where the cell reports an end-to-end metric of the device trace, a
   `--trace 0` run records the card's activity alone over the window
   (`trace.device_busy`);
3. with `--trace 1`, profiles a few more calls (`trace.py`);
4. reads the device's memory peak, frees the program's state and judges
   the answers against the plain reference (`reference.py`): a sample
   drawn from the seed, the instance of most ADMM iterations with it,
   each number the worst over the sample against its limit in the
   configuration.  An answer is judged whatever its status; an instance
   the program did not solve (status other than 1) also counts as
   failed and in no rate.

The program, `abip_tpu_torch`, receives only the generated arrays.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "abip_tpu")
# seed streams: warm-up and pool (seed-independent), window, check
# sample, the pool's order
WARMUP, WINDOW, SAMPLE, POOL, ORDER = 0, 1, 2, 3, 4
# the reference's own tolerance: it gives the optimum p* to about this
REFERENCE_EPS = 1e-9
# instances the reference and the control take at once
REFERENCE_BLOCK = 16


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the file at `path` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(config: dict, traffic: dict):
    """The entry module of the configuration's problem on the traffic's
    route."""
    return load_module(
        HERE / "entries" / f"{config['problem']}_{traffic['route']}.py")


def load_cell(name: str, manifest: dict | None = None) -> SimpleNamespace:
    """The cell `name` of the manifest with its configuration, traffic,
    entry module and the metrics it reports, by trace mode."""
    man = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(ROOT / conf_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    if traffic.get("pool", 0) % traffic["batch"]:
        raise ValueError(f"traffic {cell['traffic']!r}: the pool holds "
                         f"whole calls of {traffic['batch']}")
    entry = load_entry(config, traffic)
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", cells)]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells goes wherever the
    # end-to-end metric it moves goes
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", cells if m["moves"] in reported
                              else ())]
    return SimpleNamespace(name=name, cell=cell, config=config,
                           traffic=traffic, entry=entry, end_to_end=e2e,
                           per_layer=layer, chips=cell["chips"])


def instance_seed(seed: int, stream: int, index: int):
    """The numpy seed of instance `index` of `stream` in a run of
    `seed`: any whole number, negative ones too, gives its own."""
    return [seed % 2 ** 64, stream, index]


def window_keys(traffic, seed, start, count):
    """The numpy seeds of the window's instances start .. start + count - 1:
    fresh ones of the run's seed, or the pool's.  The pool is cut into
    fixed calls of `batch` consecutive instances; each cycle through it
    takes the calls in an order of its own drawn from the seed."""
    pool = traffic.get("pool")
    if not pool:
        return [instance_seed(seed, WINDOW, i)
                for i in range(start, start + count)]
    b = traffic["batch"]
    calls = pool // b
    keys = []
    for i in range(start, start + count):
        call, lane = divmod(i, b)
        order = np.random.default_rng(
            instance_seed(seed, ORDER, call // calls)).permutation(calls)
        keys.append(instance_seed(0, POOL, int(order[call % calls]) * b
                                  + lane))
    return keys


def make_instances(cell, keys):
    gen = load_module(HERE / "generators" / f"{cell.config['generator']}.py")
    return [gen.make(cell.config["params"], key) for key in keys]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wall_s(fn, device):
    """(seconds, result) of `fn()` on the host clock, from a synchronized
    start to a synchronized end.  Frozen copy of
    `abip_tpu_torch/utils/timing.py:67-75` (`wall_s`), which also waits
    for nothing where the device is the CPU (the tests)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


class Solver:
    """The entry of a cell on a device: call k of the window takes the
    window's instances k * batch .. (k + 1) * batch - 1, where `batch` is
    the traffic's unless `per_call` says otherwise (the control takes a
    check's worth of instances in one call)."""

    def __init__(self, cell, device, per_call=None):
        self.cell, self.device = cell, device
        self.batch = per_call or cell.traffic["batch"]
        self.call = cell.entry.prepare(cell.config, cell.traffic, device)

    def warm_up(self):
        """The traffic's `warmup_calls` calls on instances of fixed seeds,
        with its `warmup_options` over the configuration's."""
        cell, route = self.cell, self.cell.traffic["route"]
        options = dict(cell.config["options"],
                       **{route: dict(cell.config["options"][route],
                                      **cell.traffic.get("warmup_options",
                                                         {}))})
        call = cell.entry.prepare(dict(cell.config, options=options),
                                  cell.traffic, self.device)
        for k in range(cell.traffic["warmup_calls"]):
            staged = cell.entry.stage(make_instances(cell, [
                instance_seed(0, WARMUP, k * self.batch + j)
                for j in range(self.batch)]))
            _, res = wall_s(lambda: call(staged), self.device)
            cell.entry.answers(res)

    def keys(self, seed, k):
        """The instances of the window's call k."""
        return window_keys(self.cell.traffic, seed, k * self.batch,
                           self.batch)

    def run(self, keys):
        """(seconds, answers) of one timed call on the instances of
        `keys`, which the answers keep."""
        import torch

        with torch.profiler.record_function("portbench.generate"):
            staged = self.cell.entry.stage(make_instances(self.cell, keys))
        with torch.profiler.record_function("portbench.solve"):
            sec, res = wall_s(lambda: self.call(staged), self.device)
        with torch.profiler.record_function("portbench.answers"):
            return sec, dict(self.cell.entry.answers(res), keys=keys)


def window(solver, seed, seconds, calls0=0):
    """Timed calls on the window's instances until their walls sum past
    `seconds`; returns the list of (seconds, answers)."""
    out, total, k = [], 0.0, calls0
    while not out or total < seconds:
        sec, ans = solver.run(solver.keys(seed, k))
        out.append((sec, ans))
        total += sec
        k += 1
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def check(cell, seed, calls, device):
    """(correct, {number: (value, limit)}, every reading): the numbers
    on a sample of `traffic["check_sample"]` instances drawn from the
    seed with the one of most ADMM iterations, each the worst over the
    sample, against the configuration's limits for the traffic's
    route."""
    import torch

    import portbench.reference as ref

    limits = cell.config["limits"][cell.traffic["route"]]
    admm = np.concatenate([a["admm_iters"] for _, a in calls])
    keys = [key for _, a in calls for key in a["keys"]]
    where = [(a, j) for _, a in calls for j in range(len(a["keys"]))]
    total = admm.size
    rng = np.random.default_rng(instance_seed(seed, SAMPLE, 0))
    k = min(cell.traffic["check_sample"], total)
    picks = sorted(set(rng.choice(total, size=k, replace=False).tolist())
                   | {int(np.argmax(admm))})
    worst = {name: 0.0 for name in ref.NUMBERS}
    cones = cell.config["cones"]
    for lo in range(0, len(picks), REFERENCE_BLOCK):
        block = picks[lo:lo + REFERENCE_BLOCK]
        insts = make_instances(cell, [keys[i] for i in block])
        ans = [{key: where[i][0][key][where[i][1]] for key in ("x", "y", "s")}
               for i in block]
        A, bb, c = (torch.as_tensor(np.stack([d[key] for d in insts]),
                                    dtype=torch.float64, device=device)
                    for key in ("A", "b", "c"))
        r = ref.solve(A, bb, c, cones, REFERENCE_EPS)
        if not bool((r.status == 1).all()):
            raise RuntimeError(f"the reference did not converge on "
                               f"instances {block}")
        pstar = (c * r.x).sum(-1)
        got = ref.judge(A, bb, c, cones,
                        *(np.stack([a[key] for a in ans])
                          for key in ("x", "y", "s")), pstar)
        for name, v in got.items():
            worst[name] = max(worst[name], float(v.max()))
    numbers = {name: (worst[name], limits[name]) for name in ref.NUMBERS
               if name in limits}
    correct = all(v <= lim for v, lim in numbers.values())
    return correct, numbers, worst


def run(name, seed, seconds, trace, device="cuda", t0=None, cell=None,
        per_call=None):
    """One run of cell `name`; returns the result line (a dict) and the
    check's numbers.  `device="cpu"` serves the tests: it skips the look
    for cards and reports no device metric."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or load_cell(name)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    solver = Solver(cell, device, per_call)
    solver.warm_up()
    setup_s = time.perf_counter() - t0
    window_busy_s = None
    if on_card and not trace and any(m["source"] == "device_trace"
                                     for m in cell.end_to_end):
        import portbench.trace as tr

        calls, window_busy_s, ops = tr.device_busy(
            lambda: window(solver, seed, seconds))
        print(f"window: {len(calls)} calls, {sum(s for s, _ in calls)!r} s "
              f"on the host clock, the card busy {window_busy_s!r} s over "
              f"{ops} device operations", file=sys.stderr)
    else:
        calls = window(solver, seed, seconds)
    timed = len(calls)
    prof = None
    if trace:
        import portbench.trace as tr

        prof = tr.profile(solver, seed, timed, cell.traffic["profile_calls"])
        calls += prof.calls
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del solver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, numbers, readings = check(cell, seed, calls, device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run holds {found}, which the port may not "
                         f"load")
    record = SimpleNamespace(
        config=cell.config, traffic=cell.traffic, setup_s=setup_s,
        window_busy_s=window_busy_s,
        walls=[s for s, _ in calls[:timed]],
        answers=[a for _, a in calls[:timed]], profile=prof)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if not on_card and m["source"] == "device_trace":
            continue     # a CPU run measures no device metric
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    status = np.concatenate([a["status"] for a in record.answers])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    if prof is not None and on_card:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
    line = {"correct": bool(correct), "attempted": int(status.size),
            "failed": int((status != 1).sum()), "metrics": metrics,
            "device": dev}
    if prof is not None and on_card:
        line["breakdown"] = prof.breakdown
    line["check"] = {k: {"value": finite(v), "limit": lim}
                     for k, (v, lim) in numbers.items()}
    return line, readings


def check_lines(line, readings):
    """The check's numbers, one a line, each beside its limit; the
    numbers the cell does not compare follow as readings."""
    out = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
           for k, v in line["check"].items()]
    rest = {k: v for k, v in readings.items() if k not in line["check"]}
    out.append("readings not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in rest.items()))
    out.append(f"correct: {line['correct']}")
    return out


def finite(x):
    """x, or the largest float where x is not finite (JSON has no inf)."""
    return x if math.isfinite(x) else sys.float_info.max
