"""Run a function on every rank of a gloo group of CPU processes.

The multi-card tests of the port (`test_torch_sharded.py`,
`test_torch_mesh.py`) hold `torch.distributed` code to the JAX package
on the CPU: `run_group(fn, world, tmp_path, *args)` spawns `world`
processes, joins them into a gloo group through a `FileStore` under
`tmp_path`, calls `fn(rank, world, *args)` on each and returns the
results in rank order.  `fn` must be a module-level function of a
module that imports neither JAX nor the JAX package; results travel
back through a queue, so they must pickle (numpy arrays, floats,
strings).  A rank that raises fails the test with its traceback; a
group that has not finished within `timeout` seconds is killed and
fails the test, so a hang never stalls the suite.  Every group prints,
and every failure states, its walls: when the last rank was up (the
interpreter started and torch imported), when the last one had joined
the group, when the ranks finished, and each rank's slowest tasks.

A test module runs its tasks in a few groups per size (`Groups`):
`run_tasks(tasks, part)` on each rank maps every task of the group's
part to its result or its traceback, and `result(outs, name)` in the
test fails on a rank's traceback and unless every rank returned the same
bits.  A size whose group failed fails every later test of that size at
once with the first failure's message, so it costs one timeout, not one
per test.
"""
from __future__ import annotations

import queue
import time
import traceback
import uuid
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The limit of one group: over 3x the slowest group measured under the
# full suite at `-n 6 --dist loadfile` on 8 cores (118 s, the conic
# shard of `test_torch_sharded.py`, ~15,700 collectives a rank, each one
# waiting for its peers to be scheduled).
GROUP_TIMEOUT = 400.0

_TASK_WALLS: dict = {}     # a rank's {task: seconds} of its `run_tasks`


def cpu_mesh(world, axis):
    """A 1-D CPU `DeviceMesh` over the whole group with axis `axis`."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (world,), mesh_dim_names=(axis,))


def run_tasks(tasks, part=None):
    """{name: fn() or "raised: <traceback>"} over the dict `tasks` (those
    that `part(name)` selects, where given), in order: a task that raises
    fails only its own test."""
    out = {}
    for name, fn in tasks.items():
        if part is not None and not part(name):
            continue
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:
            out[name] = "raised: " + traceback.format_exc()
        _TASK_WALLS[name] = time.perf_counter() - t0
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b or (a != a and b != b)


def result(outs, name):
    """Rank 0's result of task `name` among every rank's `run_tasks`
    output `outs`, after checking that no rank raised and every rank
    returned the same bits."""
    for r, out in enumerate(outs):
        got = out[name]
        if isinstance(got, str) and got.startswith("raised: "):
            pytest.fail(f"rank {r} {got}")
        assert _equal(got, outs[0][name]), f"rank {r} differs from rank 0"
    return outs[0][name]


def _rank_main(rank, world, store_path, fn, args, out):
    """One rank: report "up", join, report "joined", run `fn`, report
    ("done", (ok, value or traceback, task walls))."""
    out.put(("up", rank, None))
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        out.put(("joined", rank, None))
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put(("done", rank, (True, value, dict(_TASK_WALLS))))
    except Exception:
        out.put(("done", rank, (False, traceback.format_exc(), {})))


class _Walls:
    """When each stage of a group was reached by its last rank, seconds
    from the spawn."""

    STAGES = ("up", "joined", "done")

    def __init__(self, world):
        self.world, self.t0 = world, time.monotonic()
        self.ranks = {s: set() for s in self.STAGES}
        self.at = {}
        self.tasks = {}        # rank -> {task: seconds}

    def mark(self, stage, rank):
        self.ranks[stage].add(rank)
        if len(self.ranks[stage]) == self.world:
            self.at[stage] = time.monotonic() - self.t0

    def __str__(self):
        parts = [f"{s} {self.at[s]:.1f} s" if s in self.at else
                 f"{s} {len(self.ranks[s])}/{self.world} ranks"
                 for s in self.STAGES]
        line = (f"gloo group of {self.world}: " + ", ".join(parts)
                + f" (wall {time.monotonic() - self.t0:.1f} s)")
        if self.tasks:
            slowest = max(self.tasks.values(), key=lambda w: sum(w.values()))
            top = sorted(slowest.items(), key=lambda kv: -kv[1])[:4]
            line += "; slowest rank's tasks: " + ", ".join(
                f"{k} {v:.1f} s" for k, v in top)
        return line


def run_group(fn, world, tmp_path, *args, timeout=GROUP_TIMEOUT):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path / f"store-{uuid.uuid4().hex}")
    walls = _Walls(world)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    done = False
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"gloo group of {world} did not finish within "
                            f"{timeout:.0f} s (ranks done: {sorted(results)})"
                            f"; {walls}")
            try:
                stage, rank, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    pytest.fail(f"ranks {dead} of {world} died without a "
                                f"result (exit codes "
                                f"{[procs[r].exitcode for r in dead]}); "
                                f"{walls}")
                continue
            walls.mark(stage, rank)
            if stage != "done":
                continue
            ok, value, walls.tasks[rank] = payload
            if not ok:
                pytest.fail(f"rank {rank} of {world} raised:\n{value}\n"
                            f"{walls}")
            results[rank] = value
        done = True
    finally:
        # a finished group's ranks exit on their own; a failed one's are
        # killed at once
        for p in procs:
            p.join(timeout=10 if done else 0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    print(walls)
    return [results[r] for r in range(world)]


class Part(NamedTuple):
    """Which of a module's tasks one group runs: those named in `names`,
    or with `names` None every task not named in `others`."""
    names: tuple | None
    others: tuple = ()

    def __call__(self, name):
        if self.names is not None:
            return name in self.names
        return name not in self.others


class Groups:
    """A test module's groups, run once for each size: `groups(world)` is
    (data(world), every rank's results), where each of `parts` (tuples of
    task names) runs `fn(rank, world, data, Part(part))` in a group of its
    own and one more group runs every other task, one group after the
    other, each within `timeout`: a sharded CPU solve is thousands of
    gloo round trips, and a group per whole solve keeps each group's wall,
    and so the limit that catches a hang, short.  A failed size is
    remembered, and every later call for it fails at once with the first
    failure's message."""

    def __init__(self, fn, data, tmp_path_factory, parts=(),
                 timeout=GROUP_TIMEOUT):
        self.fn, self.data, self.timeout = fn, data, timeout
        named = tuple(n for part in parts for n in part)
        self.parts = [Part(tuple(p)) for p in parts] + [Part(None, named)]
        self.tmp = tmp_path_factory
        self.runs = {}

    def _run(self, world):
        d = self.data(world)
        outs = [run_group(self.fn, world, self.tmp.mktemp("gloo"), d, part,
                          timeout=self.timeout) for part in self.parts]
        return d, [{k: v for out in outs for k, v in out[r].items()}
                   for r in range(world)]

    def __call__(self, world):
        if world not in self.runs:
            try:
                self.runs[world] = self._run(world)
            except pytest.fail.Exception as e:
                self.runs[world] = e
                raise
        got = self.runs[world]
        if isinstance(got, BaseException):
            pytest.fail(f"the groups of {world} failed before: {got}")
        return got
