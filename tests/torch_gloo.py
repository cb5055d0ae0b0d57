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
fails the test, so a hang never stalls the suite.

A test module runs all its tasks in one group per size:
`run_tasks(tasks)` on each rank maps every task's name to its result or
its traceback, and `result(outs, name)` in the test fails on a rank's
traceback and unless every rank returned the same bits.
"""
from __future__ import annotations

import queue
import time
import traceback
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def cpu_mesh(world, axis):
    """A 1-D CPU `DeviceMesh` over the whole group with axis `axis`."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (world,), mesh_dim_names=(axis,))


def run_tasks(tasks):
    """{name: fn() or "raised: <traceback>"} over the dict `tasks`, in
    order: a task that raises fails only its own test."""
    out = {}
    for name, fn in tasks.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = "raised: " + traceback.format_exc()
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
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            value = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value))
    except Exception:
        out.put((rank, False, traceback.format_exc()))


def run_group(fn, world, tmp_path, *args, timeout=120.0):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path / f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"gloo group of {world} did not finish within "
                            f"{timeout:.0f} s (ranks done: {sorted(results)})")
            try:
                rank, ok, result = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    pytest.fail(f"ranks {dead} of {world} died without a "
                                f"result (exit codes "
                                f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                pytest.fail(f"rank {rank} of {world} raised:\n{result}")
            results[rank] = result
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
