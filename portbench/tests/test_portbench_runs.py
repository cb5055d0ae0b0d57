"""Each cell's whole run at a size the CPU holds: the loop, the check and
the result line's shape; device metrics are not measured here."""
import json

import pytest
import torch

from portbench import harness
from portbench.tests.cases import (CELLS, TINY_CONIC, tiny_cell,
                                   tiny_conic_cell)



@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run(name, trace):
    cell = tiny_cell(name)
    line, readings = harness.run(name, 2 ** 31 + 12345, 0.5, trace,
                                 device="cpu", cell=cell)
    json.dumps(line)
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    wanted = cell.per_layer if trace else cell.end_to_end
    host = {m["name"] for m in wanted if m["source"] != "device_trace"}
    # a metric of what runs only on a card reads 0 here, every other above 0
    card_only = {m for m in host if getattr(harness.load_module(
        harness.HERE / "metrics" / f"{m}.py"), "CARD_ONLY", False)}
    assert set(line["metrics"]) == host
    assert all((v["value"] == 0) == (k in card_only)
               for k, v in line["metrics"].items())
    assert set(line["check"]) == set(
        cell.config["limits"][cell.traffic["route"]])
    lines = harness.check_lines(line, readings)
    assert lines[-1] == "correct: True"


@pytest.mark.parametrize("route", ["batch", "single"])
def test_tiny_conic_entry(route):
    cell = tiny_conic_cell(route)
    line, _ = harness.run(cell.name, 2 ** 31 + 777, 0.5, 0, device="cpu",
                          cell=cell)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["check"]) == set(TINY_CONIC["limits"][route])


def test_same_seed_same_instances():
    cell = tiny_cell("smoke_lp.batch16")
    a, b = (harness.make_instances(cell, harness.window_keys(
        cell.traffic, -7, 0, 2)) for _ in range(2))
    c = harness.make_instances(cell, [harness.instance_seed(0, harness.WARMUP,
                                                            0)])
    assert all((x["A"] == y["A"]).all() for x, y in zip(a, b))
    assert not (a[0]["A"] == c[0]["A"]).all()


@pytest.mark.parametrize("batch", [1, 3])
def test_pool_order_follows_the_seed(batch):
    """Every seed takes the pool's fixed calls, each cycle in an order
    of its own drawn from the seed."""
    traffic = {"pool": 5 * batch, "batch": batch}
    n = 5 * batch

    def calls(keys):
        return [tuple(map(tuple, keys[i:i + batch]))
                for i in range(0, len(keys), batch)]

    a = harness.window_keys(traffic, 11, 0, 2 * n)
    b = harness.window_keys(traffic, 12, 0, 2 * n)
    assert sorted(calls(a[:n])) == sorted(calls(b[:n])) \
        == sorted(calls(a[n:]))
    assert a != b and a[:n] != a[n:]
    assert a == harness.window_keys(traffic, 11, 0, 2 * n)
    assert a[n + 1:n + 1 + batch] == harness.window_keys(traffic, 11, n + 1,
                                                         batch)


def test_pool_holds_whole_calls(monkeypatch):
    real = harness.load_json
    monkeypatch.setattr(harness, "load_json", lambda p: dict(
        real(p), batch=3) if p.name == "pool7.json" else real(p))
    with pytest.raises(ValueError, match="whole calls"):
        harness.load_cell("smoke_lp.single")


def test_cli_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal cannot show here")
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "smoke_lp.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
