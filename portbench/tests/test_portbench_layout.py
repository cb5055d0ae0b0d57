"""The manifest and every file it names load by name and keep to the
benchmark's naming rules."""
import json
import re

import pytest

from portbench import harness, reference
from portbench.tests.cases import configurations

MAN = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CONFIGS = configurations()


def test_manifest_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in entry.get("reduced", ()):
        assert NAME.fullmatch(key)
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry and isinstance(entry[key], str) and key != "source" \
                or key == "source" and "file" in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
    for m in cell.end_to_end + cell.per_layer:
        mod = harness.load_module(harness.HERE / "metrics"
                                  / f"{m['name']}.py")
        assert callable(mod.read)
    for fn in ("prepare", "stage", "answers"):
        assert callable(getattr(cell.entry, fn))
    limits = cell.config["limits"][cell.traffic["route"]]
    assert limits and set(limits) <= set(reference.NUMBERS)


def test_every_metric_and_config_is_used():
    cells = {w["config"] for w in MAN["workloads"]}
    assert cells == {c["name"] for c in MAN["configs"]}
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in METRICS}


def columns(cones):
    return sum(cones.get("soc", ())) + sum(cones.get("rsoc", ())) \
        + cones.get("nonneg", 0)


def generator(conf):
    return harness.load_module(harness.HERE / "generators"
                               / f"{conf['generator']}.py")


def test_config_files_name_their_cones():
    for c in MAN["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert all(key in conf for key in conf["reduced"])
        inst = generator(conf).make(conf["params"], [1, 2, 3])
        assert inst["A"].shape[1] == columns(conf["cones"])


@pytest.mark.parametrize("name", CONFIGS)
def test_config_names_its_tiny_shape(name):
    """The CPU tests' shape: the generator's params and the cones, with
    the cone kinds of the full shape."""
    conf = CONFIGS[name]
    tiny = conf["tiny"]
    assert set(tiny) == {"params", "cones"}
    inst = generator(conf).make(tiny["params"], [1, 2, 3])
    assert inst["A"].shape[1] == columns(tiny["cones"])

    def kinds(cones):
        return {k for k, v in cones.items() if v}

    assert kinds(tiny["cones"]) == kinds(conf["cones"])
