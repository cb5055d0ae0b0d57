"""Cells cut to a size a CPU test run holds: the configuration's shapes
shrink, everything else (options, limits, traffic) stays the cell's."""
from portbench import harness

TINY_LP = {"m": 10, "n_rand": 30, "density": 0.3}
TINY_CONES = {"soc": [5], "rsoc": [4], "nonneg": 10}


def tiny_cell(name, batch=4):
    cell = harness.load_cell(name)
    if cell.config["problem"] == "lp":
        shape = dict(params=TINY_LP, cones={"nonneg": 40})
    else:
        shape = dict(params={"m": 7, "cones": TINY_CONES}, cones=TINY_CONES)
    cell.config = dict(cell.config, **shape)
    cell.traffic = dict(cell.traffic, batch=min(cell.traffic["batch"], batch),
                        profile_calls=1)
    return cell


CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]

# The conic entries serve no cell yet (a published conic configuration
# comes with a later cell); they run here on a tiny configuration of the
# frozen conic generator, with the cell's traffic and metrics of the LP
# cell of the same route.
TINY_CONIC = {
    "problem": "conic", "generator": "randcone",
    "params": {"m": 7, "cones": TINY_CONES}, "cones": TINY_CONES,
    "eps": 1e-6,
    "options": {"batch": {"engine": "sprint2", "eps": 1e-6,
                          "precision": "mixed", "normalize": True,
                          "rho_y": 1e-3, "solver": "inverse"},
                "single": {"eps": 1e-6}},
    "limits": {"batch": {"objective": 4e-5, "gap": 5e-5,
                         "complementarity": 5e-5},
               "single": {"objective": 2.5e-5, "gap": 1.5e-5,
                          "complementarity": 4e-5}},
}
CONIC_ROUTES = {"batch": "smoke_lp.batch16", "single": "smoke_lp.single"}


def tiny_conic_cell(route, batch=4):
    """A cell of the LP cell's traffic on `TINY_CONIC`, through the conic
    entry of `route`; it reports no metric."""
    cell = tiny_cell(CONIC_ROUTES[route], batch)
    cell.config = TINY_CONIC
    cell.entry = harness.load_module(harness.HERE / "entries"
                                     / f"conic_{route}.py")
    cell.end_to_end = cell.per_layer = []
    return cell
