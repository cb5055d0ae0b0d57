"""Cells cut to a size a CPU test run holds: each configuration's own
`tiny` shape (`params` and `cones`) takes the place of its full one,
everything else (options, limits, traffic) stays the cell's."""
from portbench import harness


def tiny_cell(name, batch=4, config=None):
    """Cell `name` at its configuration's tiny shape; with `config`, that
    configuration on the cell's traffic, through the entry of its own
    problem."""
    cell = harness.load_cell(name)
    if config is not None:
        cell.config = config
        cell.entry = harness.load_entry(config, cell.traffic)
    cell.config = dict(cell.config, **cell.config["tiny"])
    cell.traffic = dict(cell.traffic, batch=min(cell.traffic["batch"], batch),
                        profile_calls=1)
    return cell


CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]

# The conic entries serve no cell yet (a published conic configuration
# comes with a later cell); they run here on a stand-in configuration of
# the frozen conic generator at its tiny shape, with the traffic and
# metrics of the LP cell of the same route.  Its full shape is the
# dim-1020 family's, which no cell runs.
TINY_CONIC = {
    "problem": "conic", "generator": "randcone",
    "params": {"m": 340, "cones": {"soc": [125, 125], "rsoc": [20],
                                   "nonneg": 750}},
    "cones": {"soc": [125, 125], "rsoc": [20], "nonneg": 750},
    "tiny": {"params": {"m": 7, "cones": {"soc": [5], "rsoc": [4],
                                          "nonneg": 10}},
             "cones": {"soc": [5], "rsoc": [4], "nonneg": 10}},
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
    cell = tiny_cell(CONIC_ROUTES[route], batch, TINY_CONIC)
    cell.end_to_end = cell.per_layer = []
    return cell


def configurations():
    """Every configuration the tests run: the manifest's, by name, and
    the conic stand-in."""
    man = harness.load_json(harness.ROOT / "BENCHMARK.json")
    out = {c["name"]: harness.load_json(harness.ROOT / c["file"])
           for c in man["configs"]}
    out["TINY_CONIC"] = TINY_CONIC
    return out
