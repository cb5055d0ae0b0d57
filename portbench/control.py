"""The control of the check: the plain reference, put in the program's
place and computed one precision below the configuration's (float32 for
the float64 answers every cell states), run through the rest of a run.
Its `correct` has to come out false.  Prints, for each seed, every
number the check reads beside its limit.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

Not part of the benchmark's runs; it needs a CUDA card, as a run does.
"""
import argparse
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_entry():
    """An entry whose call is `reference.solve` in float32, to the
    configuration's eps, on the instances a program call would get."""
    import torch

    from portbench import reference
    from portbench.entries.common import stacked

    def prepare(config, traffic, device):
        def call(args):
            A, b, c = (torch.as_tensor(x, device=device).float()
                       for x in args)
            return reference.solve(A, b, c, config["cones"], config["eps"])
        return call

    def answers(r):
        return {"x": r.x.double().cpu().numpy(),
                "y": r.y.double().cpu().numpy(),
                "s": r.s.double().cpu().numpy(),
                "status": r.status.cpu().numpy(),
                "admm_iters": r.iters.cpu().numpy()}

    return SimpleNamespace(prepare=prepare, stage=stacked, answers=answers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        cell = harness.load_cell(args.workload)
        cell.entry = control_entry()
        line, readings = harness.run(
            args.workload, seed, 0, 0, cell=cell,
            per_call=max(cell.traffic["batch"], cell.traffic["check_sample"]))
        print(f"control {args.workload} seed {seed}: correct "
              f"{line['correct']}, attempted {line['attempted']}; "
              + ", ".join(f"{k} {v!r}" for k, v in readings.items()),
              flush=True)


if __name__ == "__main__":
    main()
