"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA cards as the cell asks for, and exits nonzero,
printing no result, without them.  The last lines on standard error are
the numbers the check compared, each beside its limit; the last line on
standard output is the result, one JSON object.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        sys.exit(f"{args.workload} needs {cell.chips} CUDA card(s); "
                 f"{torch.cuda.device_count()} visible")
    line, readings = harness.run(args.workload, args.seed, args.seconds,
                                 args.trace, t0=T0, cell=cell)
    for text in harness.check_lines(line, readings):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
