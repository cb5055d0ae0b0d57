"""Command-line entry: solve MPS, SeDuMi .mat, or CBLIB .cbf problems.

    python -m abip_tpu_torch problem.mps [--eps 1e-6] [--verbose] [--cpu]
    python -m abip_tpu_torch problem.mat --sedumi [--eps 1e-4]
    python -m abip_tpu_torch problem.cbf [--eps 1e-4]

Port of `abip_tpu/__main__.py`: the same flags and JSON line.  The
solve runs on the CUDA card; `--cpu` runs it on the CPU.
"""
import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="abip_tpu_torch", description=__doc__)
    ap.add_argument("path", help=".mps(.gz) file or SeDuMi .mat file")
    ap.add_argument("--sedumi", action="store_true",
                    help="treat input as a SeDuMi .mat conic problem")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU instead of the CUDA card")
    ap.add_argument("--crossover", action="store_true",
                    help="polish an MPS solve to a certified vertex")
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    user_pobj = None   # instance-sense objective, when it differs from pobj
    if args.sedumi:
        from .io.sedumi import solve_sedumi

        sol = solve_sedumi(args.path, eps=args.eps, verbose=args.verbose,
                           device=device)
    elif args.path.endswith(".cbf"):
        from .io.cbf import solve_cbf

        sol, _x, obj = solve_cbf(args.path, eps=args.eps,
                                 verbose=args.verbose, device=device)
        # the status line / `objective` JSON field report the instance's
        # OWN objective (its OBJSENSE and constant applied)
        user_pobj = obj
    else:
        from .io.presolve import solve_mps

        sol, std = solve_mps(args.path, eps=args.eps, verbose=args.verbose,
                             device=device)
        if args.crossover and sol.status_name.startswith("Solved"):
            from .crossover import crossover

            cr = crossover(std.A.toarray(), std.b, std.c, sol.x_std)
            print(f"crossover: optimal_basis={cr.optimal} "
                  f"vertex_obj={std.user_objective(cr.pobj):.8f}")

    if args.json:
        rec = {
            "status": sol.status_name, "pobj": sol.pobj, "dobj": sol.dobj,
            "res_pri": sol.res_pri, "res_dual": sol.res_dual,
            "rel_gap": sol.rel_gap, "ipm_iters": sol.ipm_iters,
            "admm_iters": sol.admm_iters, "solve_time": sol.solve_time,
        }
        if user_pobj is not None:
            # pobj/dobj/rel_gap stay in SOLVER sense (internally
            # consistent); `objective` carries the instance's own sense
            # (OBJSENSE + OBJBCOORD applied)
            rec["objective"] = user_pobj
        print(json.dumps(rec))
    else:
        shown = sol.pobj if user_pobj is None else user_pobj
        sense = "" if user_pobj is None else " (instance sense)"
        print(f"{sol.status_name}: objective {shown:.8f}{sense} "
              f"({sol.ipm_iters} IPM / {sol.admm_iters} ADMM, "
              f"{sol.solve_time:.2f}s)")
    return 0 if sol.status_name.startswith("Solved") else 1


if __name__ == "__main__":
    sys.exit(main())
