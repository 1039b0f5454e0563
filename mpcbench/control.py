"""The readings that the limits of `compare.LIMITS` are set from, at a
cell's own size, in one process (the set-up is paid once):

    python3 mpcbench/control.py --workload wb-walk --seeds 1,2,3 --seconds 10 \
        [--control-seeds 1,2,3] [--witness-seeds 1] [--solves N --at i,j] [--out FILE]

For each seed: a window of the cell's traffic on the program (or exactly
`--solves` solves), the sample the benchmark would check (or the solves
`--at`, each with the one before it), and the numbers compared, with the
reference's branches at each of `READ_TOLS` (and 0: its nominal answer
alone), per sampled solve its gap at each, and the float32 twins' gaps
where the check reads them (`compare.twin_gaps`). For the control seeds also
the control: the reference in float32 with TF32 matrix products (the
nearest precision below the configuration's float32 with TF32 off) in the
program's place, judged against the float64 reference in the same way;
for the witness seeds, as a reading only, the plain float32 reference in
the program's place. One JSON line a seed on standard output (and in
`--out`). The benchmark's runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# one process with few threads: the host's numerical libraries run on one
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

from mpcbench import compare, harness  # noqa: E402


READ_TOLS = (1e-6, 1e-5, 1e-4, 1e-3)


def _readings(solves, outs, judged=None, twins=None) -> dict:
    """The numbers compared at each tolerance, each sampled solve's gap, and
    the float32 twins' gaps where the check read them."""
    tols = (0.0,) + READ_TOLS
    return {"values": {repr(t): compare.numbers(solves, outs, judged, t, twins) for t in tols},
            "twins": {str(i): d for i, d in sorted((twins or {}).items())},
            "gaps": {str(i): [compare.gaps(solves, {i: o}, judged, t)[i] for t in tols]
                     for i, o in sorted(outs.items())},
            "branches": {str(i): [[list(leaf.picks), leaf.need, leaf.recovery]
                                  for leaf in o.leaves] for i, o in sorted(outs.items())}}


def _control(cell, solves, sample, dev, ref, ref64, tf32: bool):
    """The reference `ref` in the program's place, judged against `ref64`."""
    _, outs, _ = compare.check(cell, solves, sample, dev, ref=ref, tf32=tf32, branch_tols=None,
                               tol=0.0, twins=False)
    answers = {i: o.leaves[0] for i, o in outs.items()}
    _, outs64, twins = compare.check(cell, solves, sample, dev, ref=ref64, judged=answers,
                                     branch_tols=READ_TOLS, tol=max(READ_TOLS))
    return _readings(solves, outs64, answers, twins)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--solves", type=int, default=None)
    p.add_argument("--at", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(harness.load_benchmark(ROOT), args.workload)
    driver = cell.driver()
    program = driver.Program(cell, t_start=T_START)
    driver.warm_up(program, cell.traffic)
    dev = program.device
    refs = {}
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    witness_seeds = {int(s) for s in args.witness_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            run, _ = driver.window(program, cell.traffic, seed, args.seconds,
                                   n_solves=args.solves)
            row = {"workload": args.workload, "seed": seed,
                   "metrics": harness.read_metrics(cell, cell.end_to_end(), run)}
            if args.at:
                at = [int(i) for i in args.at.split(",")]
                sample = sorted({j for i in at for j in (i - 1, i) if 0 <= j < len(run.solves)})
            else:
                sample = compare.choose_sample(run.solves, cell.traffic["check_solves"], seed)
            t0 = time.perf_counter()
            if not refs:   # built after the first window, which they would slow
                refs[64] = compare.reference_for(cell, dev, torch.float64)
                refs[32] = compare.reference_for(cell, dev, torch.float32)
            ref64, ref32 = refs[64], refs[32]
            _, outs64, twins = compare.check(cell, run.solves, sample, dev, ref=ref64,
                                             branch_tols=READ_TOLS, tol=max(READ_TOLS))
            row.update({"solves": len(run.solves), "window_s": run.window_s,
                        "reference_s": time.perf_counter() - t0,
                        "sample": [{"i": i, "episode": run.solves[i].episode,
                                    "step": run.solves[i].step,
                                    "iterations": run.solves[i].iterations,
                                    "recovery": run.solves[i].recovery,
                                    "program": [run.solves[i].step_size, run.solves[i].g_norm]}
                                   for i in sample],
                        "program": _readings(run.solves, outs64, twins=twins)})
            if seed in control_seeds:
                t0 = time.perf_counter()
                row["control_tf32"] = _control(cell, run.solves, sample, dev, ref32, ref64, True)
                row["control_s"] = time.perf_counter() - t0
            if seed in witness_seeds:
                row["reference_f32"] = _control(cell, run.solves, sample, dev, ref32, ref64,
                                                False)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    found = harness.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
