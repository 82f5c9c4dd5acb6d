#!/usr/bin/env python3
"""Read the numbers ``correct`` compares for several seeds, the program's
and the control's, at a cell's own size (on the card).

    python3 benchmark/control.py --workload replica_680x1200.orbit \\
        --seconds 30 --seeds 11 12 13

Each seed is one run of ``benchmark/run.py`` (its set-up, a window long
enough for the first session, the comparison); after it the same outputs
are read again with the control in the program's place: the reference
computed with its products' inputs rounded to TF32, one precision below the
float32 the configurations state, and judged against the cell's limits
(``correct`` has to come out false).  Prints one JSON line per seed (the
program's readings, the control's and the control's verdict), one per
planted fault (``--faults``, ``faults.py``) and a summary: per number the
smallest and largest reading of the program and of the control over the
seeds, from which ``PERF.md`` sets each limit.  The benchmark's own runs
never run the control.
"""

import argparse
import io
import json
import os
import sys
from contextlib import redirect_stderr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--faults", nargs="*", default=[],
                   help="also run each seed with each of these faults planted "
                        "(faults.py) and print their readings")
    opts = p.parse_args(argv)
    import faults
    import run

    spans = {"program": {}, "control": {}}

    def note(side, readings):
        for k, v in readings.items():
            if v is not None:
                lo, hi = spans[side].get(k, (v, v))
                spans[side][k] = (min(lo, v), max(hi, v))

    def control_lines(argv, controls):
        err = io.StringIO()
        with redirect_stderr(err):
            rc = run.main(argv, controls=controls)
        lines = [json.loads(x[len("[control] "):]) for x in err.getvalue().splitlines()
                 if x.startswith("[control] ")]
        return rc, lines, err.getvalue()

    for seed in opts.seeds:
        argv = ["--workload", opts.workload, "--seed", str(seed),
                "--seconds", str(opts.seconds), "--trace", str(opts.trace)]
        rc, lines, err = control_lines(argv, ("tf32",))
        if rc != 0 or not lines:
            sys.stdout.write(err[-4000:])
            print(json.dumps({"seed": seed, "rc": rc, "error": "no readings"}), flush=True)
            continue
        rec = lines[0]
        print(json.dumps(rec), flush=True)
        note("program", rec["program"])
        note("control", rec["readings"])
        for name in opts.faults:
            with faults.FAULTS[name]():
                _, got, _ = control_lines(argv[:-1] + ["0"], ("none",))
            print(json.dumps({"fault": name, "seed": seed,
                              "correct": got[0]["correct"] if got else None,
                              "failed": got[0]["failed"] if got else None,
                              "readings": got[0]["program"] if got else None}),
                  flush=True)
    print(json.dumps({"workload": opts.workload, "seeds": opts.seeds,
                      "program_min_max": spans["program"],
                      "control_min_max": spans["control"]}), flush=True)


if __name__ == "__main__":
    main()
