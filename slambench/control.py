"""The readings that the limits of ``limits/<workload>.json`` are set from,
at the cell's own size on the card; the benchmark's own runs do not run
this.

    python3 slambench/control.py --workload <cell> --seconds <s> --seeds <n> ... \
        [--faults state_unchanged matches_altered descriptors_altered] [--fault-seeds 3]

For each seed, one run of the cell (a short window at the cell's load)
judged twice: the program's answers (the sound reading) and, in the
program's place, the reference worked out in bfloat16 (the control). For
each fault of faults.py and each of the first ``--fault-seeds`` seeds, one
run with the fault planted in the timed path. One JSON object per reading on standard output; a run
that raises is recorded as ``crashed`` (it gives no number, and has
failed).
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3, help="the first N seeds take the faults")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE.parent))
    from slambench.run import pin_environment

    threads = pin_environment()
    import torch

    from slambench import faults, harness

    torch.set_num_threads(threads)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload)

    def emit(kind, seed, checks=None, readings=None, error=None):
        line = dict(workload=args.workload, kind=kind, seed=seed)
        if checks is not None:
            line.update(correct=harness.passes(checks),
                        checks={k: v["value"] for k, v in checks.items()}, readings=readings)
        if error is not None:
            line.update(correct=False, crashed=error)
        print(json.dumps(line), flush=True)

    for kind in ["sound"] + list(args.faults):
        for seed in args.seeds if kind == "sound" else args.seeds[:args.fault_seeds]:
            try:
                res = harness.run(spec, seed, args.seconds, False, device="cuda",
                                  control=kind == "sound",
                                  tamper=None if kind == "sound" else faults.FAULTS[kind])
            except Exception as e:  # a reading that gives no number has failed
                traceback.print_exc()
                emit(kind, seed, error=f"{type(e).__name__}: {e}"[:300])
                continue
            emit(kind, seed, res["checks"], res["readings"])
            if kind == "sound":
                emit("control", seed, res["control_checks"], res["control_readings"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
