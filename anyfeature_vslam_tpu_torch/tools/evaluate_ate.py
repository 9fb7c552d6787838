"""ATE evaluation CLI: Sim3-align an estimated trajectory to ground truth
and print the RMSE (the VSLAM-LAB scoring the reference relies on,
reference README.md:19). Port of tools/evaluate_ate.py on the port's
io/evaluation.py (host numpy, no device).

    python -m anyfeature_vslam_tpu_torch.tools.evaluate_ate \\
        est:<trajectory.csv|tum.txt> gt:<gt_tum.txt> [max_diff:0.02]

Prints one JSON line: {"ate_rmse": ..., "n_pairs": ..., "scale": ...}
"""

import json
import sys

from ..run_mono import parse_args


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if "est" not in args or "gt" not in args:
        print(__doc__)
        return 1
    from ..io import evaluation

    out = evaluation.evaluate(args["est"], args["gt"],
                              max_diff=float(args.get("max_diff", 0.02)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
