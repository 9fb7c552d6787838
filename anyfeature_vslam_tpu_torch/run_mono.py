"""CLI: monocular SLAM over a sequence directory with the torch port, in the
reference binary's ``key:value`` argument style (reference
src/vslamlab_anyfeature_mono.cpp:47-109):

    python -m anyfeature_vslam_tpu_torch.run_mono \\
        sequence_path:/path/to/seq feature:orb32 exp_folder:/tmp/out \\
        exp_id:exp01 max_frames:100 verbose:1 device:cuda

Runs on the card unless ``device:cpu`` is given. ``vocabulary_folder:``
names a folder to take the feature's vocabulary from; without it the
shipped one is used. Reading PNG frames needs
PIL.
"""

from __future__ import annotations

import sys


def parse_args(argv):
    out = {}
    for a in argv:
        if ":" in a:
            k, v = a.split(":", 1)
            out[k] = v
    return out


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    seq_path = args.get("sequence_path")
    if not seq_path:
        print(__doc__)
        return 1
    import numpy as np

    from .system import run_sequence

    system = run_sequence(
        seq_path,
        feature=args.get("feature", "orb32"),
        out_dir=args.get("exp_folder", "."),
        exp_id=args.get("exp_id", "exp"),
        max_frames=int(args["max_frames"]) if "max_frames" in args else None,
        verbose=args.get("verbose", "1") not in ("0", "false"),
        calibration_yaml=args.get("calibration_yaml"),
        rgb_csv=args.get("rgb_csv"),
        feature_yaml=args.get("feature_yaml"),
        vocabulary_folder=args.get("vocabulary_folder"),
        pace=args.get("pace", "0") not in ("0", "false"),
        n_features=int(args["n_features"]) if "n_features" in args else None,
        device=args.get("device", "cuda"),
    )
    if system.frame_times:
        print(f"median tracking time: {np.median(system.frame_times) * 1e3:.1f} ms, "
              f"mean: {np.mean(system.frame_times) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
