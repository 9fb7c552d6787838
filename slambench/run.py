"""The benchmark of anyfeature_vslam_tpu_torch on one NVIDIA GPU.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints the host's CPU count and the parts
of set-up on standard error, then every number compared with its limit,
and as the last line of standard output one JSON object: ``correct``,
``attempted`` (frames handed over in the window), ``failed`` (those that
never got a pose), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. Exits non-zero and prints no result
when there is no CUDA device, too few of them, or a module of JAX or the
JAX package is loaded once the window has closed.

The process's thread pools are pinned to ``settings.json``'s count before
torch is imported, and every build or kernel cache goes inside the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def pin_environment() -> int:
    """Pin the thread pools and put every cache inside the checkout; call
    before torch is imported."""
    with open(HERE / "settings.json") as f:
        n = str(json.load(f)["cpu_threads"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = n
    cache = ROOT / ".slambench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    return int(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    threads = pin_environment()
    sys.path.insert(0, str(ROOT))
    print(f"[host] {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable; thread pools "
          f"pinned to {threads}", file=sys.stderr, flush=True)
    import torch

    from slambench import harness

    torch.set_num_threads(threads)
    torch.set_num_interop_threads(1)
    t_proc0 = time.perf_counter() - harness.process_age_s()
    spec = harness.load_cell(args.workload)
    cell = spec["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                             device="cuda", setup_t0=t_proc0)
    except harness.RunError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    line = harness.result_line(result, int(cell["chips"]))
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr, flush=True)
    print(harness.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
