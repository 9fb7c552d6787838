"""The benchmark of anyfeature_vslam_tpu_torch: ``python3 slambench/run.py``
(see run.py). Configurations, traffic mixes, limits and per-layer metric
readers are files of their own, found by the names in BENCHMARK.json."""
