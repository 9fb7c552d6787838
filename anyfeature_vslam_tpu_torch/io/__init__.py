"""Sequence input and trajectory output (port of anyfeature_vslam_tpu/io)."""
