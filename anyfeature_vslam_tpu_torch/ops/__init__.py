"""ops layer of the PyTorch port (mirrors anyfeature_vslam_tpu/ops)."""
