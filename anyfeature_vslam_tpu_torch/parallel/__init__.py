"""Bundle adjustment spread over the ranks of a torch.distributed process
group (port of anyfeature_vslam_tpu/parallel)."""
