"""The offline tools of the PyTorch port (counterparts of the repo's
tools/*.py for the JAX package): each module is ``main(argv)``, run as
``python -m anyfeature_vslam_tpu_torch.tools.<name> key:value ...``, with
the JAX tool's argument names, defaults and printed lines. The tools that
run the port's modules take ``device:`` (default ``cuda``)."""
