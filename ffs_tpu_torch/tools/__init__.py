"""Measurement entry points of the port (counterparts of the JAX package's
``tools/measure_stages.py`` and ``tools/measure_window_gather.py``), run as
``python -m ffs_tpu_torch.tools.<name>`` on the device ``select_device()``
gives."""
