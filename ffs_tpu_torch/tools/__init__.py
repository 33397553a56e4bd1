"""Measurement entry points of the port (counterparts of the repo's
``tools/measure_stages.py``, ``tools/measure_window_gather.py`` and
``tools/ssx_adversarial.py``), run as ``python -m ffs_tpu_torch.tools.<name>``
on the device ``select_device()`` gives."""
