"""The benchmark of ``gparml_tpu_torch`` on an NVIDIA H100 (see ``run.py``)."""
