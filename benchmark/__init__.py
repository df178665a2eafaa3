"""The benchmark of moco_tpu_torch (see benchmark/run.py)."""
