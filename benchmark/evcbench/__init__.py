"""The benchmark harness of xeve_tpu_torch (see benchmark/run.py)."""
