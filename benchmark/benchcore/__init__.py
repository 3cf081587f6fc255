"""The benchmark harness of ocrl_tpu_torch (see main.py)."""
