"""The benchmark of ``intmax_zkp_core_tpu_torch`` on NVIDIA GPUs: one cell a
run (``run.py``), everything found by name under this folder."""
