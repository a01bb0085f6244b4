"""The benchmark of alphafive_tpu_torch on one NVIDIA H100 (see README.md)."""
