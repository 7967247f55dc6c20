"""Evaluation helpers (port of parts of `ccgp_tpu/eval`)."""
