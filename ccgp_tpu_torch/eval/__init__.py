"""Evaluation helpers (port of `ccgp_tpu/eval`: the test functions, the
comparison summary and the reference data loaders)."""
