"""Space-filling designs (port of parts of `ccgp_tpu/design`)."""
