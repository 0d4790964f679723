"""Individual loss terms (port of psi_tpu.losses)."""
