"""Training: the objective, the step, TrainOP and its checkpoints (port of psi_tpu.train)."""
