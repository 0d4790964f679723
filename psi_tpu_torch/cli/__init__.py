"""Command-line entry points of the port, run as ``python -m psi_tpu_torch.cli.<name>``."""
