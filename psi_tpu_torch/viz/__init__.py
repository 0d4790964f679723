"""Visualization: the software renderer, the mesh viewer, the result
renderer and the icosphere helpers (port of psi_tpu.viz)."""
