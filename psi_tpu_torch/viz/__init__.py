"""Visualization: the software renderer, the mesh viewer and the result
renderer (port of psi_tpu.viz; ``viz/sphere.py`` is not ported yet)."""
