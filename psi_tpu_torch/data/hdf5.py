"""The PROX scene names, as ``psi_tpu.data.hdf5`` lists them.

Only the constants: the HDF5 batch generators of that module are not ported yet.
"""

PROX_SCENES = [
    "BasementSittingBooth", "MPH1Library", "MPH8", "MPH11", "MPH16",
    "MPH112", "N0SittingBooth", "N0Sofa", "N3Library", "N3Office",
    "N3OpenArea", "Werkraum",
]
