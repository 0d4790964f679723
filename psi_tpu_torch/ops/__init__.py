"""Scene ops: fused skinning and chamfer NN (CUDA kernels with plain twins), packed SDF, pruning."""
