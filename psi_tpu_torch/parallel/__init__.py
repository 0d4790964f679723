from psi_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate"]
