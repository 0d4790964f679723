from psi_tpu_torch.eval.collision import collision_contact_scores
from psi_tpu_torch.eval.diversity import diversity_metrics, kmeans

__all__ = ["kmeans", "diversity_metrics", "collision_contact_scores"]
