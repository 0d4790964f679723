from psi_tpu_torch.serve.engine import GenerationEngine, ServeResult, ServingQueue, ServingRouter

__all__ = ["GenerationEngine", "ServeResult", "ServingQueue", "ServingRouter"]
