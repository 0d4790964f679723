"""Scene-aware fitting (inference-time Adam over body vectors)."""
