"""Sampling networks: ResNet trunk, scene encoder, HumanCVAES1."""
