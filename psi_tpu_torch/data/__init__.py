"""Synthetic scenes and asset bundles."""
