"""The scene-asset bundle shared by fitting (training is not ported yet)."""
