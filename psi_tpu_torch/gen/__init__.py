"""Body generation from a scene snapshot."""
