"""Configuration and weight conversion."""
