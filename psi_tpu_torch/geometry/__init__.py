"""Rotation, body-vector, camera and contact-id geometry."""
