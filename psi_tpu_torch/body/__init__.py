"""SMPL-X body model, LBS, VPoser and the body-vector decode."""
