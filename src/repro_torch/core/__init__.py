"""Softermax numerics on torch tensors."""
