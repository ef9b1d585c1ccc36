"""Functional classification kernels (multiclass so far)."""
