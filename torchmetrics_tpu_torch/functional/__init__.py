"""Functional kernels of the port."""
