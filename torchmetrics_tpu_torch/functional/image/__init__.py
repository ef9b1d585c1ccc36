"""Functional image helpers."""
