"""Helpers the port shares across its modules."""
