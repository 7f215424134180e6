"""Frozen copy of the port's models (see ../__init__.py)."""
