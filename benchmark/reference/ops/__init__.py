"""Frozen copy of the port's ops (see ../__init__.py)."""
