"""Utilities: reference-keyed weight loading."""
