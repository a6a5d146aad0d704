"""Costate recursions."""
