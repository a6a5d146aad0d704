"""Solvers: flat-mode IP Newton lanes and the streaming executor."""
