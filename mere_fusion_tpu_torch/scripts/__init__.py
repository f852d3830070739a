"""Profiling entry points of the port, twins of the repository's scripts/."""
