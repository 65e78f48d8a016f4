"""Data sets of the port (numpy generators)."""
