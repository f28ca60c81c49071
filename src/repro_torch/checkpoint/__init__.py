"""Checkpoints of the port: the reference's atomic manifest layout."""
