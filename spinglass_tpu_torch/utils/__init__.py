"""Utilities of the port: the exception taxonomy and checkpointing."""
