"""Fault-tolerant checkpoints in the reference package's format."""
