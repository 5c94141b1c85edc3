"""Checkpoints of nested tensors and arrays (port of `repro.checkpoint`)."""
