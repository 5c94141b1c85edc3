"""Serving (port of `repro.serving`): the batched prefill + decode
engine."""
