"""Synthetic data generators (numpy; port of `repro.data`)."""
