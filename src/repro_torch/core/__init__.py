"""Channel models, theory and the Monte Carlo engine (port of `repro.core`)."""
