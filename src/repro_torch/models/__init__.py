"""Models (port of `repro.models`): the dense decoder that serves
olmo-1b and repro-100m through the flash-attention kernel."""
