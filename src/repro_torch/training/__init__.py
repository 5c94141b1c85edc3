"""Training (port of `repro.training`): the train step over the MAC and
the host loop."""
