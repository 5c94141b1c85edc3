"""Model configurations (port of `repro.configs`): the `ModelConfig`
dataclass and the architectures this slice serves."""
