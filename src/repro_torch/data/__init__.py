from .synthetic import MarkovLMConfig, MarkovLMDataset  # noqa: F401
