"""Data pipeline of the port: the synthetic Markov LM data and the loader
that places its batches on the device."""

from .loader import ShardedLoader  # noqa: F401
from .synthetic import MarkovLMConfig, MarkovLMDataset  # noqa: F401
