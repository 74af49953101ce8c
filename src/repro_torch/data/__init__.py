"""Data pipeline of the port: the synthetic Markov LM and caption-proxy
data and the loader that places batches on the device."""

from .loader import ShardedLoader  # noqa: F401
from .synthetic import (CaptionProxyConfig, CaptionProxyDataset,  # noqa: F401
                        MarkovLMConfig, MarkovLMDataset)
