"""Runtime of the port: the sequential and batched co-inference engines
and their compiled forward, continuous-batching decode over a quantized KV
cache, and the training loop."""

from .decode_engine import (ClassDecodeStats, DecodeEngine,  # noqa: F401
                            DecodeReport, DecodeRequest, DecodeResponse,
                            fit_kv_lambda, greedy_decode_reference)
from .fastpath import CompiledForwardCache  # noqa: F401
from .serve_engine import (BatchedCoInferenceEngine,  # noqa: F401
                           BatchStats, CodesignCache, CoInferenceEngine,
                           EngineReport, QosClass, RequestStats,
                           ServeRequest, ServeResponse, ServeStats,
                           fit_lambda)
from .train_loop import TrainConfig, Trainer  # noqa: F401
