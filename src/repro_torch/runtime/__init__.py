"""Runtime of the port: the sequential co-inference engine,
continuous-batching decode over a quantized KV cache, and the training
loop."""

from .decode_engine import (ClassDecodeStats, DecodeEngine,  # noqa: F401
                            DecodeReport, DecodeRequest, DecodeResponse,
                            fit_kv_lambda, greedy_decode_reference)
from .serve_engine import (CodesignCache, CoInferenceEngine,  # noqa: F401
                           QosClass, ServeStats, fit_lambda)
from .train_loop import TrainConfig, Trainer  # noqa: F401
