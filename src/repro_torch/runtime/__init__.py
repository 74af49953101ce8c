"""Runtime of the port: the sequential and batched co-inference engines
and their compiled forward, adaptive serving under a dynamic environment,
multi-agent fleet serving, continuous-batching and speculative decode over
a quantized KV cache, fault-supervised serving, and the training loop with
its checkpoint/restart supervisor."""

from .adaptive import (AdaptiveCoInferenceEngine, AdaptiveReport,  # noqa: F401
                       ReplanEvent)
from .decode_engine import (ClassDecodeStats, DecodeEngine,  # noqa: F401
                            DecodeReport, DecodeRequest, DecodeResponse,
                            fit_kv_lambda, greedy_decode_reference)
from .fastpath import CompiledForwardCache  # noqa: F401
from .fault_tolerance import (HostFailure, HostSet, StragglerMonitor,  # noqa: F401
                              Supervisor, SupervisorReport, survivor_mesh)
from .fleet_engine import (AgentServeStats, FleetAgentSpec,  # noqa: F401
                           FleetCoInferenceEngine, FleetReport)
from .serve_engine import (BatchedCoInferenceEngine,  # noqa: F401
                           BatchStats, CodesignCache, CoInferenceEngine,
                           EngineReport, QosClass, RequestStats,
                           ServeRequest, ServeResponse, ServeStats,
                           fit_lambda)
from .speculative import (SpecRoundStats,  # noqa: F401
                          SpeculativeDecodeEngine)
from .supervisor import (ResilienceReport, ServingSupervisor,  # noqa: F401
                         flip_bit, payload_checksum)
from .train_loop import TrainConfig, Trainer  # noqa: F401
