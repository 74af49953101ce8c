"""Serving runtime of the port (the sequential co-inference engine)."""

from .serve_engine import (CoInferenceEngine, QosClass,  # noqa: F401
                           ServeStats, fit_lambda)
