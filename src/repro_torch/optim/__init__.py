"""Optimizer, schedules and gradient compression of the training loop
(``repro/optim``), in float32 torch."""

from .adamw import (AdamW, AdamWState, cosine_schedule,  # noqa: F401
                    global_norm, linear_schedule)
from .grad_compress import (compress_tree, compression_ratio,  # noqa: F401
                            init_error_state)
