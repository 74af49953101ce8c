"""Tree checkpoints with an integrity manifest and an async writer, in a
framing of the standard library (``repro/checkpoint``)."""

from .store import (CheckpointManager, CorruptCheckpointError,  # noqa: F401
                    available_steps, latest_step, load_tree, save_tree,
                    snapshot_tree, tree_records)
