"""Placement of the training state over a mesh of ranks: the
reference's logical-axis sharding rules (``repro/parallel``)."""
