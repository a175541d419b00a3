"""Launchers: the serving launcher (single-engine mode) and the process
groups of the per-shard path (``mesh``)."""
