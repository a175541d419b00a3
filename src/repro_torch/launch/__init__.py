"""Launchers: the serving launcher (single engine or multi-tenant fleet)
and the process groups of the per-shard path (``mesh``)."""
