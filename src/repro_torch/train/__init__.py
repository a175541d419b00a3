"""Training substrate. Ported so far: fault tolerance (``fault_tolerance``:
the failover library, the multi-tenant cluster and the straggler policy).
The optimizer, train step, checkpointing, data pipeline, compression and
elastic trainer wait for ROADMAP Queue 1 item 5."""
