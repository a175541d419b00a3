"""Runtime: Schedule IR -> one backend-neutral program -> pluggable backends.

``lowering.lower(schedule)`` turns any ``core.schedule.Schedule`` — all four
of the paper's algorithms — into a ``program.CollectiveProgram``;
``optimize.optimize`` fuses it into table ops; ``backends.get_backend``
replays it (``reference``: NumPy on the host; ``cuda_fused``: torch on the
card with CUDA kernels on the hot spots). The contract every backend keeps
is in ``backends/__init__.py``.

Importing this package imports none of its modules and builds no kernel.
"""
