"""Runtime: Schedule IR -> one backend-neutral program -> pluggable backends.

``lowering.lower(schedule)`` turns any ``core.schedule.Schedule`` — all four
of the paper's algorithms — into a ``program.CollectiveProgram``;
``optimize.optimize`` fuses it into table ops; ``backends.get_backend``
replays it (``reference``: NumPy on the host; ``cuda_fused``: torch on the
card with CUDA kernels on the hot spots; ``auto``: whichever strategy the
autotuner, ``autotune``, finds cheapest). The contract every backend keeps
is in ``backends/__init__.py``.

Autotuner guarantees (``autotune.Autotuner`` / the ``auto`` backend)
---------------------------------------------------------------------
The dispatcher that turns the coexisting execution strategies into one
fast default path. Per call site — keyed on ``(kind, D3 topology,
bucketed message bytes, dtype, site)`` — it picks the cheapest of the
strategies structurally available there (per-stage ``loop`` replay on
``torch_dist``, ``start_step``-ordered ``overlap``, the fused
``optimize()`` tables in plain torch, the ``cuda_fused`` backend, the
device-free ``sendrecv`` trace replay, or the ``native``
``torch.distributed`` collective), seeded by ``core.costmodel`` analytic
prices and calibrated by one-shot measured timings memoized in a
schema-versioned on-disk cache tagged with the device it was measured
on. What it preserves:

  * **bit-exactness is free** — every candidate strategy satisfies the
    backend contract above, so switching strategies can never change a
    result, only its latency; emulated (``active_devices``) programs
    additionally exclude ``native`` (the group's collective would mix idle
    ranks);
  * **determinism** — a warm cache returns the recorded decision without
    re-measurement; a corrupt or missing cache, or one measured on another
    device, degrades to analytic seeding without error;
  * **one decision per group** — the ranks of a process group that decide
    a key together (shard sites, the fleet's combined site) read the
    cache through their first rank, time the same candidates in the same
    order and rank the slowest rank's times, so they issue the same
    collectives;
  * **escape hatches** — ``REPRO_TORCH_AUTOTUNE=analytic`` (rank without
    measuring), ``REPRO_TORCH_AUTOTUNE=off`` (pre-autotuner defaults), or
    ``REPRO_TORCH_AUTOTUNE=<strategy>`` (pin one strategy), and
    ``REPRO_TORCH_AUTOTUNE_CACHE`` (the file) — the same knobs the
    ``Autotuner`` constructor takes programmatically.

Importing this package imports none of its modules and builds no kernel.
"""
