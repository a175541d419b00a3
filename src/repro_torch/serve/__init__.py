"""Serving substrate: the batched decode engine with continuous batching.
The multi-tenant fleet waits for a later slice."""

from repro_torch.serve.engine import Engine, Request

__all__ = ["Engine", "Request"]
