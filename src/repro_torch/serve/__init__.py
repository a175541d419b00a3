"""Serving substrate: the batched decode engine with continuous batching,
and the multi-tenant fleet (``serve.fleet``)."""

from repro_torch.serve.engine import Engine, Request

__all__ = ["Engine", "Request"]
