"""Core library: the paper's contribution — Swapped Dragonfly topology,
source-vector routing, and the four algorithms with their conflict-free
round schedules, plus the simulator that verifies every claim."""

from repro_torch.core.topology import D3, Router
from repro_torch.core.routing import (
    Vector,
    SyncHeader,
    STAR,
    vector_for,
    vector_dest,
    vector_path,
)
from repro_torch.core.simulator import Simulator, check_vector_round, assert_conflict_free
from repro_torch.core.alltoall import DAParams, rounds, round_vectors, pipeline
from repro_torch.core.matmul import MatmulGrid, simulate_matmul, simulate_vector_matmul
from repro_torch.core.hypercube import SBH
from repro_torch.core.emulation import embed, largest_embeddable

__all__ = [
    "D3",
    "Router",
    "Vector",
    "SyncHeader",
    "STAR",
    "vector_for",
    "vector_dest",
    "vector_path",
    "Simulator",
    "check_vector_round",
    "assert_conflict_free",
    "DAParams",
    "rounds",
    "round_vectors",
    "pipeline",
    "MatmulGrid",
    "simulate_matmul",
    "simulate_vector_matmul",
    "SBH",
    "embed",
    "largest_embeddable",
]
