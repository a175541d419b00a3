"""Backend-neutral ``CollectiveProgram`` — the one lowered representation.

``runtime.lowering.lower`` turns any ``core.schedule.Schedule`` into a
``CollectiveProgram``: an ordered tuple of primitive *stages*, each stamped
with the IR round and hop step it came from plus a ``start_step`` (the
global launch step under pipelined replay) so pipelined schedules survive
lowering. Backends (``runtime.backends``) replay the same program on
different substrates — torch table replays with CUDA kernels on the card,
a pure-NumPy host replay —
without knowing which of the paper's four algorithms produced it.

Stage primitives
----------------
``Perm``           full device permutation: device i sends its value to
                   ``sigma[i]`` (one device permute on a per-stage backend).
``Match``          partial permutation (a matching): listed destinations
                   replace their value with the sender's; everyone else
                   keeps theirs. Identity pairs are elided at build time.
``ReduceCombine``  matching whose destinations *combine* the incoming value
                   into an accumulator (``acc[d] ⊕= val[s]``). Identity
                   pairs (s == d) are legal and mean a local contribution —
                   no link is used, the paper's "off-and-on" compute event.
``LocalContract``  no communication: a named local compute step the backend
                   applies between hops (block product, accumulator
                   promotion, masked output store, ...).

Synchronous-step semantics: stages sharing one ``(round_index, step)`` group
read the *pre-step* values and their writes land together — the paper's
model where all of a hop-step's packets are in flight simultaneously. The
lowering guarantees write targets are distinct within each stage (the
link-conflict-freedom ``core.simulator.verify`` proved, projected onto
devices); across the stages of one group only ``ReduceCombine``
destinations may repeat, and their commutative combine is why group replay
order still cannot change results.

Programs are host-retargetable: ``runtime.rewrite.emulate`` relabels a
guest D3(J,L) program through a Property-2 embedding into a D3(K,M)-sized
program whose ``active_devices`` names the participating host devices (in
guest order); every other device is idle and passes through. Backends honor
the mask per the contract in ``runtime/__init__.py``.

Everything here is pure Python over hashable data — programs can be cached
per (topology, schedule) key and shared across jit traces. Per-stage NumPy
index arrays are materialized once via ``cached_property`` so re-traces
reuse them instead of rebuilding host arrays inside every trace.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

Pairs = tuple[tuple[int, int], ...]

#: program kinds — what the stages collectively compute
KINDS = ("alltoall", "allreduce", "broadcast", "matmul")

#: LocalContract vocabulary (the backend contract; see runtime/__init__.py)
LOCAL_FNS = ("load_b", "mul_a", "promote", "store_c")


@dataclasses.dataclass(frozen=True)
class Perm:
    """Permutation over device ids: device i sends to ``sigma[i]``.

    ``n`` (default 0 = ``len(pairs)``) is the device count the permutation
    acts over. With ``n > len(pairs)`` the stage is a *partial* permutation
    — a bijection on the subset of devices named in ``pairs`` with every
    other device an implicit fixed point that neither sends nor receives.
    The emulation rewrite (``runtime.rewrite``) produces these: a guest
    program's full permutations become host-sized partial permutations over
    the embedded device subset.
    """

    pairs: Pairs
    round_index: int = 0
    step: int = 0
    start_step: int = 0
    n: int = 0

    def __post_init__(self) -> None:
        srcs = {s for s, _ in self.pairs}
        dsts = {d for _, d in self.pairs}
        if len(srcs) != len(self.pairs) or dsts != srcs:
            raise ValueError("Perm pairs must form a permutation")
        if self.n and srcs and (min(srcs) < 0 or max(srcs) >= self.n):
            raise ValueError(f"Perm pairs exceed n={self.n}")
        if not self.n and srcs != set(range(len(self.pairs))):
            raise ValueError("full Perm must cover device ids 0..len(pairs)-1")

    @cached_property
    def size(self) -> int:
        """Device count the permutation acts over (= program n)."""
        return self.n or len(self.pairs)

    @cached_property
    def is_partial(self) -> bool:
        return len(self.pairs) < self.size

    @cached_property
    def sigma(self) -> tuple[int, ...]:
        out = list(range(self.size))  # implicit fixed points stay in place
        for s, d in self.pairs:
            out[s] = d
        return tuple(out)

    @cached_property
    def inverse(self) -> tuple[int, ...]:
        out = list(range(self.size))
        for s, d in self.pairs:
            out[d] = s
        return tuple(out)

    @cached_property
    def sigma_np(self) -> np.ndarray:
        return np.asarray(self.sigma, np.int32)

    @cached_property
    def inverse_np(self) -> np.ndarray:
        return np.asarray(self.inverse, np.int32)

    @cached_property
    def src_np(self) -> np.ndarray:
        """Explicit senders only (the pairs), for partial-perm replay."""
        return np.asarray([s for s, _ in self.pairs], np.int32)

    @cached_property
    def dst_np(self) -> np.ndarray:
        return np.asarray([d for _, d in self.pairs], np.int32)


@dataclasses.dataclass(frozen=True)
class Match:
    """Matching (partial permutation): destinations are masked in, everyone
    else keeps their value. Identity pairs must be elided by the builder."""

    n: int
    pairs: Pairs
    round_index: int = 0
    step: int = 0
    start_step: int = 0

    def __post_init__(self) -> None:
        if len({s for s, _ in self.pairs}) != len(self.pairs):
            raise ValueError("Match sources must be distinct")
        if len({d for _, d in self.pairs}) != len(self.pairs):
            raise ValueError("Match destinations must be distinct")
        if any(s == d for s, d in self.pairs):
            raise ValueError("Match pairs must not be identities (elide them)")

    @cached_property
    def dsts(self) -> tuple[int, ...]:
        return tuple(d for _, d in self.pairs)

    @cached_property
    def dst_mask_np(self) -> np.ndarray:
        mask = np.zeros(self.n, bool)
        mask[list(self.dsts)] = True
        return mask

    @cached_property
    def src_np(self) -> np.ndarray:
        return np.asarray([s for s, _ in self.pairs], np.int32)

    @cached_property
    def dst_np(self) -> np.ndarray:
        return np.asarray(self.dsts, np.int32)


@dataclasses.dataclass(frozen=True)
class ReduceCombine:
    """Matching whose receivers combine the arrival into an accumulator:
    ``acc[d] ⊕= val[s]``. Identity pairs (s == d) are local contributions —
    the sender's own value joins its accumulator without touching a link."""

    n: int
    pairs: Pairs
    combine: str = "add"
    round_index: int = 0
    step: int = 0
    start_step: int = 0

    def __post_init__(self) -> None:
        if self.combine != "add":
            raise ValueError(f"unsupported combine {self.combine!r}")
        if len({s for s, _ in self.pairs}) != len(self.pairs):
            raise ValueError("ReduceCombine sources must be distinct")
        if len({d for _, d in self.pairs}) != len(self.pairs):
            raise ValueError("ReduceCombine destinations must be distinct")

    @cached_property
    def link_pairs(self) -> Pairs:
        """The pairs that actually traverse links (s != d)."""
        return tuple((s, d) for s, d in self.pairs if s != d)

    @cached_property
    def self_mask_np(self) -> np.ndarray:
        mask = np.zeros(self.n, bool)
        mask[[s for s, d in self.pairs if s == d]] = True
        return mask

    @cached_property
    def dst_mask_np(self) -> np.ndarray:
        mask = np.zeros(self.n, bool)
        mask[[d for _, d in self.link_pairs]] = True
        return mask

    @cached_property
    def is_full_permutation(self) -> bool:
        srcs = {s for s, _ in self.pairs}
        return len(self.pairs) == self.n and srcs == {d for _, d in self.pairs}

    @cached_property
    def inverse_np(self) -> np.ndarray:
        """inverse[d] = s for full-permutation exchanges (allreduce rounds)."""
        if not self.is_full_permutation:
            raise ValueError("inverse only defined for full permutations")
        out = np.zeros(self.n, np.int32)
        for s, d in self.pairs:
            out[d] = s
        return out


@dataclasses.dataclass(frozen=True)
class LocalContract:
    """Named local compute stage (no communication). ``fn`` is one of
    ``LOCAL_FNS``; ``mask`` (device ids, over ``n`` devices) scopes
    ``store_c`` writes."""

    fn: str
    mask: tuple[int, ...] | None = None
    n: int = 0
    round_index: int = 0
    step: int = 0
    start_step: int = 0

    def __post_init__(self) -> None:
        if self.fn not in LOCAL_FNS:
            raise ValueError(f"unknown LocalContract fn {self.fn!r}")
        if self.mask is not None and not self.n:
            raise ValueError("masked LocalContract requires n")

    @cached_property
    def mask_np(self) -> np.ndarray:
        mask = np.zeros(self.n, bool)
        if self.mask is not None:
            mask[list(self.mask)] = True
        return mask


Stage = Perm | Match | ReduceCombine | LocalContract
COMM_STAGES = (Perm, Match, ReduceCombine)


def check_kind(program: "CollectiveProgram", kind: str) -> None:
    """Backend guard: the program must be of the expected ``kind``."""
    if program.kind != kind:
        raise ValueError(f"program is {program.kind!r}, expected {kind!r}")


@dataclasses.dataclass(frozen=True)
class CollectiveProgram:
    """One backend-retargetable lowered schedule.

    ``stages`` are in barrier replay order (round-major, step-minor);
    ``start_step`` stamps give the pipelined launch order — a stable sort by
    ``start_step`` is the overlapped replay, identical to program order for
    non-pipelined schedules.
    """

    kind: str
    n: int
    num_rounds: int
    stages: tuple[Stage, ...]
    root: int | None = None  # broadcast programs: root device id
    grid: tuple[int, int] | None = None  # matmul programs: (K, M) of the grid
    name: str = ""
    #: Emulated (guest-on-host) programs: the host device ids that
    #: participate, in GUEST id order — ``active_devices[g]`` is the host
    #: device emulating guest device g (``Embedding.device_map``). ``None``
    #: means every device participates (native programs). Devices outside
    #: the tuple are idle: backends must pass them through untouched, and
    #: the reference backend asserts they stay untouched.
    active_devices: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown program kind {self.kind!r}")
        if self.active_devices is not None:
            ids = self.active_devices
            if len(set(ids)) != len(ids) or len(ids) > self.n:
                raise ValueError("active_devices must be distinct device ids")
            if ids and (min(ids) < 0 or max(ids) >= self.n):
                raise ValueError(f"active_devices exceed n={self.n}")

    @property
    def guest_n(self) -> int:
        """Logical (guest) device count: ``n`` for native programs, the
        embedded subnetwork size for rewritten ones."""
        return self.n if self.active_devices is None else len(self.active_devices)

    @cached_property
    def active_np(self) -> np.ndarray:
        """Guest-ordered host ids (identity for native programs)."""
        if self.active_devices is None:
            return np.arange(self.n, dtype=np.int32)
        return np.asarray(self.active_devices, np.int32)

    @cached_property
    def active_mask_np(self) -> np.ndarray:
        """Boolean mask over the n devices: True = participates."""
        mask = np.zeros(self.n, bool)
        mask[self.active_np] = True
        return mask

    # ------------------------------------------------------------ structure
    @property
    def comm_stages(self) -> tuple[Stage, ...]:
        return tuple(s for s in self.stages if isinstance(s, COMM_STAGES))

    @property
    def num_permutes(self) -> int:
        """Communication stages = permutes a per-stage backend issues."""
        return len(self.comm_stages)

    def stages_of_round(self, i: int) -> tuple[Stage, ...]:
        return tuple(s for s in self.stages if s.round_index == i)

    @property
    def perm_rounds(self) -> tuple[tuple[Perm, ...], ...]:
        """Per-round Perm groups (the §3 all-to-all round structure)."""
        out: list[list[Perm]] = [[] for _ in range(self.num_rounds)]
        for s in self.stages:
            if isinstance(s, Perm):
                out[s.round_index].append(s)
        return tuple(tuple(r) for r in out)

    @property
    def max_start_step(self) -> int:
        return max((s.start_step for s in self.stages), default=0)

    def pipelined_stages(self) -> tuple[Stage, ...]:
        """Stages in overlapped (start_step) order — the launch order of
        pipelined replay. Stable, so barrier programs are unchanged."""
        return tuple(sorted(self.stages, key=lambda s: s.start_step))

    def step_groups(self, pipelined: bool = False):
        """Yield maximal runs of communication stages sharing one synchronous
        step (and the LocalContract singletons between them, in order).

        Barrier order groups by ``(round_index, step)``; pipelined order
        groups by ``start_step`` so overlapping rounds' stages launch
        together. Backends apply each group's sends against the pre-group
        values (see module docstring).
        """
        stages = self.pipelined_stages() if pipelined else self.stages
        key = (lambda s: s.start_step) if pipelined else (lambda s: (s.round_index, s.step))
        group: list[Stage] = []
        for st in stages:
            if isinstance(st, LocalContract):
                if group:
                    yield tuple(group)
                    group = []
                yield (st,)
            elif group and key(group[-1]) == key(st):
                group.append(st)
            else:
                if group:
                    yield tuple(group)
                group = [st]
        if group:
            yield tuple(group)
