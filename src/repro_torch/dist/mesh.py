"""Device layouts: flat device axis <-> Swapped Dragonfly coordinates.

A ``DeviceLayout`` pins device index i of a 1-D mesh axis to router
``topo.id_router(i)`` (the c·M²+d·M+p linear order). Everything the paper's
algorithms need at runtime hangs off it: the doubly-parallel all-to-all
parameters (s = gcd(K, M) — the largest legal disagreeable-array stride)
and, when K and M are powers of two, the SBH hypercube view for ascend-
descend all-reduce.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.alltoall import DAParams
from repro_torch.core.emulation import Embedding, embed
from repro_torch.core.hypercube import SBH
from repro_torch.core.topology import D3


@dataclasses.dataclass(frozen=True)
class DeviceLayout:
    """A D3 view of a flat device axis."""

    topo: D3

    @property
    def n(self) -> int:
        return self.topo.num_routers

    @property
    def da_params(self) -> DAParams:
        s = math.gcd(self.topo.K, self.topo.M)
        return DAParams(self.topo.K, self.topo.M, s)

    @property
    def sbh(self) -> SBH | None:
        k = self.topo.K.bit_length() - 1
        m = self.topo.M.bit_length() - 1
        if (1 << k) == self.topo.K and (1 << m) == self.topo.M:
            return SBH(k, m)
        return None

    def embed_onto(self, host: "DeviceLayout | D3", c_set=None, p_set=None) -> Embedding:
        """Property-2 embedding of THIS layout (as guest) into ``host``.

        The returned ``Embedding`` is what ``dist.collectives`` and
        ``runtime.rewrite.emulate`` take to run this layout's collectives
        guest-sized on the host's (larger) mesh axis. Defaults to the
        canonical prefix subsets; pass ``c_set``/``p_set`` for survivor
        sets (elastic failover)."""
        host_topo = host.topo if isinstance(host, DeviceLayout) else host
        return embed(host_topo, self.topo.K, self.topo.M, c_set=c_set, p_set=p_set)


def dragonfly_layout(n: int) -> DeviceLayout:
    """Factor an n-device axis as D3(K, M) with n = K·M².

    Among legal factorizations with K ≥ 2 and M ≥ 2 we pick the most
    balanced (minimal |K − M|, ties to larger M): 16 -> (4,2), 64 -> (4,4),
    256 -> (4,8), 512 -> (8,8). Falls back to the degenerate D3(n, 1) when
    no square factor exists (prime counts)."""
    best: tuple[int, int] | None = None
    for M in range(2, int(math.isqrt(n)) + 1):
        if n % (M * M):
            continue
        K = n // (M * M)
        if K < 2:
            continue
        if best is None or (abs(K - M), -M) < (abs(best[0] - best[1]), -best[1]):
            best = (K, M)
    if best is None:
        best = (n, 1)
    return DeviceLayout(D3(*best))
