"""Guest-view scatter/gather: move guest-sized arrays in and out of the
host-sized device axis of an emulated (``active_devices``) program.

The reference backend's ``run_matmul`` routes every program through these;
for native programs both are the identity. The emulation pass itself
(``emulate`` / ``emulate_schedule``, Property 2) comes with the emulation
slice of the port, and so do emulated programs: until then every program
the port lowers is native.

Pure NumPy, no torch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.runtime.program import CollectiveProgram


def scatter_guest(x: np.ndarray, program: CollectiveProgram, *, axes=(0,),
                  fill=0) -> np.ndarray:
    """Embed guest-sized array ``x`` into the rewritten program's host axis.

    Each listed axis of length ``guest_n`` becomes a host axis of length
    ``n`` with guest slice g landing at host index ``active_devices[g]``
    and idle slots holding ``fill``. Identity for native programs.
    """
    if program.active_devices is None:
        return np.asarray(x)
    out = np.asarray(x)
    idx = program.active_np
    for ax in axes:
        if out.shape[ax] != program.guest_n:
            raise ValueError(
                f"axis {ax} has {out.shape[ax]} slots, guest has {program.guest_n}"
            )
        shape = list(out.shape)
        shape[ax] = program.n
        host = np.full(shape, fill, out.dtype)
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        host[tuple(sel)] = out
        out = host
    return out


def gather_guest(x: np.ndarray, program: CollectiveProgram, *, axes=(0,)) -> np.ndarray:
    """Project the rewritten program's host axis back to the guest view —
    the inverse of ``scatter_guest`` (idle slots are dropped)."""
    if program.active_devices is None:
        return np.asarray(x)
    out = np.asarray(x)
    idx = program.active_np
    for ax in axes:
        if out.shape[ax] != program.n:
            raise ValueError(
                f"axis {ax} has {out.shape[ax]} slots, host has {program.n}"
            )
        sel = [slice(None)] * out.ndim
        sel[ax] = idx
        out = out[tuple(sel)]
    return out
