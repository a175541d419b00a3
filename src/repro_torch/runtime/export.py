"""Send/recv export: compile any ``CollectiveProgram`` to a per-device trace.

The port of ``repro.runtime.export``, pure Python. ``SCHEMA_VERSION``, the
op vocabulary and the JSON layout are the JAX package's, so a trace
exported by either package reads, validates and replays in the other, and
the two ``to_json`` of one program are the same bytes.

``export(program)`` serializes a lowered (or optimized, emulated, combined)
program into a :class:`DeviceTrace` — a versioned, JSON-serializable list
of primitive ops PER DEVICE, in the NCCL style (Basu et al. 2023): what
each rank sends, receives, reduces, copies, and contracts, in replay
order. This is the portable half of the collective compiler: any
runtime (or the pure-NumPy :class:`~repro_torch.runtime.backends.sendrecv.
SendRecvBackend`) can execute the paper's four algorithms from the trace
alone, without the Schedule IR or the program stages.

Op vocabulary (:data:`OPS`)
---------------------------
``send(peer, buf, slot, nbytes)``   ship this device's ``buf`` value (chunk
                                    ``slot`` for all-to-all, wave ``slot``
                                    for pipelined broadcast) to ``peer``.
``recv(peer, buf, slot)``           file the arrival from ``peer`` into
                                    ``buf``: replacing (``val``/``out``) or
                                    into the scratch ``tmp`` a following
                                    ``reduce`` consumes.
``reduce(buf, src)``                fold into the target: ``buf[dev] +=
                                    src`` where ``src`` is ``tmp`` (the
                                    just-received value) or ``val`` (the
                                    pre-group own value — the paper's
                                    off-and-on local contribution).
``copy(buf, src, slot)``            local move between named buffers
                                    (``val <- b``, ``acc <- zero``,
                                    ``c <- val``, and the all-to-all
                                    self-chunk ``out[slot] <- x[slot]``).
``contract(fn)``                    the §2 ``mul_a`` block product
                                    ``val <- val @ a`` on this device.

Replay contract
---------------
Ops carry a ``group`` id; groups replay sequentially and correspond to the
program's synchronous step groups (every ``ReduceCombine`` stage of an
allreduce is its own group — the hypercube exchanges are data-dependent
round to round). Within a group all ``send`` payloads read the PRE-group
buffer values; writes land in per-device op order. Each op also keeps the
IR ``(round_index, step)`` stamp and the ``start_step`` launch stamp, so
pipelined §3/§5 schedules export with their real overlap windows —
:meth:`DeviceTrace.waves` lists them — while replay stays barrier-ordered
(bit-identical by the IR's pipelined conflict-freedom).

``validate(trace)`` re-proves the two structural safety properties on the
EXPORTED form (not the IR it came from): link-conflict-freedom — at most
one send per directed link per synchronous ``(round_index, step)`` AND per
``start_step`` overlap window — and exact 1:1 send/recv pairing per group.
Idle devices of emulated/combined programs must have EMPTY op lists: the
trace itself is the idle-pass-through guarantee. Violations raise typed
errors (:class:`TraceSchemaError` / :class:`TraceLinkConflictError` /
:class:`TracePairingError`, all :class:`TraceValidationError`).

``to_json``/``from_json`` round-trip losslessly (property-tested in
``tests/test_torch_export.py``); ``python -m repro_torch.runtime.export TRACE.json...``
validates trace files from the command line (the CI artifact check).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys

from repro_torch.runtime import optimize as _opt
from repro_torch.runtime.program import (
    KINDS,
    CollectiveProgram,
    LocalContract,
    Match,
    Perm,
    ReduceCombine,
)

#: trace format version — bump on any incompatible layout change
SCHEMA_VERSION = 1

#: the full op vocabulary
OPS = ("send", "recv", "reduce", "copy", "contract")

#: named buffers ops may address, per kind:
#:   alltoall   x (read-only input), out
#:   allreduce  val
#:   broadcast  val  (leading wave axis when num_rounds > 1)
#:   matmul     b, a (read-only inputs), val, acc, c
#: plus the per-device scratch ``tmp`` (recv-then-reduce) and the pseudo
#: source ``zero`` (accumulator reset).
BUFS = ("x", "out", "val", "acc", "c", "b", "a", "tmp", "zero")


class TraceValidationError(ValueError):
    """Base: the trace is not a safe executable device program."""


class TraceSchemaError(TraceValidationError):
    """Wrong schema version or structurally malformed trace."""


class TracePairingError(TraceValidationError):
    """A send without its recv (or an orphan recv) within a group."""


class TraceLinkConflictError(TraceValidationError):
    """A directed link double-booked within one synchronous step/window."""


@dataclasses.dataclass(frozen=True)
class TraceOp:
    """One primitive on one device. Unused fields hold their defaults so
    ops stay uniform (and compress well in JSON — defaults are omitted)."""

    op: str
    group: int
    round_index: int
    step: int
    start_step: int
    peer: int = -1     # send/recv: the other endpoint's device id
    buf: str = ""      # the buffer written (recv/reduce/copy) or read (send)
    src: str = ""      # reduce/copy: source buffer name
    slot: int = -1     # alltoall chunk id / pipelined-broadcast wave id
    fn: str = ""       # contract: the LocalContract fn name
    nbytes: int = 0    # send: payload size stamp (0 = unstamped)


@dataclasses.dataclass(frozen=True)
class DeviceTrace:
    """The exported program: ``devices[i]`` is device i's ordered op list.

    Idle devices of emulated (``active_devices``) programs have empty
    lists — the trace carries the idle-pass-through guarantee structurally.
    Equality is structural, so ``from_json(to_json()) == trace``.
    """

    schema: int
    kind: str
    n: int
    num_rounds: int
    num_groups: int
    devices: tuple[tuple[TraceOp, ...], ...]
    root: int | None = None
    grid: tuple[int, int] | None = None
    name: str = ""
    active_devices: tuple[int, ...] | None = None

    # ------------------------------------------------------------- metrics
    @property
    def guest_n(self) -> int:
        return self.n if self.active_devices is None else len(self.active_devices)

    @property
    def num_ops(self) -> int:
        return sum(len(ops) for ops in self.devices)

    @property
    def num_sends(self) -> int:
        return sum(op.op == "send" for ops in self.devices for op in ops)

    def waves(self) -> tuple[tuple[int, int], ...]:
        """Overlap windows: sorted ``(start_step, sends launched there)``.
        Pipelined schedules show several rounds' sends sharing one window;
        barrier schedules degenerate to one window per step."""
        counts: dict[int, int] = {}
        for ops in self.devices:
            for op in ops:
                if op.op == "send":
                    counts[op.start_step] = counts.get(op.start_step, 0) + 1
        return tuple(sorted(counts.items()))

    # ---------------------------------------------------------------- JSON
    def to_json(self) -> str:
        devs = []
        for ops in self.devices:
            rows = []
            for op in ops:
                row: dict = {"op": op.op, "g": op.group, "r": op.round_index,
                             "t": op.step, "ss": op.start_step}
                for k, short in _OPTIONAL:
                    v = getattr(op, k)
                    if v != TraceOp.__dataclass_fields__[k].default:
                        row[short] = v
                rows.append(row)
            devs.append(rows)
        payload = {
            "schema": self.schema, "kind": self.kind, "n": self.n,
            "num_rounds": self.num_rounds, "num_groups": self.num_groups,
            "root": self.root,
            "grid": list(self.grid) if self.grid is not None else None,
            "name": self.name,
            "active_devices": (list(self.active_devices)
                               if self.active_devices is not None else None),
            "devices": devs,
        }
        return json.dumps(payload, separators=(",", ":"))

    @staticmethod
    def from_json(text: str) -> "DeviceTrace":
        try:
            raw = json.loads(text)
        except ValueError as e:
            raise TraceSchemaError(f"not a JSON trace: {e}") from None
        if not isinstance(raw, dict) or "devices" not in raw:
            raise TraceSchemaError("not a DeviceTrace JSON object")
        devices = []
        for rows in raw["devices"]:
            ops = []
            for row in rows:
                kw = {k: row[short] for k, short in _OPTIONAL if short in row}
                ops.append(TraceOp(row["op"], row["g"], row["r"], row["t"],
                                   row["ss"], **kw))
            devices.append(tuple(ops))
        grid = raw.get("grid")
        active = raw.get("active_devices")
        return DeviceTrace(
            schema=raw.get("schema", -1), kind=raw.get("kind", ""),
            n=raw.get("n", len(devices)),
            num_rounds=raw.get("num_rounds", 1),
            num_groups=raw.get("num_groups", 0),
            devices=tuple(devices), root=raw.get("root"),
            grid=tuple(grid) if grid is not None else None,
            name=raw.get("name", ""),
            active_devices=tuple(active) if active is not None else None,
        )


#: (TraceOp field, JSON short key) for default-omitted fields
_OPTIONAL = (("peer", "p"), ("buf", "b"), ("src", "s"), ("slot", "k"),
             ("fn", "f"), ("nbytes", "nb"))


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def _iter_groups(prog: CollectiveProgram):
    """Replay groups: the program's synchronous step groups, except every
    allreduce ``ReduceCombine`` stage stands alone — hypercube exchange
    rounds are data-dependent (each reads the previous round's sums), so
    same-stamp stages must still replay sequentially."""
    if prog.kind == "allreduce":
        for st in prog.comm_stages:
            yield (st,)
    else:
        yield from prog.step_groups()


def _emit_local(devices: list, gid: int, st: LocalContract,
                prog: CollectiveProgram) -> None:
    s_ = dict(group=gid, round_index=st.round_index, step=st.step,
              start_step=st.start_step)
    if st.fn == "store_c":
        for d in (st.mask or ()):
            devices[d].append(TraceOp("copy", buf="c", src="val", **s_))
        return
    for d in prog.active_np.tolist():
        if st.fn == "load_b":
            devices[d].append(TraceOp("copy", buf="val", src="b", **s_))
        elif st.fn == "mul_a":
            devices[d].append(TraceOp("contract", fn="mul_a", **s_))
        else:  # promote
            devices[d].append(TraceOp("copy", buf="val", src="acc", **s_))
        devices[d].append(TraceOp("copy", buf="acc", src="zero", **s_))


def export(program, *, nbytes: int = 0) -> DeviceTrace:
    """Compile a program (or its ``OptimizedProgram`` form — the trace is
    the same, per the optimizer's bit-exactness guarantee) to a
    :class:`DeviceTrace`. ``nbytes`` stamps every ``send`` with its payload
    size when the caller knows it (pure metadata; replay ignores it).
    Memoized per (program, nbytes) — programs are frozen and hashable."""
    return _export(_opt.as_program(program), nbytes)


@functools.lru_cache(maxsize=None)
def _export(prog: CollectiveProgram, nbytes: int) -> DeviceTrace:
    waves = prog.kind == "broadcast" and prog.num_rounds > 1
    devices: list[list[TraceOp]] = [[] for _ in range(prog.n)]
    gid = -1
    for gid, group in enumerate(_iter_groups(prog)):
        if isinstance(group[0], LocalContract):
            _emit_local(devices, gid, group[0], prog)
            continue
        for st in group:
            s_ = dict(group=gid, round_index=st.round_index, step=st.step,
                      start_step=st.start_step)
            if isinstance(st, Perm):
                for s, d in st.pairs:
                    if s == d:  # the self chunk moves without a link
                        devices[s].append(
                            TraceOp("copy", buf="out", src="x", slot=s, **s_))
                    else:
                        devices[s].append(TraceOp("send", peer=d, buf="x",
                                                  slot=d, nbytes=nbytes, **s_))
                        devices[d].append(TraceOp("recv", peer=s, buf="out",
                                                  slot=s, **s_))
            elif isinstance(st, Match):
                slot = st.round_index if waves else -1
                for s, d in st.pairs:
                    devices[s].append(TraceOp("send", peer=d, buf="val",
                                              slot=slot, nbytes=nbytes, **s_))
                    devices[d].append(TraceOp("recv", peer=s, buf="val",
                                              slot=slot, **s_))
            elif isinstance(st, ReduceCombine):
                target = "val" if prog.kind == "allreduce" else "acc"
                for s, d in st.pairs:
                    if s == d:  # off-and-on: own pre-group value joins acc
                        devices[d].append(
                            TraceOp("reduce", buf=target, src="val", **s_))
                    else:
                        devices[s].append(TraceOp("send", peer=d, buf="val",
                                                  nbytes=nbytes, **s_))
                        devices[d].append(TraceOp("recv", peer=s, buf="tmp", **s_))
                        devices[d].append(
                            TraceOp("reduce", buf=target, src="tmp", **s_))
            else:  # pragma: no cover - Stage union is closed
                raise TypeError(f"unexpected stage {st!r}")
    return DeviceTrace(
        schema=SCHEMA_VERSION, kind=prog.kind, n=prog.n,
        num_rounds=prog.num_rounds, num_groups=gid + 1,
        devices=tuple(tuple(ops) for ops in devices),
        root=prog.root, grid=prog.grid, name=prog.name,
        active_devices=prog.active_devices,
    )


# ---------------------------------------------------------------------------
# Static validation
# ---------------------------------------------------------------------------

def _check_structure(trace: DeviceTrace) -> None:
    if trace.schema != SCHEMA_VERSION:
        raise TraceSchemaError(
            f"trace schema {trace.schema} != supported {SCHEMA_VERSION}")
    if trace.kind not in KINDS:
        raise TraceSchemaError(f"unknown trace kind {trace.kind!r}")
    if len(trace.devices) != trace.n:
        raise TraceSchemaError(
            f"trace has {len(trace.devices)} device lists for n={trace.n}")
    active = (set(range(trace.n)) if trace.active_devices is None
              else set(trace.active_devices))
    if not active <= set(range(trace.n)):
        raise TraceSchemaError(f"active_devices exceed n={trace.n}")
    for dev, ops in enumerate(trace.devices):
        if dev not in active and ops:
            raise TraceSchemaError(
                f"idle device {dev} has {len(ops)} ops — the trace must "
                f"carry the idle-pass-through guarantee structurally")
        for op in ops:
            if op.op not in OPS:
                raise TraceSchemaError(f"device {dev}: unknown op {op.op!r}")
            if not 0 <= op.group < trace.num_groups:
                raise TraceSchemaError(
                    f"device {dev}: op group {op.group} out of range "
                    f"[0, {trace.num_groups})")
            if op.op in ("send", "recv"):
                if not 0 <= op.peer < trace.n:
                    raise TraceSchemaError(
                        f"device {dev}: {op.op} peer {op.peer} out of range")
                if op.peer not in active:
                    raise TraceSchemaError(
                        f"device {dev}: {op.op} names idle peer {op.peer}")
                if not op.buf:
                    raise TraceSchemaError(f"device {dev}: {op.op} without buf")
            if op.op in ("reduce", "copy") and not (op.buf and op.src):
                raise TraceSchemaError(
                    f"device {dev}: {op.op} needs buf and src")


def _check_links(trace: DeviceTrace) -> None:
    """One send per directed link per synchronous step — checked per
    ``(round_index, step)`` stamp AND per ``start_step`` overlap window,
    so pipelined exports prove the stronger concurrent claim."""
    seen: set[tuple] = set()
    for dev, ops in enumerate(trace.devices):
        for op in ops:
            if op.op != "send":
                continue
            for key in (("rs", op.round_index, op.step, dev, op.peer),
                        ("ss", op.start_step, dev, op.peer)):
                if key in seen:
                    when = (f"step ({op.round_index}, {op.step})"
                            if key[0] == "rs"
                            else f"start_step window {op.start_step}")
                    raise TraceLinkConflictError(
                        f"link {dev}->{op.peer} double-booked at {when}")
                seen.add(key)


def _check_pairing(trace: DeviceTrace) -> None:
    sends: dict[tuple, int] = {}
    recvs: dict[tuple, int] = {}
    for dev, ops in enumerate(trace.devices):
        for op in ops:
            if op.op == "send":
                k = (op.group, dev, op.peer)
                sends[k] = sends.get(k, 0) + 1
            elif op.op == "recv":
                k = (op.group, op.peer, dev)
                recvs[k] = recvs.get(k, 0) + 1
    for k, c in sends.items():
        if recvs.get(k, 0) != c:
            g, s, d = k
            raise TracePairingError(
                f"group {g}: send {s}->{d} has {recvs.get(k, 0)} matching "
                f"recv(s), expected {c}")
    for k, c in recvs.items():
        if sends.get(k, 0) != c:
            g, s, d = k
            raise TracePairingError(
                f"group {g}: recv on {d} from {s} has no matching send")


def validate(trace: DeviceTrace) -> DeviceTrace:
    """Re-prove the exported form safe: schema/structure, link-conflict-
    freedom (per step and per overlap window), send/recv pairing. Returns
    the trace for chaining; raises a :class:`TraceValidationError`
    subclass naming the first violation."""
    _check_structure(trace)
    _check_links(trace)
    _check_pairing(trace)
    return trace


# ---------------------------------------------------------------------------
# CLI: validate trace files (the CI artifact check)
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.runtime.export TRACE.json [...]")
        return 2
    bad = 0
    for path in argv:
        try:
            with open(path) as f:
                trace = DeviceTrace.from_json(f.read())
            validate(trace)
        except (OSError, TraceValidationError) as e:
            print(f"FAIL {path}: {e}")
            bad += 1
            continue
        print(f"ok   {path}: kind={trace.kind} n={trace.n} "
              f"guest_n={trace.guest_n} groups={trace.num_groups} "
              f"ops={trace.num_ops} sends={trace.num_sends} "
              f"waves={len(trace.waves())}")
    return 1 if bad else 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())
