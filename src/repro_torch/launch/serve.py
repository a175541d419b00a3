"""Serving launcher: the continuous-batching engine on an arch's smoke
config, on the card or on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --requests 6 --max-new 12 --device cpu

The port of ``repro.launch.serve``. ``--tenants N`` switches to the
multi-tenant fleet: N copies of the arch, seeded ``--seed`` + i, seated as
disjoint D3(1,2) guests on one D3(N,2) host, every model's MoE dispatch
riding ONE combined program per boundary round (``--time-mux`` serves the
same tenants through sequential solo replays instead, for comparison).
Fleet mode needs an MoE arch and replays on the NumPy reference backend,
each boundary's expert FFN computed where the tenants' weights lie:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --tenants 2 --device cpu

Its last line gives the autotuner's combined-site decision for the seated
tenant set, with its combined and time-multiplexed round counts, as the
JAX launcher's does (the cache: ``REPRO_TORCH_AUTOTUNE_CACHE``, by default
``build/autotune_cache.json``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request


def _random_prompts(rng, cfg, n, max_new):
    return [
        Request(
            rid=i,
            prompt=rng.integers(1, cfg.vocab, size=rng.integers(3, 9)).astype(np.int32),
            max_new_tokens=max_new,
        )
        for i in range(n)
    ]


def _serve_single(cfg, args):
    params = M.init_params(args.seed, cfg, device=args.device)
    eng = Engine(cfg, params, batch_slots=args.slots, max_seq=args.max_seq, device=args.device)

    rng = np.random.default_rng(args.seed)
    pending = _random_prompts(rng, cfg, args.requests, args.max_new)
    submitted = list(pending)
    done: list[Request] = []
    t0 = time.perf_counter()
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            req = pending.pop(0)
            eng.admit(req)
            print(f"admitted rid={req.rid} prompt_len={len(req.prompt)}")
        eng.step()
        # the engine retires finished requests out of slots itself; collect
        # them once each, in completion order
        done.extend(r for r in submitted if r.done and r not in done)
    dt = time.perf_counter() - t0
    if len(done) != len(submitted):
        raise RuntimeError(f"{len(submitted) - len(done)} requests lost by the serve loop")
    print(f"completed {len(done)}/{len(submitted)} requests: "
          f"{[(r.rid, len(r.out)) for r in done]}")
    print(f"engine steps: {eng.steps_run}, wall: {dt:.2f}s, "
          f"tokens: {eng.tokens_out}, tokens/s: {eng.tokens_out / max(dt, 1e-9):.1f}")
    return eng.steps_run


def _serve_fleet(cfg, args):
    from repro_torch.serve.fleet import TenantFleet

    if getattr(cfg, "moe", None) is None:
        raise SystemExit(
            f"--tenants needs an MoE arch (got {args.arch}): fleet tenants "
            "share the combined program at their expert-dispatch boundaries")
    fleet = TenantFleet((args.tenants, 2), max_seq=args.max_seq, combined=not args.time_mux,
                        device=args.device)
    rng = np.random.default_rng(args.seed)
    submitted = []
    for i in range(args.tenants):
        params = M.init_params(args.seed + i, cfg, device=args.device)
        tid = fleet.admit_model(cfg, params, guest=(1, 2), slots=args.slots)
        for req in _random_prompts(rng, cfg, args.requests, args.max_new):
            submitted.append(fleet.submit(tid, req.prompt, req.max_new_tokens))
        print(f"admitted tenant {tid} with {args.requests} requests")
    t0 = time.perf_counter()
    fleet.run_to_completion()
    dt = time.perf_counter() - t0
    done = [r for r in submitted if r.done]
    if len(done) != len(submitted):
        raise RuntimeError(f"{len(submitted) - len(done)} requests lost by the fleet loop")
    mode = "time_mux" if args.time_mux else "combined"
    print(f"completed {len(done)}/{len(submitted)} requests across {args.tenants} tenants "
          f"({mode})")
    print(f"fleet steps: {fleet.steps_run}, replays: {fleet.replays}, "
          f"rounds: {fleet.rounds_replayed}, wall: {dt:.2f}s, tokens: {fleet.tokens_out}, "
          f"tokens/s: {fleet.tokens_out / max(dt, 1e-9):.1f}")
    report = fleet.collective_report()
    print(f"combined-site decision: {report.get('key')} -> "
          f"{report.get('strategy')} ({report.get('source')}); "
          f"rounds combined={report.get('combined_rounds')} "
          f"vs time_mux={report.get('time_mux_rounds')}")
    return fleet.steps_run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve N copies of the arch as a multi-tenant fleet "
                         "on one D3(N,2) host (0 = single-engine mode)")
    ap.add_argument("--time-mux", action="store_true",
                    help="fleet mode: replay each tenant's solo program "
                         "sequentially instead of the combined program")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.embeds_input:
        raise SystemExit("stub-frontend archs serve via decode_step directly")
    if args.tenants:
        return _serve_fleet(cfg, args)
    return _serve_single(cfg, args)


if __name__ == "__main__":
    main()
