"""Serving launcher: the continuous-batching engine on an arch's smoke
config, on the card or on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --requests 6 --max-new 12 --device cpu

The port of ``repro.launch.serve`` in single-engine mode. ``--tenants``
(the multi-tenant fleet) waits for the fleet slice.
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.embeds_input:
        raise SystemExit("stub-frontend archs serve via decode_step directly")
    return _serve_single(cfg, args)


if __name__ == "__main__":
    main()
