"""Serve a small MoE model with batched requests through the PyTorch
port's continuous-batching engine (prefill + decode, per-slot positions).

    PYTHONPATH=src python examples/torch/serve_moe.py [--device cpu]

Mixtral smoke (``configs.get_smoke_config("mixtral-8x7b")``), random
weights from seed 0 on ``--device`` (the card by default), 3 slots, 5
requests of 4–8 prompt tokens and 8 new tokens each, as
``examples/serve_moe.py`` serves them in the JAX package.
``main(argv, params)`` takes weights from the caller instead (the JAX
example's, carried across by ``models.convert.params_from_jax``, give its
tokens) and returns each request's tokens by id.
"""

import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, Request

SLOTS = 3
REQUESTS = 5
NEW_TOKENS = 8


def main(argv=None, params=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the plain torch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("mixtral-8x7b")
    if params is None:
        params = M.init_params(0, cfg, device=args.device)
    eng = Engine(cfg, params, batch_slots=SLOTS, max_seq=64, device=args.device)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=4 + i).astype(np.int32),
                max_new_tokens=NEW_TOKENS)
        for i in range(REQUESTS)
    ]
    finished = []
    pending = list(reqs)
    while pending or eng.slot_req:
        while pending and eng.free_slots:
            eng.admit(pending.pop(0))
        eng.step()
        finished = [r for r in reqs if r.done]
    for r in reqs:
        assert r.done and len(r.out) == NEW_TOKENS, r
        print(f"rid={r.rid} prompt={[int(t) for t in r.prompt]} -> generated {r.out}")
    print(f"{len(finished)} requests served in {eng.steps_run} engine steps "
          f"(continuous batching over {SLOTS} slots)")
    return {r.rid: list(r.out) for r in reqs}


if __name__ == "__main__":
    main()
