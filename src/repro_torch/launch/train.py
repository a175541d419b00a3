"""End-to-end training launcher, on the card or on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
        --steps 50 --batch 8 --seq 64 --device cpu

The port of ``repro.launch.train``, with its flags and printed lines, plus
``--device`` (default ``cuda``; it raises where there is no card). The
loop: data pipeline -> train step (``train.train_step``, the plain
attention: K4 has no backward) -> checkpoint/restart -> straggler
accounting. ``--restore`` resumes from the latest checkpoint (including
the data-iterator state — no sample loss). ``main(argv)`` returns the
final loss.

Elastic mode (``--elastic``) hands the loop to ``train.elastic
.ElasticTrainer``: a seeded/explicit fault injector kills devices mid-run
and every failure is survived in-process — rewrite-only ``plan_recovery``,
§5-broadcast shard redistribution, resume from checkpoint:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \\
        --elastic --host 2 2 --inject-failures "4:1,9:4" --device cpu

``--straggler-drop`` (with ``--microbatches N``) times each microbatch on
the host, drops the ones ``StragglerPolicy`` flags, and renormalizes the
gradient over the kept contributions.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.model import _device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataState, SyntheticLM
from repro_torch.train.fault_tolerance import StragglerPolicy, renormalized_scale
from repro_torch.train.optimizer import OptConfig, flatten, unflatten
from repro_torch.train.train_step import (
    TrainSettings,
    init_train_state,
    make_apply_step,
    make_microbatch_grads,
    make_train_step,
    split_microbatches,
)


def _parse_injections(spec: str) -> dict[int, list[int]]:
    """"step:dev,step:dev,..." -> {step: [dev, ...]} (a step may repeat)."""
    plan: dict[int, list[int]] = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        step_s, dev_s = item.split(":")
        plan.setdefault(int(step_s), []).append(int(dev_s))
    return plan


def _run_elastic(args, cfg, opt_cfg, settings) -> float:
    from repro_torch.core.topology import D3
    from repro_torch.train.elastic import ElasticTrainer, FaultInjector

    host = D3(args.host[0], args.host[1])
    if args.inject_failures:
        injector = FaultInjector(_parse_injections(args.inject_failures))
    elif args.inject_random:
        injector = FaultInjector.sample(
            host, args.steps, args.inject_random, seed=args.seed)
    else:
        injector = FaultInjector()
    if injector.schedule:
        print(f"fault schedule: {injector.schedule}")
    trainer = ElasticTrainer(
        cfg, opt_cfg, settings,
        ckpt_dir=args.ckpt_dir, host=host, injector=injector,
        batch=args.batch, seq=args.seq, seed=args.seed,
        ckpt_every=args.ckpt_every, device=args.device,
    )
    losses = trainer.run(args.steps)
    for ev in trainer.events:
        kind = "absorbed" if ev.absorbed else "rewound"
        print(f"failover @step {ev.step}: killed {list(ev.failed)} -> "
              f"D3{ev.shape} on {list(ev.survivors)} ({kind}, resumed from "
              f"{ev.resumed_from}, {ev.broadcast_rounds} bcast rounds, "
              f"{ev.wall_s * 1e3:.0f} ms, {ev.derivations} derivations)")
    final = losses[max(losses)]
    print(f"elastic run done: {len(losses)} steps, "
          f"{len(trainer.events)} failovers, final loss {final:.4f}")
    return final


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-drop", action="store_true",
                    help="time each microbatch, drop flagged stragglers and "
                         "renormalize the gradient (needs --microbatches > 1)")
    ap.add_argument("--elastic", action="store_true",
                    help="run under ElasticTrainer: survive injected chip "
                         "failures via rewrite-only failover")
    ap.add_argument("--host", type=int, nargs=2, default=(2, 2),
                    metavar=("K", "M"), help="elastic: host pod D3(K, M)")
    ap.add_argument("--inject-failures", default="",
                    help='elastic: explicit kills "step:dev,step:dev,..."')
    ap.add_argument("--inject-random", type=int, default=0,
                    help="elastic: sample N seeded (step, device) kills")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the plain torch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    settings = TrainSettings(
        microbatches=args.microbatches,
        use_kernel=False,
        remat=True,
        compress_grads=args.compress_grads,
    )
    if args.elastic:
        return _run_elastic(args, cfg, opt_cfg, settings)
    device = _device(args.device)

    straggler_drop = args.straggler_drop and args.microbatches > 1
    if straggler_drop:
        # split step: per-microbatch grads are timed on the host so a
        # straggler can be dropped BEFORE it enters the accumulation
        mb_grads_fn = make_microbatch_grads(cfg, settings)
        apply_fn = make_apply_step(cfg, opt_cfg, settings)
    else:
        step_fn = make_train_step(cfg, opt_cfg, settings)

    data_state = DataState(seed=args.seed, batch=args.batch, seq=args.seq, vocab=cfg.vocab)
    start_step = 0
    if args.restore and ckpt.latest_step(args.ckpt_dir) is not None:
        start_step, tree = ckpt.restore(args.ckpt_dir)
        params = ckpt.to_device(tree["params"], device)
        opt_state = ckpt.to_device(tree["opt"], device)
        data_state = DataState.from_dict(tree["data"])  # typed int coercion
        del tree
        print(f"restored step={start_step}")
    else:
        params, opt_state = init_train_state(args.seed, cfg, opt_cfg, settings, device=device)

    data = SyntheticLM(data_state)
    policy = StragglerPolicy()
    durations: list[float] = []
    metrics = None

    for step in range(start_step, args.steps):
        if cfg.embeds_input:
            batch = data.next_embeds_batch(cfg.d_model)
        else:
            batch = data.next_batch()
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        t0 = time.perf_counter()
        if straggler_drop:
            results, mb_durs = [], []
            for mb in split_microbatches(batch, args.microbatches):
                t_mb = time.perf_counter()
                loss_i, metrics_i, g_i = mb_grads_fn(params, mb)
                _sync(device)
                mb_durs.append(time.perf_counter() - t_mb)
                results.append((loss_i, metrics_i, g_i))
            keep = policy.judge(mb_durs)
            kept = [r for r, k in zip(results, keep) if k]
            if not all(keep):
                print(f"step {step}: dropping microbatches "
                      f"{[i for i, k in enumerate(keep) if not k]} "
                      f"(renorm x{renormalized_scale(len(kept), len(keep)):.2f})")
            # mean over the KEPT microbatches only: Σ_kept g / total,
            # renormalized by total/kept
            scale = renormalized_scale(len(kept), len(keep)) / len(keep)
            flat = [[x for _, x in flatten(g)] for _, _, g in kept]
            grads = unflatten(params, [sum(gs) * scale for gs in zip(*flat)])
            del results, flat
            loss = sum(l for l, _, _ in kept) * scale
            params, opt_state, metrics = apply_fn(
                params, opt_state, grads, loss, kept[-1][1])
            del kept, grads
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        durations.append(dt)
        if not straggler_drop and len(durations) >= 8:
            keep = policy.judge(durations[-8:])
            if not all(keep):
                print(f"step {step}: straggler flags {keep}")
        print(f"step {step:4d} loss {loss:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f} ms", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            path = ckpt.save(
                args.ckpt_dir,
                step + 1,
                {"params": params, "opt": opt_state, "data": data.state.to_dict()},
            )
            print(f"checkpoint -> {path}", flush=True)
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
