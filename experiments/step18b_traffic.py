"""One rank's collective payload, FLOPs and peak at ``chip_smoke.py``'s
step 18 b shape, counted on the meta device by the dry run's counters.

    PYTHONPATH=src python experiments/step18b_traffic.py

TinyLlama-1.1B whole (bf16), a (data 2, model 2) mesh with FSDP, global
batch (4, 2048): the sharded train step (step 18 b) and the prefill
forward (step 18 d's work without K4's launches), rank 0 of torch's fake
process group (``launch.dryrun.trace_cell`` and ``run_trace``). Prints
one JSON line: for each, the FLOPs, the peak of live bytes and the
collective payload bytes by kind (the tensors each collective writes).
No card is needed; the counts are the ones the code on the card makes.
"""

import json

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as D

MESH, AXES = (2, 2), ("data", "model")
TOKENS = (4, 2048)


def main() -> None:
    cfg = get_config("tinyllama-1.1b")
    rules = SH.ShardRules(fsdp=True, data_axis_size=MESH[0], model_axis_size=MESH[1])
    out = {}
    for kind in ("train", "prefill"):
        trace = D.trace_cell(cfg, ShapeConfig("step18b", TOKENS[1], TOKENS[0], kind), rules, 1)
        res = D.run_trace(trace, rules, MESH, AXES, 0)
        out[kind] = {key: res[key] for key in ("flops", "peak_bytes", "collectives")}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
