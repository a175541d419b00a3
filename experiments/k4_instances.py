"""Time flash attention (K4) at each of its head-dim instances with the
package of one or more checkouts, so that a parent tree and a change
compare in one call on one card:

    python experiments/k4_instances.py [ROOT ...]   # this checkout by default

Give the roots in turns (parent, change, change, parent). Each root runs
in a subprocess of its own (its own build and import) and prints one JSON
line: the card's name and power limit, the root, and per shape the median
ms of 10 calls after 2 warm-up calls, bf16, causal, at the model's prefill
shape: TinyLlama-1.1B (8, 2048, 32 heads, 4 KV heads, 64), Phi-3-mini
(4, 2048, 32, 32, 96), Mixtral-8x7B (1, 8192, 32, 8, 128, window 4096)
and DeepSeek-V3's MLA (1, 4096, 128, 128, q and k 192, v 128, v the
strided half of a (.., 256) tensor), or the tree's refusal. Needs a CUDA
card.
"""
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {  # B, S, Hq, Hkv, D, Dv, window
    "tinyllama-1.1b": (8, 2048, 32, 4, 64, 64, None),
    "phi3-mini-3.8b": (4, 2048, 32, 32, 96, 96, None),
    "mixtral-8x7b": (1, 8192, 32, 8, 128, 128, 4096),
    "deepseek-v3-671b": (1, 4096, 128, 128, 192, 128, None),
}


def one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root)}
    for name, (B, S, Hq, Hkv, D, Dv, window) in SHAPES.items():
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, Hkv, 256 if Dv != D else Dv, generator=gen,
                        device=dev).bfloat16()[..., -Dv:]
        call = lambda: flash_attention(q, k, v, causal=True, window=window)
        try:
            call()
        except ValueError as e:
            out[name] = f"refused: {e}"
            continue
        torch.cuda.synchronize()
        call()
        times = []
        for _ in range(10):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            call()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        out[name] = statistics.median(times)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def main(argv) -> None:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for root in argv or [str(ROOT)]:
        line = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
        print(json.dumps({"card": card, **json.loads(line)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
