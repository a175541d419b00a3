"""End to end, through the PyTorch port: train the tinyllama-family
reduced model for a few hundred steps; loss must drop substantially;
checkpoints and restart-resume exercised along the way.

    PYTHONPATH=src python examples/torch/train_tinyllama.py [--steps 300] [--device cpu]

It runs ``repro_torch.launch.train`` twice, as ``examples/train_tinyllama.py``
runs the JAX launcher: to half the steps, then from the latest checkpoint to
the end (``--restore``). The checkpoints go to ``--ckpt-dir``, which is
emptied first: by default ``repro_torch_example_ckpt`` under the system's
temporary directory. ``main(argv)`` returns the final loss.
"""

import argparse
import os
import shutil
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the plain torch path)")
    args = ap.parse_args(argv)

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    common = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "8", "--seq", "64",
              "--ckpt-dir", args.ckpt_dir, "--device", args.device]

    # phase 1: train to half, checkpoint
    half = max(args.steps // 2, 1)
    train_launcher.main([*common, "--steps", str(half), "--ckpt-every", "25"])
    # phase 2: RESTART from the checkpoint and finish (fault-tolerance path)
    final_loss = train_launcher.main([*common, "--steps", str(args.steps), "--ckpt-every", "50",
                                      "--restore"])
    print(f"final loss after restart-resume: {final_loss:.4f}")
    return final_loss


if __name__ == "__main__":
    main()
