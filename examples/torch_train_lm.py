"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps,
with the port (the counterpart of ``examples/train_lm.py``).

Uses the port's full training path — model zoo config, AdamW + cosine
schedule, train step with z-loss, async checkpoints in the reference's
layout — on the synthetic Markov token stream. Loss drops from ~ln(V)
toward the chain's conditional entropy. Runs on the card unless told
otherwise.

  PYTHONPATH=src python examples/torch_train_lm.py              # ~100M, 300 steps
  PYTHONPATH=src python examples/torch_train_lm.py --fast       # tiny smoke run
  PYTHONPATH=src python examples/torch_train_lm.py --fast --device cpu
"""
import argparse
import os
import tempfile
import time

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="tiny config, 40 steps")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.fast:
        model, log = train(
            arch="llama3.2-1b", preset="tiny", steps=40, batch=8, seq=64,
            ckpt_dir=args.ckpt_dir, device=args.device,
        )
    else:
        model, log = train(
            arch="llama3.2-1b", preset="small100m", steps=300, batch=8,
            seq=256, lr=1e-3, ckpt_dir=args.ckpt_dir, log_every=20, device=args.device,
        )
    first, last = log[0], log[-1]
    drop = first["loss"] - last["loss"]
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} (drop {drop:.3f}) "
          f"in {time.perf_counter() - t0:.1f} s on {model.device}")
    assert drop > 0.05, "training failed to reduce loss"


if __name__ == "__main__":
    main()
