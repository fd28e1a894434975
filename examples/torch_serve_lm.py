"""Serve a small LM on the port with batched requests under the paper's
admission policy (close a batch at 20 ms OR max_batch requests — Sec.
III-A of the paper, transplanted to LLM serving). The port of
``examples/serve_lm.py``.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu] [--arch recurrentgemma-9b]

Any of the ten registered architectures serves (the ``tiny`` preset:
MoE, MLA and RG-LRU widths reduced as ``reduced_config`` reduces them).
"""
import argparse

from repro_torch.configs import list_archs
from repro_torch.launch.serve import serve_demo


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    args = ap.parse_args()
    stats = serve_demo(arch=args.arch, n_requests=24, max_batch=8, device=args.device)
    print(f"{args.arch} serving stats on {args.device} (dual-threshold batching, 20 ms / 8 requests):")
    for k, v in stats.items():
        print(f"  {k}: {v}")
    assert stats["requests"] == 24
    assert stats["tokens_generated"] > 0


if __name__ == "__main__":
    main()
