"""Batched serving: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --arch mamba2-370m --device cpu

The port of ``examples/serve_batched.py``.  Exercises the serving path
end to end with a reduced model (on the card unless ``--device cpu`` is
asked for): ring-buffer KV caches (sliding-window archs), SSM state carry
(mamba2 / zamba2), and per-sequence positions.  Pass any of the 10
assigned archs.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.launch.serve import serve
from repro_torch.models import model as M


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = M.resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name}: encoder-only, no decode")
    model = M.DecoderLM.init(cfg, torch.Generator(device).manual_seed(0),
                             device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int64)

    res = serve(cfg, model, prompts, args.gen, device)
    print(f"[{cfg.name}] prefill {args.batch}x{args.prompt_len}: "
          f"{res['prefill_s']:.2f}s")
    print(f"decode {args.gen - 1} steps: {res['decode_s']:.2f}s "
          f"({res['decode_tok_s']:.1f} tok/s)")
    toks = res["tokens"]
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: …{prompts[b, -6:].tolist()} ⇒ {toks[b].tolist()}")
    return toks


if __name__ == "__main__":
    main()
