"""Serving launcher: batched prefill + greedy decode on one device.

Runs on CUDA unless asked for the CPU; raises if CUDA is asked for and
absent.  Example (CPU, reduced model)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --reduced --batch 4 --prompt-len 64 --gen 16 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(cfg: ArchConfig, model: M.DecoderLM, prompts, gen: int,
          device: torch.device | str = "cuda",
          frontend_embed=None) -> Dict[str, object]:
    """Greedy generation of ``gen`` tokens after the prompts (B, S), an
    integer array or tensor.  A model with a frontend stub (musicgen's
    audio frames, pixtral's image patches) may take the prompt's
    precomputed embeddings as ``frontend_embed`` (B, S, frontend_dim), an
    array or tensor, which the prefill adds; decode steps take none.

    Returns ``tokens`` (B, gen) int64 on the host, ``last_logits``
    (B, 1, V) fp32 of the last step, ``prefill_s`` and ``decode_s`` (host
    clock around work that ends in a device synchronise) and
    ``decode_tok_s`` (decoded tokens per second over the gen - 1 decode
    steps; the first token comes from the prefill).
    """
    device = M.resolve_device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=device)
    bsz, plen = prompts.shape
    max_len = plen + gen
    if frontend_embed is not None:
        frontend_embed = torch.as_tensor(frontend_embed, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = M.prefill(cfg, model.params, prompts, max_len=max_len,
                               frontend_embed=frontend_embed)
    next_tok = logits[:, -1].argmax(-1)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = [next_tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((bsz,), plen + i, dtype=torch.long, device=device)
        logits, caches = M.decode_step(cfg, model.params, caches, next_tok,
                                       pos)
        next_tok = logits[:, -1].argmax(-1)[:, None]
        out.append(next_tok)
    tokens = torch.cat(out, dim=1).cpu()
    decode_s = time.perf_counter() - t1
    return {"tokens": tokens, "last_logits": logits,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tok_s": (gen - 1) * bsz / max(decode_s, 1e-9)}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = M.resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode step")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = M.DecoderLM.init(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int64)

    res = serve(cfg, model, prompts, args.gen, device)
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s']:.2f}s")
    print(f"decode: {args.gen - 1} steps x {args.batch} seqs in "
          f"{res['decode_s']:.2f}s ({res['decode_tok_s']:.1f} tok/s)")
    toks = res["tokens"]
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: ...{prompts[b, -8:].tolist()} => "
              f"{toks[b].tolist()}")
    return res


if __name__ == "__main__":
    main()
