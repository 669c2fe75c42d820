"""Where the serving time goes: ``torch.profiler`` over one prefill and a
few decode steps of :func:`repro_torch.launch.serve.serve`'s path.

    python -m repro_torch.launch.profile_serve --arch llama-7b \
        --batch 8 --prompt-len 512 --steps 8
    python -m repro_torch.launch.profile_serve --arch mamba2-370m \
        --batch 8 --prompt-len 2048 --steps 8

Needs a CUDA device.  Each window runs twice: once bare, for the host
wall time (work ending in a device synchronise), and once under the
profiler, for the device time of each kernel.  Prints one JSON line per
window (``prefill``, ``decode``) with the wall time, the device time
summed over the window's kernels, the device's idle share
(1 - device / wall; the kernels run on one stream, so they do not
overlap), the device time by kind of kernel (the flash attention kernel,
the SSD scan kernel, matrix products, the rest) and the kernels that took most of it.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_arch
from repro_torch.models import model as M

_GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")


def _kind(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention"
    if "flash_bwd_" in low:
        return "flash_attention_bwd"
    if "ssd_scan_kernel" in low:
        return "ssd_scan"
    if "ssd_scan_bwd_kernel" in low:
        return "ssd_scan_bwd"
    if any(m in low for m in _GEMM_MARKS):
        return "matmul"
    return "other"


def _window(name: str, fn: Callable[[], None], top: int,
            kind: Callable[[str], str] = _kind) -> Dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: Dict[str, float] = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_kind: Dict[str, float] = collections.Counter()
    for n, ms in by_name.items():
        by_kind[kind(n)] += ms
    return {"window": name, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
            "device_ms_by_kind": dict(by_kind),
            "top_kernels_ms": {n[:90]: ms for n, ms in
                               sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]}}


@torch.inference_mode()
def run(arch: str, batch: int, prompt_len: int, steps: int, seed: int,
        top: int = 12) -> Dict[str, Dict]:
    device = M.resolve_device("cuda")
    cfg = get_arch(arch)
    model = M.DecoderLM.init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(device)
    max_len = prompt_len + steps + 1
    state = {}

    def do_prefill():
        logits, state["caches"] = model.prefill(tokens, max_len)
        state["tok"] = logits[:, -1].argmax(-1)[:, None]

    def do_decode():
        tok = state["tok"]
        for i in range(steps):
            pos = torch.full((batch,), prompt_len + i, device=device)
            logits, _ = model.decode_step(state["caches"], tok, pos)
            tok = logits[:, -1].argmax(-1)[:, None]

    do_prefill()                              # warm-up of both shapes
    do_decode()
    out = {"prefill": _window("prefill", do_prefill, top)}
    out["decode"] = _window("decode", do_decode, top)
    out["decode"]["steps"] = steps
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    res = run(args.arch, args.batch, args.prompt_len, args.steps, args.seed)
    for window in res.values():
        print(json.dumps({"arch": args.arch, "batch": args.batch,
                          "prompt_len": args.prompt_len, **window}),
              flush=True)


if __name__ == "__main__":
    main()
