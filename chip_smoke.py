#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit (``nvidia-smi``); without
             CUDA the script exits 2;
2. build   — the CUDA kernels from the sources in this checkout (``nvcc``);
3. kernel  — the flash attention kernel against its plain PyTorch version on
             the card: the cases of ``tests/test_kernels.py`` in fp32 (TF32
             off, |err| <= 2e-5) and bf16 (|err| <= 1e-3 + 1e-2 |plain|,
             about one bf16 rounding step), the serving shape (contiguous
             and as the transposed views the model passes) and a GQA shape;
             times of kernel, plain version and SDPA at the serving shape,
             beside the least time the card could take;
4. serve   — ``launch.serve.serve`` on llama-7b at full width (bf16, random
             weights from a seed): batch 8, prompt 512, 32 generated tokens;
             the prefill must launch the kernel once per layer;
5. consistency — fp32, TF32 off, full width: the last logits of a prefill of
             S+1 tokens against a prefill of S tokens and one decode step
             (the kernel path against the plain decode path), within 2e-3 of
             max|logits|; and a reduced model on the card against the same
             parameters on the CPU (plain version), within 1e-4.

Then a line ``{"kernels": [...]}`` with each kernel's launches on the
serving run, its error and its times, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_reference  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s of the tensor cores (bf16) and of the fp32 pipe
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# b, h, kvh, sq, sk, d, causal, window, softcap (tests/test_kernels.py:21-31)
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, 0, 0.0),
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 1, 96, 96, 64, True, 0, 0.0),
    (2, 4, 4, 128, 128, 64, True, 48, 0.0),
    (2, 4, 4, 128, 128, 64, True, 0, 30.0),
    (2, 4, 4, 64, 64, 64, False, 0, 0.0),
    (1, 2, 2, 64, 192, 32, True, 0, 0.0),
    (2, 4, 4, 128, 128, 128, True, 32, 50.0),
]
SERVE_SHAPE = (8, 32, 32, 512, 512, 128, True, 0, 0.0)     # llama-7b prefill
GQA_SHAPE = (2, 32, 4, 512, 512, 64, True, 0, 0.0)         # tiny-llama heads
# |kernel - plain| <= atol + rtol * |plain|, elementwise.  Both compute in
# fp32 and round once to the output dtype, so in bf16 they differ by at most
# one rounding step (<= 2**-7 of the value) plus fp32 noise near zero.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-3, 1e-2)}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **dev})
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name in build.sources():
        build.load(name)
    usage = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "built": sorted(logs),
          "ptxas": usage})


def _qkv(case, dtype, seed=0):
    b, h, kvh, sq, sk, d = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    return mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d)


def _compare(case, dtype, views=False) -> float:
    q, k, v = _qkv(case, dtype)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    if views:   # (B, S, H, D) storage seen as (B, H, S, D), as the model does
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, **kw)
    diff = (got.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    over = (diff / (atol + rtol * ref.float().abs())).max().item()
    err = diff.max().item()
    if not (np.isfinite(err) and over <= 1.0):
        raise AssertionError(f"flash attention {case} {dtype} views={views}:"
                             f" max err {err}, {over} x the tolerance "
                             f"{atol} + {rtol} |plain|")
    return err


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(case, dtype):
    """Least time (ms) for the function at ``case``: each input read once
    and the output written once at the HBM rate, against the two matmuls'
    FLOPs over the (q, k) pairs the masks keep at the peak for ``dtype``."""
    b, h, kvh, sq, sk, d, causal, window, _ = case
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * (2 * b * h * sq + 2 * b * kvh * sk)
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    flops = 4.0 * b * h * d * int(keep.sum())
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernel() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES):
            errs[f"case{i}-{str(dtype)[6:]}"] = _compare(case, dtype)
        errs[f"gqa-{str(dtype)[6:]}"] = _compare(GQA_SHAPE, dtype)
        errs[f"views-{str(dtype)[6:]}"] = _compare(FLASH_CASES[7], dtype,
                                                   views=True)
    dtype = torch.bfloat16
    serve_err = max(_compare(SERVE_SHAPE, dtype),
                    _compare(SERVE_SHAPE, dtype, views=True))
    errs["serve-bfloat16"] = serve_err

    q, k, v = _qkv(SERVE_SHAPE, dtype)
    kw = dict(causal=True, window=0, softcap=0.0)
    kernel_ms = _time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                         20)
    plain_ms = _time_ms(lambda: attention_reference(q, k, v, **kw), 10)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    kernel_ms_2 = _time_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                           20)
    bound_ms, bound_by, nbytes, flops = _bound(SERVE_SHAPE, dtype)
    res = {"phase": "kernel", "max_abs_err": errs, "shape": SERVE_SHAPE,
           "dtype": "bfloat16", "kernel_ms": kernel_ms,
           "kernel_ms_repeat": kernel_ms_2, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "flops": flops,
           "kernel_tflops": flops / kernel_ms / 1e9}
    emit(res)
    return {"max_abs_err": serve_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_serve() -> int:
    cfg = get_arch("llama-7b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = M.DecoderLM.init(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    serve(cfg, model, prompts, 2, "cuda")     # warm-up at the same shapes
    torch.cuda.reset_peak_memory_stats()
    flash_ops.LAUNCHES = 0
    res = serve(cfg, model, prompts, SERVE_GEN, "cuda")
    launches = flash_ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    if launches != cfg.n_layers:
        raise AssertionError(f"prefill launched the kernel {launches} "
                             f"times, not {cfg.n_layers}")
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    if not bool(torch.isfinite(res["last_logits"]).all()):
        raise AssertionError("non-finite logits")
    emit({"phase": "serve", "arch": cfg.name, "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "gen": SERVE_GEN, "init_s": init_s,
          "params": M.param_count(model.params),
          "prefill_ms": res["prefill_s"] * 1e3,
          "decode_s": res["decode_s"],
          "decode_tok_s": res["decode_tok_s"], "peak_mem_gib": peak / 2**30,
          "kernel_launches": launches, "tokens_seq0": toks[0].tolist()})
    return launches


def phase_consistency(batch: int = 2, seq: int = 256) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama-7b"), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = M.DecoderLM.init(cfg, gen, "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, seq + 1))).cuda()
    with torch.inference_mode():
        full, _ = model.prefill(toks, seq + 1)
        _, caches = model.prefill(toks[:, :seq], seq + 1)
        step, _ = model.decode_step(caches, toks[:, seq:],
                                    torch.full((batch,), seq, device="cuda"))
    torch.cuda.synchronize()
    err = (full[:, -1] - step[:, -1]).abs().max().item()
    scale = full[:, -1].abs().max().item()
    del model, caches
    torch.cuda.empty_cache()
    if not (np.isfinite(err) and err <= 2e-3 * scale):
        raise AssertionError(f"prefill/decode: err {err} > 2e-3 * {scale}")

    # small input: the kernel path on the card against the plain path on
    # the CPU, same parameters
    small = get_arch("llama-7b").reduced()
    gen = torch.Generator().manual_seed(2)
    cpu_params = M.init_params(small, gen, "cpu")
    tree = M.tree_map(cpu_params, lambda _, t: t.numpy())
    gpu_params = params_from_numpy(tree, "cuda")
    stoks = torch.from_numpy(np.random.default_rng(2).integers(
        0, small.vocab_size, (2, 96)))
    with torch.inference_mode():
        ref, _ = M.prefill(small, cpu_params, stoks, 97)
        got, _ = M.prefill(small, gpu_params, stoks.cuda(), 97)
    small_err = (got.cpu() - ref).abs().max().item()
    small_scale = ref.abs().max().item()
    if not (np.isfinite(small_err) and small_err <= 1e-4 * small_scale):
        raise AssertionError(f"reduced llama-7b cuda vs cpu: err "
                             f"{small_err} > 1e-4 * {small_scale}")
    emit({"phase": "consistency", "dtype": "float32", "layers": cfg.n_layers,
          "batch": batch, "seq": seq, "max_abs_err": err,
          "max_abs_logit": scale, "rel": err / scale,
          "small_cuda_vs_cpu_rel": small_err / small_scale})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    dev = phase_device()
    phase_build()
    kern = phase_kernel()
    launches = phase_serve()
    torch.cuda.empty_cache()
    phase_consistency()
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
        "launches": launches, **kern}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
