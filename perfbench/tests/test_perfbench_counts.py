"""The yardstick's arithmetic against hand counts: the whole-step rate,
the model FLOPs and mfu of both configurations, each kernel family's
operations and bytes at one shape, and the traced window's reductions."""

import json

import numpy as np
import pytest

from perfbench.tests import tiny
from perfbench import spec, trace
from perfbench.roofline import flash, model_flops, peaks, ssd
from perfbench.runners.train_mpmd import Timed

GPT = json.loads((tiny.ROOT / "perfbench/configs/gpt-1.3b.json").read_text())
MAMBA = json.loads(
    (tiny.ROOT / "perfbench/configs/mamba2-370m.json").read_text())
H100 = peaks.PEAKS["H100"]


def test_gpt_model_flops_by_hand():
    # 24 x (q, k, v, o: 2048 x 64 x 128; MLP 2 x 2048 x 8192) + head
    n = 24 * (2048 * 64 * 128 + 2 * 2048 * 8192) + 2048 * 50257
    assert n == 1_310_885_888
    assert model_flops.weights_multiplied(GPT["model"], "dense") == n
    # causal attention: 12 x 32 x 64 a kept pair, (s + 1) / 2 pairs a token
    attn = {512: 6 * 24 * 32 * 64 * 513, 2048: 6 * 24 * 32 * 64 * 2049}
    for seq, a in attn.items():
        assert model_flops.per_token(GPT, seq) == pytest.approx(6 * n + a,
                                                                rel=1e-12)
    assert model_flops.per_token(GPT, 512) == pytest.approx(8_016_605_184)


def test_mamba2_model_flops_by_hand():
    # in_proj 1024 x (2 x 2048 + 2 x 128 + 32), out_proj 2048 x 1024,
    # conv 4 x 2304, over 48 layers, and the head (the tied embedding's
    # transpose, 50277 ids padded to 50288)
    n = 48 * (1024 * 4384 + 2048 * 1024 + 4 * 2304) + 1024 * 50288
    assert n == 368_082_944
    assert model_flops.weights_multiplied(MAMBA["model"], "mamba2") == n
    # a chunk of 256 and head: 2 x 32896 pairs x (128 + 64) + 4 x 256 x
    # 64 x 128, forward and backward, 32 heads, 48 layers, per token
    ssd_tok = 3 * 48 * 32 * (2 * 32896 * 192 + 4 * 256 * 64 * 128) / 256
    assert model_flops.per_token(MAMBA, 2048) == pytest.approx(
        6 * n + ssd_tok, rel=1e-12)
    assert model_flops.per_token(MAMBA, 2048) == pytest.approx(
        2_586_869_760)


@pytest.mark.parametrize("cfg,seq,batch", [(GPT, 512, 128),
                                           (MAMBA, 2048, 96)])
def test_whole_step_rate_and_mfu(cfg, seq, batch):
    mods = spec.readers("end_to_end", spec.benchmark()["end_to_end"])
    steps, seconds = 3, 10.0
    tokens = steps * batch * seq
    win = Timed(tokens=tokens, seconds=seconds, steps=steps,
                flops=tokens * model_flops.per_token(cfg, seq),
                peak_bytes=3 * 2 ** 30, setup_s=20.5, peaks=H100)
    assert mods["train_tokens_per_s"].read(win) == tokens / seconds
    assert mods["mfu"].read(win) == pytest.approx(
        100 * tokens * model_flops.per_token(cfg, seq) / seconds / 989.4e12)
    assert mods["peak_mem_gib"].read(win) == 3.0
    assert mods["setup_s"].read(win) == 20.5


def test_flash_counts_by_hand():
    assert flash.pairs(8, 8, True, 0) == 36
    assert flash.pairs(8, 8, True, 3) == 1 + 2 + 6 * 3
    assert flash.pairs(8, 8, False, 0) == 64
    case = (2, 4, 4, 8, 8, 16, True, 0)
    # q, k, v, o: 2 x 4 x 8 x 16 elements each, 2 bytes
    assert flash.forward(case, 2) == (8192, 4 * 2 * 4 * 16 * 36)
    # q, o, dO, dq: 3 x 1024 + k, v, dk, dv: 4 x 1024, and 64 fp32 LSE
    assert flash.backward(case, 2) == (2 * 7 * 1024 + 4 * 64,
                                       10 * 2 * 4 * 16 * 36)


def test_ssd_counts_by_hand():
    shape = (1, 2, 64, 4, 8)            # b, h, l, p, n; one tile of 64
    fwd_bytes = 2 * (2 * 2 * 64 * 4 + 2 * 64 * 8) + 4 * (2 * 64 + 2 + 64)
    fwd_flops = 2 * (2 * 2080 * 12 + 4 * 64 * 4 * 8)
    assert ssd.forward(shape, 2) == (fwd_bytes, fwd_flops)
    bwd_bytes = 2 * (3 * 512 + 4 * 512) + 4 * (2 * 128 + 4)
    bwd_flops = 2 * (2 * 2080 * 32 + 10 * 64 * 32)
    assert ssd.backward(shape, 2) == (bwd_bytes, bwd_flops)


def _window():
    dev = [("void flash_fwd_kernel<64>", 0.0, 1.0),
           ("ampere_bf16_s16816gemm", 0.5, 2.0),
           ("Memcpy DtoD", 3.0, 3.5),
           ("at::native::vectorized_elementwise_kernel", 6.0, 8.0)]
    host = [("aten::_local_scalar_dense", 2.0, 3.0),
            ("cudaLaunchKernel", 3.5, 6.0), ("aten::add_", 3.4, 6.0)]
    return trace.Window(device=dev, host_names=[h[0] for h in host],
                        host_start=np.array([h[1] for h in host]),
                        host_end=np.array([h[2] for h in host]),
                        window_s=10.0, steps=2)


def test_traced_window_reductions():
    w = _window()
    assert w.busy_intervals() == [(0.0, 2.0), (3.0, 3.5), (6.0, 8.0)]
    assert w.busy_s == pytest.approx(4.5)
    assert w.gaps() == [(2.0, 3.0), (3.5, 6.0), (8.0, 10.0)]
    br = w.breakdown()
    assert br["idle_gaps"][0] == ["cudaLaunchKernel", 2.5]
    assert br["idle_gaps"][1] == ["no_host_op", 2.0]
    assert br["idle_gaps"][2] == ["aten::_local_scalar_dense", 1.0]
    assert br["device_ops"][0] == ["at::native::vectorized_elementwise_kernel",
                                   2.0]
    assert [trace.kind(n) for n, _, _ in w.device] == \
        ["flash_attention", "matmul", "copy", "elementwise"]


def test_per_layer_readers_on_a_window():
    cfg = tiny.config("dense", "bfloat16")
    ctx = trace.Context(window=_window(), config=cfg,
                        traffic={"seq_len": 8}, passes=[2, 1], peaks=H100)
    mods = spec.readers("metrics", spec.benchmark()["per_layer"])
    read = {n: m.read(ctx) for n, m in mods.items()}
    assert read["device_idle_share"] == pytest.approx(55.0)
    assert read["matmul_ms_per_step"] == pytest.approx(750.0)
    assert read["copy_ms_per_step"] == pytest.approx(250.0)
    assert read["elementwise_ms_per_step"] == pytest.approx(1000.0)
    m = cfg["model"]
    least = sum(peaks.least_seconds(*flash.forward(
        (r, 4, 4, 8, 8, 16, True, 0), 2), H100) for r in (2, 1)) * 2
    assert read["flash_fwd_roofline"] == pytest.approx(100 * least * 2 / 1.0)
    assert m["n_layers"] == 2
    # nothing to read: no backward kernel ran, and the model has no SSM
    assert read["flash_bwd_roofline"] is None
    assert read["ssd_fwd_roofline"] is None
    assert read["ssd_bwd_roofline"] is None
