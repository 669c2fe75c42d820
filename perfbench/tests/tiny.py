"""Cells at a test's size, built in memory: the benchmark's files with
the model cut to two narrow layers, run on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import spec  # noqa: E402

SIZES = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=128, vocab_size=101),
    "mamba2": dict(n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=32,
                   ssm_chunk=16, vocab_size=101),
}
CONFIG_FILES = {"dense": "gpt-1.3b.json", "mamba2": "mamba2-370m.json"}
#: limits a float32 program meets by far (it reads ~1e-7, ~1e-5)
LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


def config(family: str, dtype: str = "float32") -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" /
                      CONFIG_FILES[family]).read_text())
    cfg["model"].update(SIZES[family], dtype=dtype)
    return cfg


def cell(family: str, dtype: str = "float32", batch: int = 48,
         seq: int = 64, cluster: str = "cluster-a") -> spec.Cell:
    bench = spec.benchmark(ROOT)
    return spec.Cell(
        name="tiny", chips=1, config=config(family, dtype),
        traffic={"runner": "train_mpmd", "cluster": cluster,
                 "global_batch": batch, "seq_len": seq},
        checks={"steps": 2, "tokens_per_block": 4 * seq,
                "limits": dict(LIMITS)},
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
        root=ROOT)
