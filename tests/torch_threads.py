"""Caps torch's intra-op threads for the port's test modules.

Each ``tests/test_torch_*.py`` imports this before its first torch op.
Under ``pytest -n N`` every worker would start torch's default of one
thread per CPU, so N workers run N times as many threads as there are
CPUs, and a CPU-bound test can take minutes instead of seconds.  With the
cap the workers share the CPUs out between them.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
