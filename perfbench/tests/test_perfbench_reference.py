"""The plain reference against the port at a test's size on the CPU:
the same weights and blocks give the same losses, first gradients and
changes, in float32."""

import pytest
import torch

from perfbench.tests import tiny
from perfbench import checks, leaves as LV
from perfbench.reference import mamba2 as ref_mamba2
from perfbench.reference import train as ref_train
from perfbench.runners import train_mpmd as R


@pytest.mark.parametrize("family", ["dense", "mamba2"])
def test_reference_matches_the_port(family):
    run = R.TrainRun(tiny.cell(family), seed=2 ** 40 + 7, device="cpu")
    run.setup()
    run.release()
    got = run.check()
    assert got["loss_gap"]["value"] < 1e-6
    assert got["grad_gap"]["value"] < 1e-5
    assert got["change_gap"]["value"] < 1e-3
    assert checks.passed(got)


@pytest.mark.parametrize("family", ["dense", "mamba2"])
def test_weights_tree_is_the_ports_layout(family):
    from repro_torch.models import model as M
    cfg = R.arch_config(tiny.config(family))
    ports = {p: tuple(t.shape) for p, t in
             LV.walk(M.init_params(cfg, None, device="meta"))}
    w = ref_train.weights(tiny.config(family), 5, "cpu")
    ours = {p: tuple(t.shape) for p, t in LV.walk(w.tree())}
    assert ours == ports


def test_weights_drawn_again_are_the_same():
    w = ref_train.weights(tiny.config("mamba2"), 11, "cpu")
    tree = w.tree()
    for path, t in LV.walk(tree):
        assert torch.equal(w.tensor(path), t), path


def test_chunked_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, L, H, P, N = 2, 48, 3, 4, 5
    x = torch.randn(b, L, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(b, L, H, generator=g, dtype=torch.float64)
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 2
    B = torch.randn(b, L, N, generator=g, dtype=torch.float64)
    C = torch.randn(b, L, N, generator=g, dtype=torch.float64)
    state = torch.zeros(b, H, P, N, dtype=torch.float64)
    want = []
    for t in range(L):
        state = torch.exp(dt[:, t] * A)[..., None, None] * state \
            + dt[:, t, :, None, None] * x[:, t, :, :, None] \
            * B[:, t, None, None, :]
        want.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    got = ref_mamba2.ssd(x, dt, A, B, C, chunk=16)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-10,
                               atol=1e-10)
