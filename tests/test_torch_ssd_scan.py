"""The port's SSD scan: its plain version against the JAX package's Pallas
kernel (interpret mode) and oracles on the CPU, and the CUDA kernel against
the plain version on the card (skipped without one).

JAX is imported only by the tests that need it, so that the CUDA tests
also run on a machine with PyTorch and no JAX:
``python -m pytest tests/test_torch_ssd_scan.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_reference

# the cases of tests/test_kernels.py::SSD_CASES
SSD_CASES = [
    # b, h, l, p, n, chunk (the JAX kernel's tile; the port's is fixed)
    (2, 4, 128, 32, 16, 32),
    (1, 2, 96, 64, 32, 32),    # pad path in JAX, ragged L in the kernel
    (2, 4, 256, 32, 64, 64),
    (1, 8, 64, 64, 128, 16),   # mamba2-370m-like head geometry
]
CASE_IDS = ["base", "ragged", "n64", "mamba2-like"]


def _inputs(b, h, l, p, n, seed=0, slow=False):
    """fp32 numpy x (B,H,L,P), dt (B,H,L), a (H,), b/c (B,L,N), drawn as
    ``tests/test_kernels.py`` draws them; ``slow`` makes the decay slow, so
    the state carries across many chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, l, p)).astype(np.float32)
    z = rng.standard_normal((b, h, l)).astype(np.float32)
    if slow:
        dt = np.log1p(np.exp(z - 4.0))
        a = -np.exp(np.linspace(-3.0, 0.0, h))
    else:
        dt = np.log1p(np.exp(z))
        a = -np.exp(np.linspace(0.0, 1.5, h))
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dt.astype(np.float32), a.astype(np.float32), bm, cm


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("b,h,l,p,n,chunk", SSD_CASES, ids=CASE_IDS)
def test_plain_matches_pallas_and_oracle(b, h, l, p, n, chunk):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan.ops import ssd_scan as jax_scan
    from repro.kernels.ssd_scan.ref import ssd_reference as jax_oracle
    arrs = _inputs(b, h, l, p, n)
    pallas = np.asarray(jax_scan(*(jnp.asarray(v) for v in arrs),
                                 chunk=chunk, interpret=True))
    oracle = np.asarray(jax_oracle(*(jnp.asarray(v) for v in arrs)))
    before = ops.LAUNCHES
    y, h_final = ops.ssd_scan(*(torch.from_numpy(v) for v in arrs))
    assert ops.LAUNCHES == before          # CPU tensors: plain version
    assert y.dtype == torch.float32 and y.shape == (b, h, l, p)
    assert h_final.dtype == torch.float32 and h_final.shape == (b, h, p, n)
    assert _rel(y, pallas) < 1e-4          # chunked vs sequential sums
    assert _rel(y, oracle) < 1e-5          # both sequential


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("b,h,l,p,n,chunk", SSD_CASES, ids=CASE_IDS)
def test_final_state_matches_jax_reference(b, h, l, p, n, chunk, with_h0):
    """h_final against the state ``models.layers.ssd.ssd_reference``
    returns, from zero or from a given state, with slow decay so that early
    positions (and the initial state) still count."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers.ssd import ssd_reference as jax_layer_ref
    x, dt, a, bm, cm = _inputs(b, h, l, p, n, seed=1, slow=True)
    h0 = np.random.default_rng(4).standard_normal((b, h, p, n)).astype(
        np.float32) if with_h0 else None
    y_ref, h_ref = jax_layer_ref(jnp.asarray(x.transpose(0, 2, 1, 3)),
                                 jnp.asarray(dt.transpose(0, 2, 1)),
                                 jnp.asarray(a), jnp.asarray(bm),
                                 jnp.asarray(cm),
                                 h0=None if h0 is None else jnp.asarray(h0))
    y, h_final = ops.ssd_scan(*(torch.from_numpy(v)
                                for v in (x, dt, a, bm, cm)),
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert _rel(h_final, h_ref) < 1e-5
    assert _rel(y.transpose(1, 2), y_ref) < 1e-5


def test_strided_views_match_contiguous():
    """ssd_apply hands the wrapper column slices of the conv output and a
    transposed dt."""
    b, h, l, p, n = 2, 4, 40, 32, 16
    x, dt, a, bm, cm = _inputs(b, h, l, p, n, seed=2)
    xbc = np.concatenate([x.transpose(0, 2, 1, 3).reshape(b, l, h * p), bm,
                          cm], axis=-1)
    xbc = torch.from_numpy(np.ascontiguousarray(xbc))
    xv = xbc[..., :h * p].unflatten(-1, (h, p)).transpose(1, 2)
    dtv = torch.from_numpy(np.ascontiguousarray(dt.transpose(0, 2, 1)))
    dtv = dtv.transpose(1, 2)
    views = (xv, dtv, torch.from_numpy(a), xbc[..., h * p: h * p + n],
             xbc[..., h * p + n:])
    assert not views[0].is_contiguous() and not views[1].is_contiguous()
    got = ops.ssd_scan(*views)
    ref = ops.ssd_scan(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("bad,err", [
    ({"x_dtype": torch.float16}, TypeError),
    ({"b_dtype": torch.bfloat16}, TypeError),     # x and b differ
    ({"dt_dtype": torch.bfloat16}, TypeError),
    ({"a_dtype": torch.float64}, TypeError),
    ({"p": 48}, ValueError),
    ({"n": 24}, ValueError),
    ({"stride": "x"}, ValueError),
    ({"stride": "c"}, ValueError),
    ({"l": 0}, ValueError),
    ({"h0": "shape"}, ValueError),
    ({"h0": "dtype"}, TypeError),
    ({"h0": "stride"}, ValueError),
])
def test_kernel_checks_refuse(bad, err):
    """What the CUDA kernel does not take is refused before a launch."""
    b, h, l = 1, 2, bad.get("l", 8)
    p, n = bad.get("p", 32), bad.get("n", 16)
    x = torch.zeros(b, h, l, p, dtype=bad.get("x_dtype", torch.float32))
    if bad.get("stride") == "x":
        x = torch.zeros(b, h, p, l).transpose(2, 3)
    dt = torch.zeros(b, h, l, dtype=bad.get("dt_dtype", torch.float32))
    a = torch.zeros(h, dtype=bad.get("a_dtype", torch.float32))
    bm = torch.zeros(b, l, n, dtype=bad.get("b_dtype", torch.float32))
    cm = torch.zeros(b, l, n)
    if bad.get("stride") == "c":
        cm = torch.zeros(b, n, l).transpose(1, 2)
    h0 = {"shape": torch.zeros(b, h, p, n + 1),
          "dtype": torch.zeros(b, h, p, n, dtype=torch.bfloat16),
          "stride": torch.zeros(b, h, n, p).transpose(2, 3)}.get(bad.get("h0"))
    with pytest.raises(err):
        ops._check(x, dt, a, bm, cm, h0)


def test_build_finds_the_kernel_source():
    src = build.sources()["ssd_scan"]
    text = src.read_text()
    assert text.startswith("// Mamba2 SSD chunked scan")
    assert "src/repro/kernels/ssd_scan/ssd_scan.py:72" in text
    assert "ssd_scan_kernel_mma" in text
    assert "mma.sync.aligned.m16n8k16" in text
    assert build._lib_path(src).parent == build.BUILD_DIR


def test_dtype_picks_the_variant():
    """bf16 goes to the tensor-core kernel, fp32 to the FMA kernel; every
    variant has a launch count, and the CPU path moves none of them."""
    assert ops.VARIANTS == {torch.float32: "fp32-fma",
                            torch.bfloat16: "bf16-mma"}
    assert set(ops.VARIANT_LAUNCHES) == set(ops.VARIANTS.values())
    assert set(ops.VARIANTS) == set(ops._DTYPES)
    before = dict(ops.VARIANT_LAUNCHES)
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(1, 2, 16, 32, 16))
    for dtype in ops.VARIANTS:
        ops.ssd_scan(x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype))
    assert ops.VARIANT_LAUNCHES == before


def _shifted_views(b, h, l, p, n, off, dtype=torch.bfloat16, xbc=None):
    """x, b, c as column slices of a (B, L, H P + 2 N + off) tensor (zeros,
    or ``xbc``) that start ``off`` elements in, as ``ssd_apply`` slices
    the conv output."""
    if xbc is None:
        xbc = torch.zeros(b, l, h * p + 2 * n + off, dtype=dtype)
    xbc = xbc[..., off:]
    x = xbc[..., :h * p].unflatten(-1, (h, p)).transpose(1, 2)
    return x, xbc[..., h * p: h * p + n], xbc[..., h * p + n:]


@pytest.mark.parametrize("off,vec", [(0, 8), (8, 8), (4, 4), (12, 4),
                                     (2, 2), (6, 2), (1, 1), (3, 1)])
def test_copy_width_follows_pointers_and_strides(off, vec):
    """16 B copies where x, b, c's pointers and strides allow them (the
    serving views: off 0), else 8, 4 or 2 B, else plain loads."""
    x, bm, cm = _shifted_views(2, 4, 8, 64, 128, off)
    assert ops._copy_width(x, bm, cm) == vec


@pytest.mark.parametrize("p,n,off", [(32, 16, 1), (64, 128, 3),
                                     (32, 64, 2), (64, 32, 0)])
def test_bf16_takes_what_fp32_takes(p, n, off):
    """The bf16 kernel refuses nothing that the fp32 kernel takes: odd
    strides and pointers included (they are staged by plain loads)."""
    b, h, l = 2, 4, 8
    dt, a = torch.zeros(b, h, l), torch.zeros(h)
    for dtype in (torch.float32, torch.bfloat16):
        x, bm, cm = _shifted_views(b, h, l, p, n, off, dtype)
        ops._check(x, dt, a, bm, cm)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_close(got, ref, rtol):
    """Elementwise |got - ref| <= 1e-4 max|ref| + rtol |ref|: fp32 sums in
    another order, plus one bf16 rounding step where the output is bf16."""
    got, ref = got.float(), ref.float()
    bound = 1e-4 * ref.abs().max() + rtol * ref.abs()
    assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,p,n,chunk", SSD_CASES, ids=CASE_IDS)
def test_cuda_kernel_matches_plain(cuda, b, h, l, p, n, chunk, dtype):
    x, dt, a, bm, cm = (torch.from_numpy(v).to(cuda)
                        for v in _inputs(b, h, l, p, n, slow=True))
    x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
    before = ops.LAUNCHES
    before_variant = ops.VARIANT_LAUNCHES[ops.VARIANTS[dtype]]
    y, h_final = ops.ssd_scan(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert ops.VARIANT_LAUNCHES[ops.VARIANTS[dtype]] == before_variant + 1
    assert y.dtype == dtype and h_final.dtype == torch.float32
    y_ref, h_ref = ssd_scan_reference(x, dt, a, bm, cm)
    _check_close(y, y_ref, 1e-2 if dtype == torch.bfloat16 else 0.0)
    _check_close(h_final, h_ref, 0.0)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views(cuda):
    b, h, l, p, n = 2, 4, 200, 64, 128
    x, dt, a, bm, cm = _inputs(b, h, l, p, n, seed=3, slow=True)
    xbc = np.concatenate([x.transpose(0, 2, 1, 3).reshape(b, l, h * p), bm,
                          cm], axis=-1)
    xbc = torch.from_numpy(np.ascontiguousarray(xbc)).to(cuda)
    dtv = torch.from_numpy(np.ascontiguousarray(dt.transpose(0, 2, 1)))
    views = (xbc[..., :h * p].unflatten(-1, (h, p)).transpose(1, 2),
             dtv.to(cuda).transpose(1, 2), torch.from_numpy(a).to(cuda),
             xbc[..., h * p: h * p + n], xbc[..., h * p + n:])
    y, h_final = ops.ssd_scan(*views)
    y_ref, h_ref = ssd_scan_reference(*views)
    _check_close(y, y_ref, 0.0)
    _check_close(h_final, h_ref, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_starts_from_initial_state(cuda, dtype):
    b, h, l, p, n = 2, 4, 100, 64, 128
    x, dt, a, bm, cm = (torch.from_numpy(v).to(cuda)
                        for v in _inputs(b, h, l, p, n, seed=5, slow=True))
    x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
    h0 = torch.randn(b, h, p, n, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5))
    y, h_final = ops.ssd_scan(x, dt, a, bm, cm, h0)
    y_ref, h_ref = ssd_scan_reference(x, dt, a, bm, cm, h0)
    _check_close(y, y_ref, 1e-2 if dtype == torch.bfloat16 else 0.0)
    _check_close(h_final, h_ref, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("l,with_h0", [(2048, False), (1025, False),
                                       (1025, True)],
                         ids=["serve-L", "ragged-1025", "ragged-1025-h0"])
def test_cuda_bf16_kernel_at_serving_heads(cuda, l, with_h0):
    """The tensor-core kernel at mamba2-370m's head geometry (P 64, N 128)
    through the model's strided views, from zero or a given state."""
    b, h, p, n = 2, 4, 64, 128
    x, dt, a, bm, cm = _inputs(b, h, l, p, n, seed=6, slow=True)
    xbc = np.concatenate([x.transpose(0, 2, 1, 3).reshape(b, l, h * p), bm,
                          cm], axis=-1)
    xbc = torch.from_numpy(np.ascontiguousarray(xbc)).to(cuda, torch.bfloat16)
    dtv = torch.from_numpy(np.ascontiguousarray(dt.transpose(0, 2, 1)))
    views = (xbc[..., :h * p].unflatten(-1, (h, p)).transpose(1, 2),
             dtv.to(cuda).transpose(1, 2), torch.from_numpy(a).to(cuda),
             xbc[..., h * p: h * p + n], xbc[..., h * p + n:])
    h0 = torch.randn(b, h, p, n, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(6)) \
        if with_h0 else None
    assert ops._copy_width(views[0], views[3], views[4]) == 8
    before = ops.VARIANT_LAUNCHES["bf16-mma"]
    y, h_final = ops.ssd_scan(*views, h0)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["bf16-mma"] == before + 1
    y_ref, h_ref = ssd_scan_reference(*views, h0)
    _check_close(y, y_ref, 1e-2)
    _check_close(h_final, h_ref, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("off", [4, 2, 1])
def test_cuda_bf16_kernel_narrow_copies(cuda, off):
    """Views whose pointers and strides allow only 8, 4 or 2 B copies."""
    b, h, l, p, n = 2, 4, 130, 64, 32
    xbc = torch.randn(b, l, h * p + 2 * n + off, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(7))
    x, bm, cm = _shifted_views(b, h, l, p, n, off,
                               xbc=xbc.to(torch.bfloat16))
    assert ops._copy_width(x, bm, cm) == off
    _, dt, a, _, _ = _inputs(b, h, l, p, n, seed=7, slow=True)
    dt, a = torch.from_numpy(dt).to(cuda), torch.from_numpy(a).to(cuda)
    y, h_final = ops.ssd_scan(x, dt, a, bm, cm)
    y_ref, h_ref = ssd_scan_reference(x, dt, a, bm, cm)
    _check_close(y, y_ref, 1e-2)
    _check_close(h_final, h_ref, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_of", ["x", "dt", "a", "b", "c"])
def test_cuda_kernel_refuses_a_gradient(cuda, grad_of):
    """The kernel has no backward yet: on CUDA an input that requires grad
    raises under grad mode, and runs without it (torch.no_grad)."""
    x, dt, a, b, c = (torch.from_numpy(t).to(cuda)
                      for t in _inputs(1, 2, 64, 32, 16))
    inputs = dict(x=x, dt=dt, a=a, b=b, c=c)
    inputs[grad_of].requires_grad_()
    before = ops.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(**inputs)
    with torch.no_grad():
        ops.ssd_scan(**inputs)
    assert ops.LAUNCHES == before + 1
