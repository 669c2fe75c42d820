"""The port's SSD scan: its plain version against the JAX package's Pallas
kernel (interpret mode) and oracles on the CPU, and the CUDA kernel against
the plain version on the card (skipped without one).  The backward: the
plain version's autograd against ``jax.vjp`` of the reference's
``ssd_chunked``, and the backward kernel's chunked algorithm, written out
in plain torch, against the plain version's autograd on the CPU; the
kernel itself against the plain autograd on the card.

JAX is imported only by the tests that need it, so that the CUDA tests
also run on a machine with PyTorch and no JAX:
``python -m pytest tests/test_torch_ssd_scan.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_backward_reference,
                                              ssd_scan_reference)

import torch_threads  # noqa: F401,E402  (caps torch's threads)

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


def test_build_finds_the_backward_kernel_source():
    """The backward kernel is its own source, built beside the forward's;
    it names the TPU kernel whose function it differentiates."""
    src = build.sources()["ssd_scan_bwd"]
    text = src.read_text()
    assert text.startswith("// Backward of the Mamba2 SSD chunked scan")
    assert "src/repro/kernels/ssd_scan/ssd_scan.py:72" in text
    assert 'extern "C" int ssd_scan_bwd(' in text
    assert "ssd_scan_bwd_kernel_mma" in text
    assert "mma.sync.aligned.m16n8k16" in text
    assert "atomicAdd" not in text          # runs repeat bit for bit
    assert build._lib_path(src).parent == build.BUILD_DIR


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::ssd_scan_kernel_mma<64, 128>(Params)",
     "ssd_scan"),
    ("void (anonymous namespace)::ssd_scan_bwd_kernel<__nv_bfloat16, 64, "
     "128>(Params)", "ssd_scan_bwd"),
    ("void (anonymous namespace)::ssd_scan_bwd_kernel_mma<64, 128>(Params)",
     "ssd_scan_bwd"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel_mma<64>(Params)",
     "flash_attention_bwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("void at::native::direct_copy_kernel_cuda", "copy"),
    ("void at::native::vectorized_elementwise_kernel", "elementwise")])
def test_profile_train_names_each_kernel_kind(name, kind):
    """The training profile's kinds: the SSD scan's forward and backward
    kernels apart from each other and from the elementwise work."""
    from repro_torch.launch import profile_train
    assert profile_train._kind(name) == kind


def test_dtype_picks_the_variant():
    """bf16 goes to the tensor-core kernels, fp32 to the FMA kernels, in
    the forward and in the backward; every variant has a launch count, and
    the CPU path moves none of them."""
    want = {torch.float32: "fp32-fma", torch.bfloat16: "bf16-mma"}
    assert ops.VARIANTS == want and ops.BWD_VARIANTS == want
    assert set(ops.VARIANT_LAUNCHES) == set(ops.VARIANTS.values())
    assert set(ops.BWD_VARIANT_LAUNCHES) == set(ops.BWD_VARIANTS.values())
    assert set(ops.VARIANTS) == set(ops._DTYPES)
    before = (dict(ops.VARIANT_LAUNCHES), dict(ops.BWD_VARIANT_LAUNCHES))
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _inputs(1, 2, 16, 32, 16))
    for dtype in ops.VARIANTS:
        ins = [t.to(dtype).requires_grad_() for t in (x, bm, cm)]
        y, _ = ops.ssd_scan(ins[0], dt, a, ins[1], ins[2])
        y.float().sum().backward()
    assert (ops.VARIANT_LAUNCHES, ops.BWD_VARIANT_LAUNCHES) == before


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


def _cotangents(b, h, l, p, n, seed=9):
    """h0, dy, dh_final as fp32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, p, n)).astype(np.float32),
            rng.standard_normal((b, h, l, p)).astype(np.float32),
            rng.standard_normal((b, h, p, n)).astype(np.float32))


GRAD_NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("b,h,l,p,n,chunk", SSD_CASES, ids=CASE_IDS)
def test_plain_backward_matches_jax(b, h, l, p, n, chunk, with_h0):
    """Autograd of the plain version against ``jax.vjp`` of the reference's
    ``ssd_chunked`` (layout (B, L, H, P)), cotangents on y and on the final
    state.  dx, db, dc and dh0 within 1e-5 of their max (fp32 sums in
    another order: sequential against chunked); ddt and da within 1e-4,
    since both sum terms through the decays, which cancel in part."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.layers.ssd import ssd_chunked
    x, dt, a, bm, cm = _inputs(b, h, l, p, n, seed=8)
    h0, dy, dh_final = _cotangents(b, h, l, p, n)
    args = [jnp.asarray(x.transpose(0, 2, 1, 3)),
            jnp.asarray(dt.transpose(0, 2, 1)), jnp.asarray(a),
            jnp.asarray(bm), jnp.asarray(cm)]
    if with_h0:
        args.append(jnp.asarray(h0))
    _, vjp = jax.vjp(lambda *t: ssd_chunked(*t[:5], chunk,
                                            h0=t[5] if with_h0 else None),
                     *args)
    jg = vjp((jnp.asarray(dy.transpose(0, 2, 1, 3)), jnp.asarray(dh_final)))
    want = [np.asarray(jg[0]).transpose(0, 2, 1, 3),
            np.asarray(jg[1]).transpose(0, 2, 1), *jg[2:5],
            jg[5] if with_h0 else None]
    got = ssd_scan_backward_reference(
        *(torch.from_numpy(v) for v in (x, dt, a, bm, cm)),
        torch.from_numpy(h0) if with_h0 else None, torch.from_numpy(dy),
        torch.from_numpy(dh_final))
    for name, g, w in zip(GRAD_NAMES, got, want):
        if w is None:
            assert g is None
            continue
        tol = 1e-4 if name in ("ddt", "da") else 1e-5
        assert _rel(g.numpy(), w) <= tol, name


# The fp32 operands of the bf16 kernel's tensor-core products, each split
# into bf16 hi + lo: B' = B o dt exp(la_Q - la) (the chunk states), M (in
# M^T dy), dS (in dS B and dS^T C), the adjoint g (in B g^T and x g),
# h_prev (in dy h_prev) and el o dy (in the adjoint's update).
SPLIT_OPERANDS = ("b_prime", "m", "ds", "g", "h_prev", "el_dy")


def _chunked_backward(x, dt, a, b, c, h0, dy, dh_final, q=ops.CHUNK,
                      split=None):
    """The backward kernel's algorithm in plain torch, fp32: pass 1 keeps
    each chunk's start state, pass 2 walks the chunks in reverse with the
    adjoint state g, as ``csrc/ssd_scan_bwd.cu`` says; positions past L
    are zeros with dt = 0, da and db, dc are summed over batch and heads
    last.

    ``split`` (a set of names from ``SPLIT_OPERANDS``) emulates the bf16
    kernel instead: x, dy, b, c enter as they are (bf16, exact); each
    fp32 operand of a tensor-core product is rounded to bf16, hi + lo where
    its name is in ``split``, hi alone where it is not; sums stay fp32;
    dx, db and dc are rounded once to bf16 at the end."""
    def rnd(v, name):
        if split is None:
            return v
        hi = v.to(torch.bfloat16).float()
        if name not in split:
            return hi
        return hi + (v - hi).to(torch.bfloat16).float()
    x, b, c, dy = (t.float() for t in (x, b, c, dy))
    bsz, hn, l, p = x.shape
    n = b.shape[-1]
    nc = -(-l // q)
    pad = nc * q - l
    x, dy = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (x, dy))
    dt = torch.nn.functional.pad(dt, (0, pad))
    b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (b, c))
    out = [torch.zeros_like(x), torch.zeros_like(dt), torch.zeros(bsz, hn),
           torch.zeros(bsz, hn, nc * q, n), torch.zeros(bsz, hn, nc * q, n),
           torch.zeros(bsz, hn, p, n)]
    causal = torch.ones(q, q).tril().bool()
    for bi in range(bsz):
        for hi in range(hn):
            def chunk(ci):
                sl = slice(ci * q, (ci + 1) * q)
                d = dt[bi, hi, sl]
                la = torch.cumsum(d * a[hi], 0)
                return (sl, x[bi, hi, sl], d, b[bi, sl], c[bi, sl],
                        dy[bi, hi, sl], la, torch.exp(la),
                        torch.exp(la[-1] - la))
            hs = torch.zeros(p, n) if h0 is None else h0[bi, hi].clone()
            starts = []
            for ci in range(nc):
                _, xc, d, bc, _, _, _, el, w = chunk(ci)
                starts.append(hs)
                hs = el[-1] * hs + xc.T @ rnd(bc * (d * w)[:, None],
                                              "b_prime")
            g = torch.zeros(p, n) if dh_final is None else \
                dh_final[bi, hi].clone()
            for ci in reversed(range(nc)):
                sl, xc, d, bc, cc, dyc, la, el, w = chunk(ci)
                hp = starts[ci]
                gap = torch.where(causal, la[:, None] - la[None, :], 0.0)
                e = torch.where(causal, torch.exp(gap), 0.0)
                m = (cc @ bc.T) * e
                dm = torch.where(causal, (dyc @ xc.T) * d[None, :], 0.0)
                ds, gm = dm * e, dm * m
                gr, dsr = rnd(g, "g"), rnd(ds, "ds")
                bgt = bc @ gr.T
                du = rnd(m, "m").T @ dyc + w[:, None] * bgt
                dw = d * (xc * bgt).sum(1)
                dyh = dyc @ rnd(hp, "h_prev")
                dla = gm.sum(1) - gm.sum(0) + el * (cc * dyh).sum(1) - w * dw
                dla[-1] += el[-1] * (hp * g).sum() + (w * dw).sum()
                out[0][bi, hi, sl] = d[:, None] * du
                out[3][bi, hi, sl] = dsr.T @ cc + (w * d)[:, None] * (xc @ gr)
                out[4][bi, hi, sl] = dsr @ bc + el[:, None] * dyh
                g = el[-1] * g + rnd(el[:, None] * dyc, "el_dy").T @ cc
                dl = dla.flip(0).cumsum(0).flip(0)
                out[1][bi, hi, sl] = (du * xc).sum(1) + a[hi] * dl
                out[2][bi, hi] += (d * dl).sum()
            out[5][bi, hi] = g
    low = (lambda t: t) if split is None else \
        (lambda t: t.to(torch.bfloat16))
    return (low(out[0][:, :, :l]), out[1][:, :, :l], out[2].sum(0),
            low(out[3].sum(1)[:, :l]), low(out[4].sum(1)[:, :l]),
            None if h0 is None else out[5])


@pytest.mark.parametrize("shape,slow,with_h0", [
    ((2, 4, 128, 32, 16), False, False),
    ((1, 2, 96, 64, 32), False, True),        # ragged L
    ((1, 8, 64, 64, 128), True, True),        # mamba2-370m heads
    ((1, 3, 150, 32, 16), True, True),        # ragged, three chunks
], ids=["base", "ragged-h0", "mamba2-like-h0", "ragged-slow-h0"])
def test_chunked_backward_design_matches_plain(shape, slow, with_h0):
    """The kernel's chunked backward (recomputed start states, reverse pass
    with the adjoint state, d la's reverse cumsum) against the plain
    version's autograd: every grad within 1e-4 of its max (fp32 sums in
    another order; the same bound as the kernel's fp32 check)."""
    b, h, l, p, n = shape
    x, dt, a, bm, cm = (torch.from_numpy(v)
                        for v in _inputs(b, h, l, p, n, seed=8, slow=slow))
    h0, dy, dh_final = (torch.from_numpy(v)
                        for v in _cotangents(b, h, l, p, n))
    h0 = h0 if with_h0 else None
    got = _chunked_backward(x, dt, a, bm, cm, h0, dy, dh_final)
    want = ssd_scan_backward_reference(x, dt, a, bm, cm, h0, dy, dh_final)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert _rel(g, w) <= 1e-4, name


# the shapes of test_chunked_backward_design_matches_plain, and mamba2's
# heads over 16 chunks with slow decay (the card's ragged-1000 case)
BF16_DESIGN_CASES = {
    "base": ((2, 4, 128, 32, 16), False, False),
    "ragged-h0": ((1, 2, 96, 64, 32), False, True),
    "mamba2-like-h0": ((1, 8, 64, 64, 128), True, True),
    "ragged-slow-h0": ((1, 3, 150, 32, 16), True, True),
    "mamba2-slow-1000": ((2, 4, 1000, 64, 128), True, False),
}
_BF16_DESIGN = {}


def _bf16_design_case(name):
    """bf16 x, b, c, dy (and fp32 dt, a, h0, dh_final) of a design case,
    and the plain version's autograd on them; cached."""
    if name not in _BF16_DESIGN:
        shape, slow, with_h0 = BF16_DESIGN_CASES[name]
        b, h, l, p, n = shape
        x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                            _inputs(b, h, l, p, n, seed=8, slow=slow))
        h0, dy, dh_final = (torch.from_numpy(v)
                            for v in _cotangents(b, h, l, p, n))
        x, bm, cm, dy = (t.to(torch.bfloat16) for t in (x, bm, cm, dy))
        ins = (x, dt, a, bm, cm, h0 if with_h0 else None, dy, dh_final)
        _BF16_DESIGN[name] = ins, ssd_scan_backward_reference(*ins)
    return _BF16_DESIGN[name]


def _bf16_over(got, want):
    """The largest |got - want| / (1e-3 max|want| + 1e-2 |want|) over
    every grad: at most 1 within the bf16 kernel's tolerance."""
    over = 0.0
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        bound = 1e-3 * w.abs().max() + 1e-2 * w.abs()
        over = max(over, ((g - w).abs() / bound).max().item())
    return over


@pytest.mark.parametrize("name", list(BF16_DESIGN_CASES))
def test_bf16_backward_design_within_tolerance(name):
    """The bf16 kernel's numerical design (bf16 inputs exact, the six fp32
    operands split hi + lo, fp32 sums, dx, db, dc rounded once) against
    the plain version's autograd on the same bf16 inputs, within the
    card's bf16 tolerance 1e-3 max|plain| + 1e-2 |plain| for every grad."""
    ins, want = _bf16_design_case(name)
    got = _chunked_backward(*ins, split=set(SPLIT_OPERANDS))
    assert _bf16_over(got, want) <= 1.0


@pytest.mark.parametrize("operand", SPLIT_OPERANDS)
def test_bf16_backward_needs_each_lo_plane(operand):
    """Rounding any one of the six split operands to bf16 alone (its lo
    plane dropped) misses that tolerance on some design case."""
    overs = {}
    for name in BF16_DESIGN_CASES:
        ins, want = _bf16_design_case(name)
        overs[name] = _bf16_over(
            _chunked_backward(*ins, split=set(SPLIT_OPERANDS) - {operand}),
            want)
        if overs[name] > 1.0:
            return
    pytest.fail(f"{operand} without its lo plane is within the tolerance "
                f"on every case: {overs}")


def test_cpu_gradient_takes_the_plain_version():
    """On the CPU the wrapper differentiates through the plain version: the
    grads are the plain backward's and no kernel is counted."""
    x, dt, a, bm, cm = (torch.from_numpy(v).requires_grad_()
                        for v in _inputs(1, 2, 40, 32, 16, seed=3))
    _, dy, _ = _cotangents(1, 2, 40, 32, 16)
    dy = torch.from_numpy(dy)
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES, dict(ops.BWD_VARIANT_LAUNCHES))
    y, _ = ops.ssd_scan(x, dt, a, bm, cm)
    got = torch.autograd.grad(y, (x, dt, a, bm, cm), dy)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES,
            dict(ops.BWD_VARIANT_LAUNCHES)) == before
    want = ssd_scan_backward_reference(x, dt, a, bm, cm, None, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert set(ops.BWD_VARIANTS) == set(ops._DTYPES)
    assert set(ops.BWD_VARIANT_LAUNCHES) == set(ops.BWD_VARIANTS.values())


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


def _check_grads(got, want, dtype):
    """Each grad against the plain autograd's: fp32 within 1e-4 of its
    max|plain|; bf16 (both compute in fp32 from the same bf16 inputs, then
    round dx, db, dc once to bf16) within 1e-3 max|plain| + 1e-2 |plain|,
    elementwise."""
    rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (0.0, 1e-4)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        bound = atol * w.abs().max() + rtol * w.abs()
        assert bool(((g - w).abs() <= bound).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,slow", [
    ((2, 4, 128, 32, 16), False),
    ((1, 8, 64, 64, 128), False),
    ((2, 4, 1000, 64, 128), True),            # ragged L, slow decay
], ids=["base", "mamba2-like", "ragged-1000"])
def test_cuda_backward_matches_plain(cuda, shape, slow, dtype, with_h0):
    """The backward kernel, through autograd of ``ops.ssd_scan``, against
    the plain version's autograd, cotangents on y and the final state;
    one forward and one backward launch of the dtype's variant (bf16 on
    the tensor-core kernel, ``bf16-mma``)."""
    b, h, l, p, n = shape
    x, dt, a, bm, cm = (torch.from_numpy(v).to(cuda)
                        for v in _inputs(b, h, l, p, n, seed=8, slow=slow))
    h0, dy, dh_final = (torch.from_numpy(v).to(cuda)
                        for v in _cotangents(b, h, l, p, n))
    x, bm, cm, dy = (t.to(dtype) for t in (x, bm, cm, dy))
    h0 = h0 if with_h0 else None
    ins = [t if t is None else t.detach().requires_grad_()
           for t in (x, dt, a, bm, cm, h0)]
    live = [t for t in ins if t is not None]
    variant = {torch.float32: "fp32-fma", torch.bfloat16: "bf16-mma"}[dtype]
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES,
              dict(ops.BWD_VARIANT_LAUNCHES))
    y, h_final = ops.ssd_scan(*ins)
    got = iter(torch.autograd.grad((y, h_final), live, (dy, dh_final)))
    got = [None if t is None else next(got) for t in ins]
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert ops.BWD_VARIANT_LAUNCHES == {
        k: c + (k == variant) for k, c in before[2].items()}
    want = ssd_scan_backward_reference(x, dt, a, bm, cm, h0, dy, dh_final)
    _check_grads(got, want, dtype)


@pytest.mark.cuda
def test_cuda_backward_reads_the_model_views(cuda):
    """mamba2-370m's heads through the strided views ``ssd_apply`` passes
    (x, b, c column slices of one bf16 tensor, dt a transposed view), the
    final state's cotangent unused (None), as in training."""
    b, h, l, p, n = 2, 4, 300, 64, 128
    x, dt, a, bm, cm = _inputs(b, h, l, p, n, seed=6, slow=True)
    xbc = np.concatenate([x.transpose(0, 2, 1, 3).reshape(b, l, h * p), bm,
                          cm], axis=-1)
    xbc = torch.from_numpy(np.ascontiguousarray(xbc)).to(
        cuda, torch.bfloat16).requires_grad_()
    dtv = torch.from_numpy(np.ascontiguousarray(dt.transpose(0, 2, 1))).to(
        cuda).requires_grad_()
    av = torch.from_numpy(a).to(cuda).requires_grad_()
    _, dy, _ = _cotangents(b, h, l, p, n)
    dy = torch.from_numpy(dy).to(cuda, torch.bfloat16)

    def run(fn):
        views = (xbc[..., :h * p].unflatten(-1, (h, p)).transpose(1, 2),
                 dtv.transpose(1, 2), av, xbc[..., h * p: h * p + n],
                 xbc[..., h * p + n:])
        return torch.autograd.grad(fn(*views)[0], (xbc, dtv, av), dy)
    got = run(ops.ssd_scan)
    want = run(ssd_scan_reference)
    torch.cuda.synchronize()
    _check_grads(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_backward_repeats_bit_for_bit(cuda):
    """The backward sums over positions, heads and batch rows in a fixed
    order (no float atomics): two runs give the same bits."""
    b, h, l, p, n = 3, 8, 700, 64, 128
    x, dt, a, bm, cm = (torch.from_numpy(v).to(cuda)
                        for v in _inputs(b, h, l, p, n, seed=4, slow=True))
    h0, dy, dh_final = (torch.from_numpy(v).to(cuda)
                        for v in _cotangents(b, h, l, p, n))
    x, bm, cm, dy = (t.to(torch.bfloat16) for t in (x, bm, cm, dy))
    runs = [ops._backward(x, dt, a, bm, cm, h0, dy, dh_final)
            for _ in range(2)]
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_cuda_no_grad_launches_only_the_forward(cuda):
    """Under ``torch.no_grad`` (serving) an input that requires grad runs
    the forward kernel once and the backward never; with grad mode on, a
    backward launches the backward kernel once."""
    x, dt, a, b, c = (torch.from_numpy(t).to(cuda)
                      for t in _inputs(1, 2, 64, 32, 16))
    x.requires_grad_()
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, dt, a, b, c)
    torch.cuda.synchronize()
    assert not y.requires_grad
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (before[0] + 1, before[1])
    y, _ = ops.ssd_scan(x, dt, a, b, c)
    y.sum().backward()
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (before[0] + 2, before[1] + 1)
