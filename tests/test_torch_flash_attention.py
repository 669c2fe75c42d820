"""The port's flash attention: its plain version against the JAX package's
Pallas kernel (interpret mode) and oracle on the CPU, and the CUDA kernel
against the plain version on the card (skipped without one).

JAX is imported only by the test that needs it, so that the CUDA tests
also run on a machine with PyTorch and no JAX:
``python -m pytest tests/test_torch_flash_attention.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_reference

import torch_threads  # noqa: F401,E402  (caps torch's threads)

# the cases of tests/test_kernels.py::FLASH_CASES
FLASH_CASES = [
    # b, h, kvh, sq, sk, d, causal, window, softcap
    (2, 4, 4, 128, 128, 64, True, 0, 0.0),
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),       # GQA
    (1, 8, 1, 96, 96, 64, True, 0, 0.0),         # MQA, ragged edge
    (2, 4, 4, 128, 128, 64, True, 48, 0.0),      # sliding window
    (2, 4, 4, 128, 128, 64, True, 0, 30.0),      # softcap
    (2, 4, 4, 64, 64, 64, False, 0, 0.0),        # non-causal (encoders)
    (1, 2, 2, 64, 192, 32, True, 0, 0.0),        # cross lengths
    (2, 4, 4, 128, 128, 128, True, 32, 50.0),    # everything at once
    (1, 2, 2, 96, 96, 100, True, 0, 0.0),        # llama-3b's head dim
    (1, 2, 2, 65, 65, 104, False, 0, 0.0),       # vit-g's, ragged edge
]
CASE_IDS = ["mha", "gqa", "mqa-ragged", "window", "softcap", "noncausal",
            "cross", "all", "d100", "d104-ragged"]
# what only the card runs: gemma-2b's MQA head of 256, vit-e's 112, a
# ragged length past one tile of 64 rows
CUDA_CASES = FLASH_CASES + [
    (1, 8, 1, 128, 128, 256, True, 0, 0.0),
    (1, 4, 4, 96, 96, 112, False, 0, 0.0),
    (1, 4, 4, 200, 200, 128, True, 0, 0.0),
]
CUDA_IDS = CASE_IDS + ["d256-mqa", "d112", "ragged-200"]
# |kernel - plain| <= atol + rtol |plain|: fp32 sum-order noise; in bf16,
# one rounding step of the output on top (both round one fp32 result)
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-3, 1e-2)}


def _qkv(b, h, kvh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,softcap",
                         FLASH_CASES, ids=CASE_IDS)
def test_plain_matches_pallas_and_oracle(b, h, kvh, sq, sk, d, causal,
                                         window, softcap):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention as jax_flash
    from repro.kernels.flash_attention.ref import \
        attention_reference as jax_ref
    q, k, v = _qkv(b, h, kvh, sq, sk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_flash(jq, jk, jv, block_q=32, block_kv=32,
                                  interpret=True, **kw))
    oracle = np.asarray(jax_ref(jq, jk, jv, **kw))
    before = ops.LAUNCHES
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              **kw)
    assert ops.LAUNCHES == before          # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    for ref in (pallas, oracle):
        assert np.abs(got.numpy() - ref).max() < 2e-5


def test_strided_views_match_contiguous():
    """attention_apply hands the wrapper transposed (B, S, H, D) views."""
    q, k, v = _qkv(2, 4, 2, 40, 40, 32, seed=1)
    views = [torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views, causal=True, window=7)
    ref = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=7)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bad,err", [
    ({"dtype": torch.float16}, TypeError),
    ({"d": 50}, ValueError),
    ({"kvh": 3}, ValueError),
    ({"stride": True}, ValueError),
    ({"d": 264}, ValueError),
    ({"misaligned": True, "dtype": torch.bfloat16}, ValueError),
])
def test_kernel_checks_refuse(bad, err):
    """What the CUDA kernels do not take is refused before a launch."""
    d, kvh = bad.get("d", 64), bad.get("kvh", 2)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 4, 8, d, dtype=dtype)
    k = torch.zeros(1, kvh, 8, d, dtype=dtype)
    if bad.get("stride"):
        k = torch.zeros(1, kvh, d, 8, dtype=dtype).transpose(2, 3)
    if bad.get("misaligned"):   # S stride 66: not a multiple of 4 elements
        k = torch.zeros(1, kvh, 8, d + 2, dtype=dtype)[..., :d]
    with pytest.raises(err):
        ops._check(q, k, k)


def test_copy_width_follows_alignment():
    """The bf16 kernel copies 16 B where D and every stride allow it, 8 B
    where D is only a multiple of 4 (llama-3b's 100: 200 B rows)."""
    def width(t):
        return ops._check(t, t, t)[1]
    bf = torch.bfloat16
    assert width(torch.zeros(1, 2, 8, 128, dtype=bf)) == 8
    assert width(torch.zeros(1, 2, 8, 100, dtype=bf)) == 4
    assert width(torch.zeros(1, 8, 2, 104, dtype=bf).transpose(1, 2)) == 8
    assert width(torch.zeros(1, 2, 8, 132, dtype=bf)[..., 4:]) == 4
    assert ops._check(*(torch.zeros(1, 2, 8, 100),) * 3)[1] == 1   # fp32


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_arch(a).n_heads])
def test_check_takes_every_config_head_dim(arch):
    """Every registered attention config's head dim passes the kernels'
    checks, in both dtypes and as the model's transposed views."""
    cfg = get_arch(arch)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 4, cfg.n_heads, cfg.head_dim,
                        dtype=dtype).transpose(1, 2)
        k = torch.zeros(1, 4, cfg.n_kv_heads, cfg.head_dim,
                        dtype=dtype).transpose(1, 2)
        ops._check(q, k, k)


def test_build_finds_the_kernel_source():
    srcs = build.sources()
    assert set(srcs) == {"flash_attention", "flash_attention_bwd",
                         "ssd_scan", "ssd_scan_bwd"}
    src = srcs["flash_attention"]
    assert src.read_text().startswith("// Flash attention forward")
    assert srcs["flash_attention_bwd"].read_text().startswith(
        "// Flash attention backward")
    lib = build._lib_path(src)
    assert lib.parent == build.BUILD_DIR and lib.name.endswith(".so")


def _dout(b, h, sq, d, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, h, sq, d)).astype(np.float32)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,softcap",
                         FLASH_CASES, ids=CASE_IDS)
def test_plain_grads_match_jax_dense_attention(b, h, kvh, sq, sk, d, causal,
                                               window, softcap):
    """The plain version's autograd against ``jax.grad`` of the JAX
    package's ``dense_attention`` (what the reference trains through),
    fp32: each grad within 2e-5 of its max|jax grad|."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models.layers.attention import AttnSpec, dense_attention
    q, k, v = _qkv(b, h, kvh, sq, sk, d)
    g = _dout(b, h, sq, d)
    spec = AttnSpec(n_heads=h, n_kv_heads=kvh, head_dim=d, causal=causal,
                    window=window, softcap=softcap)
    qpos = jnp.broadcast_to(jnp.arange(sq), (b, sq))
    kpos = jnp.broadcast_to(jnp.arange(sk), (b, sk))

    def loss(jq, jk, jv):     # (B, S, H, D) layout, as the model passes
        out = dense_attention(jq, jk, jv, spec, qpos, kpos)
        return jnp.sum(out * jnp.asarray(g.transpose(0, 2, 1, 3)))
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=softcap)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, gt, wt in zip("qkv", got, want):
        wt = np.asarray(wt).transpose(0, 2, 1, 3)
        err = np.abs(gt.numpy() - wt).max()
        assert err <= 2e-5 * np.abs(wt).max(), (name, err)


# the backward's small cases on the CPU: those of the forward, gemma-2b's
# MQA head of 256, vit-e's 112, and rows with no live key
BWD_CASES = FLASH_CASES + [
    (1, 8, 1, 128, 128, 256, True, 0, 0.0),
    (1, 4, 4, 96, 96, 112, False, 0, 0.0),
    (1, 2, 2, 96, 32, 64, True, 16, 0.0),
]
BWD_IDS = CASE_IDS + ["d256-mqa", "d112", "masked-rows"]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_bf16_backward(q, k, v, dout, causal, window, softcap,
                           lo=True):
    """dq, dk, dv with the roundings of the bf16 tensor-core backward
    kernels: bf16 q, k, v, dO; S and dP products of those in fp32; P and
    D_i = sum_j P dP in fp32; P and dS enter their products as hi =
    bf16(x) plus lo = bf16(x - hi) (hi alone if not ``lo``); fp32 sums (a
    GQA group's too); each grad rounded to bf16 once."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    q, k, v, dout = (_bf16(t) for t in (q, k, v, dout))
    k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    scale = d ** -0.5
    x = q @ k.transpose(-1, -2) * scale
    dcap = torch.ones_like(x)
    if softcap > 0:
        th = torch.tanh(x / softcap)
        x, dcap = softcap * th, 1 - th * th
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        live &= kp <= qp
    if window > 0:
        live &= qp - kp < window
    lse = torch.logsumexp(x.masked_fill(~live, float("-inf")), dim=-1,
                          keepdim=True)
    p = torch.where(live, torch.exp(x - lse), torch.zeros(()))
    dp = dout @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * dcap

    def hilo(t):
        hi = _bf16(t)
        return (hi, _bf16(t - hi)) if lo else (hi,)

    def group_sum(t):
        return t.view(b, kvh, rep, sk, d).sum(2)
    dq = sum(part @ k for part in hilo(ds)) * scale
    dk = group_sum(sum(part.transpose(-1, -2) @ q
                       for part in hilo(ds))) * scale
    dv = group_sum(sum(part.transpose(-1, -2) @ dout for part in hilo(p)))
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _bf16_design_excess(case, lo=True):
    """The emulated bf16 backward's largest error over the tolerance
    (1e-3 max|plain| + 1e-2 |plain|) of dq, dk, dv on ``case``, against
    the plain version's autograd on the same bf16 inputs; rows with no
    live key take dO = 0, as on the card."""
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(b, h, kvh, sq, sk, d))
    dead = torch.from_numpy(_dead_rows(sq, sk, causal, window))
    dout = torch.from_numpy(_dout(b, h, sq, d)).to(torch.bfloat16) \
        .masked_fill(dead[:, None], 0)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _emulate_bf16_backward(q, k, v, dout, lo=lo, **kw)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(attention_reference(q, k, v, **kw),
                               (q, k, v), dout)
    excess = 0.0
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype == torch.bfloat16
        gt, wt = gt.float(), wt.float()
        scale = wt.abs().max()
        assert scale > 0
        excess = max(excess, ((gt - wt).abs()
                              / (1e-3 * scale + 1e-2 * wt.abs())).max().item())
    return excess


def test_bf16_backward_design_needs_the_lo_planes():
    """Without the lo planes of P and dS (each product on bf16(x) alone)
    the emulated design misses the bf16 tolerance: the split is needed."""
    assert max(_bf16_design_excess(c, lo=False) for c in BWD_CASES) > 1.0


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,softcap",
                         BWD_CASES, ids=BWD_IDS)
def test_bf16_backward_design_within_tolerance(b, h, kvh, sq, sk, d, causal,
                                               window, softcap):
    """The bf16 backward kernels' numerical design, emulated in plain
    torch on the CPU, against the plain version's autograd on the same
    bf16 inputs: each grad elementwise within 1e-3 max|plain| + 1e-2
    |plain|, the tolerance the kernels are held to on the card.  Rows with
    no live key take dO = 0, as there."""
    case = (b, h, kvh, sq, sk, d, causal, window, softcap)
    assert _bf16_design_excess(case) <= 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,softcap",
                         CUDA_CASES, ids=CUDA_IDS)
def test_cuda_kernel_matches_plain(cuda, b, h, kvh, sq, sk, d, causal,
                                   window, softcap, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(b, h, kvh, sq, sk, d))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.LAUNCHES
    variant = ops.VARIANTS[dtype]
    before_variant = ops.VARIANT_LAUNCHES[variant]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert ops.VARIANT_LAUNCHES[variant] == before_variant + 1
    ref = attention_reference(q, k, v, **kw).float()
    atol, rtol = TOL[dtype]
    assert ((got.float() - ref).abs() <= atol + rtol * ref.abs()).all()


# the backward's cases on the card: those of the forward, and rows with no
# live key (causal, window 16, Sq > Sk + 15: rows 47.. see none), where the
# kernel gives exactly 0
CUDA_BWD_CASES = CUDA_CASES + [(1, 2, 2, 96, 32, 64, True, 16, 0.0)]
CUDA_BWD_IDS = CUDA_IDS + ["masked-rows"]


def _dead_rows(sq, sk, causal, window):
    """Query rows that no key is live for."""
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    return ~keep.any(axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,window,softcap",
                         CUDA_BWD_CASES, ids=CUDA_BWD_IDS)
def test_cuda_backward_matches_plain(cuda, b, h, kvh, sq, sk, d, causal,
                                     window, softcap, dtype):
    """dq, dk, dv of the backward kernels against the plain version's
    autograd, q, k, v as the model's transposed views: fp32 within 2e-5 of
    max|plain|; bf16 elementwise within 1e-3 max|plain| + 1e-2 |plain|.
    Rows with no live key take dO = 0 here (the plain version spreads such
    a row evenly over the keys, the kernel gives it no gradient); with
    their dO kept the kernel's dq there is exactly 0 and every grad is
    finite."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype).transpose(1, 2)
               .contiguous().transpose(1, 2).requires_grad_()
               for a in _qkv(b, h, kvh, sq, sk, d))
    dead = torch.from_numpy(_dead_rows(sq, sk, causal, window)).to(cuda)
    dout = torch.from_numpy(_dout(b, h, sq, d)).to(cuda, dtype)
    before = dict(ops.BWD_LAUNCHES)
    before_var = dict(ops.BWD_VARIANT_LAUNCHES)
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v),
                              dout.masked_fill(dead[:, None], 0))
    torch.cuda.synchronize()
    assert ops.BWD_LAUNCHES == {n: c + 1 for n, c in before.items()}
    # both kernels of the dtype's variant: bf16 on tensor cores, fp32 FMAs
    assert ops.BWD_VARIANT_LAUNCHES == {
        n: c + 2 * (n == ops.VARIANTS[dtype]) for n, c in before_var.items()}
    ref_out = attention_reference(q, k, v, **kw)
    want = torch.autograd.grad(ref_out, (q, k, v),
                               dout.masked_fill(dead[:, None], 0))
    atol, rtol = (2e-5, 0.0) if dtype == torch.float32 else (1e-3, 1e-2)
    for name, gt, wt in zip("qkv", got, want):
        gt, wt = gt.float(), wt.float()
        scale = wt.abs().max()
        assert ((gt - wt).abs() <= atol * scale + rtol * wt.abs()).all(), \
            (name, (gt - wt).abs().max().item(), scale.item())
    if dead.any():
        out = ops.flash_attention(q, k, v, **kw)
        full = torch.autograd.grad(out, (q, k, v), dout)
        assert all(torch.isfinite(t).all() for t in full)
        assert (full[0][:, :, dead] == 0).all()


# one head dim for each width the bf16 kernels pad to (16 .. 256), most of
# them padded: each width is its own kernel instance
BF16_BWD_DIMS = (8, 28, 44, 64, 76, 96, 108, 128, 140, 160, 172, 192, 204,
                 224, 236, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("d", BF16_BWD_DIMS)
def test_cuda_bf16_backward_every_padded_width(cuda, d):
    """The bf16 tensor-core backward at every padded head dim, GQA, a
    ragged length past two tiles, causal at even widths: dq, dk, dv
    within 1e-3 max|plain| + 1e-2 |plain| of the plain version's
    autograd, on the bf16-mma variant."""
    kw = dict(causal=d % 8 == 0, window=0, softcap=0.0)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16).requires_grad_()
               for a in _qkv(1, 4, 2, 130, 130, d))
    dout = torch.from_numpy(_dout(1, 4, 130, d)).to(cuda, torch.bfloat16)
    before = ops.BWD_VARIANT_LAUNCHES["bf16-mma"]
    got = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v),
                              dout)
    torch.cuda.synchronize()
    assert ops.BWD_VARIANT_LAUNCHES["bf16-mma"] == before + 2
    want = torch.autograd.grad(attention_reference(q, k, v, **kw), (q, k, v),
                               dout)
    for name, gt, wt in zip("qkv", got, want):
        gt, wt = gt.float(), wt.float()
        scale = wt.abs().max()
        assert ((gt - wt).abs() <= 1e-3 * scale + 1e-2 * wt.abs()).all(), \
            (name, (gt - wt).abs().max().item(), scale.item())


@pytest.mark.cuda
def test_cuda_no_grad_skips_the_lse(cuda):
    """Without grad the forward runs alone (serving: no log-sum-exp, no
    autograd node); with grad its output carries the backward."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _qkv(1, 2, 2, 64, 64, 64))
    assert ops.flash_attention(q, k, v).grad_fn is None
    out = ops.flash_attention(q.requires_grad_(), k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
