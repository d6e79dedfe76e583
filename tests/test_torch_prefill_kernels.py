"""The port's flash attention and selective scan against the JAX package:
the plain PyTorch versions vs the JAX oracles (and, for the scan, the Pallas
kernel in interpret mode) over tests/test_kernels.py's sweeps; the CUDA
kernels vs the plain versions on the card.

The Pallas flash kernel does not trace on the installed jax (it calls
`pl.load`), so `repro.kernels.ref.attention_reference` stands in for it.
JAX is imported inside the helpers, so that the module also imports where
only PyTorch is installed and the card-only cases can run there."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import layers as L

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:12
SSM_TOL = 1e-4                                 # tests/test_kernels.py:73
# On the card a kernel is held against the plain version run in fp32 on the
# same inputs: within the fp32 limit, plus, for a bf16 output, its one
# rounding to bf16 (half an ulp, 2**-8 of the value).
CARD_RTOL = {"float32": 2e-5, "bfloat16": 2e-5 + 2**-8}

# tests/test_kernels.py:20-26
FLASH_CASES = [
    (1, 128, 128, 1, 1, 128, True, None),
    (2, 256, 256, 4, 2, 128, True, None),
    (2, 128, 256, 4, 4, 128, False, None),     # cross-attn shape (MHA)
    (1, 256, 256, 8, 2, 128, True, 128),       # GQA + sliding window
    (2, 384, 384, 2, 1, 128, True, 256),       # MQA + window
]
# tests/test_kernels.py:58-62 (the chunk column is the TPU tiling)
SSM_CASES = [
    (1, 64, 128, 16, 16),
    (2, 128, 256, 16, 32),
    (2, 96, 128, 8, 32),
]


def flash_inputs(B, Sq, Skv, H, Hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d), np.float32),
            rng.standard_normal((B, Skv, Hk, d), np.float32),
            rng.standard_normal((B, Skv, Hk, d), np.float32))


def ssm_inputs(B, S, di, N, seed, a_log="shared"):
    """The catalog's recipe: A = -(1..N), the same row for every channel.
    With a_log="per_channel", A_log = log(uniform(0.5, 16)) for each
    (channel, state), drawn after the rest, so that a kernel that reads
    A_log[n] for A_log[c, n], or a neighbour's row, disagrees."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    x = rng.standard_normal((B, S, di), np.float32)
    Bc = rng.standard_normal((B, S, N), np.float32)
    Cc = rng.standard_normal((B, S, N), np.float32)
    if a_log == "per_channel":
        A_log = np.log(rng.uniform(0.5, 16.0, (di, N))).astype(np.float32)
    else:
        A_log = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                       (di, N))).copy()
    return dt, x, Bc, Cc, A_log


def ssm_params(cases):
    """pytest params of (B, S, di, N, chunk, a_log) cases: the shared-A
    cases keep pytest's own ids, the others end in their A_log kind."""
    return [pytest.param(*c, id="-".join(map(str, c[:5])) + (
        "" if c[5] == "shared" else f"-{c[5]}")) for c in cases]


def to_torch(arrays, dtype="float32"):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hk,d,causal,window", FLASH_CASES)
def test_plain_flash_attention_vs_jax(dtype, B, Sq, Skv, H, Hk, d, causal,
                                      window):
    import jax.numpy as jnp

    from repro.kernels import ref
    q, k, v = flash_inputs(B, Sq, Skv, H, Hk, d, seed=B * Sq + H)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v))
    want = np.asarray(ref.attention_reference(jq, jk, jv, causal=causal,
                                              window=window), np.float32)
    tq, tk, tv = to_torch((q, k, v), dtype)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,di,N,chunk,a_log", ssm_params(
    [(*c, "shared") for c in SSM_CASES]
    + [(*c, "per_channel") for c in SSM_CASES]))
def test_plain_ssm_scan_vs_jax(B, S, di, N, chunk, a_log):
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.ssm_scan import ssm_scan
    arrays = ssm_inputs(B, S, di, N, seed=S + di, a_log=a_log)
    j = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(ssm_scan(*j, chunk=chunk, interpret=True))
    oracle = np.asarray(ref.ssm_scan_reference(*j))
    got = ss.ssm_scan_plain(*to_torch(arrays))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kernel, atol=SSM_TOL, rtol=SSM_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, atol=SSM_TOL, rtol=SSM_TOL)


def test_ops_take_plain_versions_on_cpu():
    q, k, v = to_torch(flash_inputs(1, 64, 64, 4, 2, 64, seed=0))
    arrays = to_torch(ssm_inputs(1, 16, 32, 8, seed=0))
    before = (fa.launches, ss.launches)
    out = ops.flash_attention(q, k, v, causal=True, window=8)
    y = ops.ssm_scan(*arrays)
    assert (fa.launches, ss.launches) == before == (0, 0)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, window=8))
    assert torch.equal(y, ss.ssm_scan_plain(*arrays))


def test_ssm_plain_casts_to_fp32():
    arrays = ssm_inputs(1, 16, 32, 8, seed=3)
    y32 = ss.ssm_scan_plain(*to_torch(arrays))
    ybf = ss.ssm_scan_plain(*to_torch(arrays, "bfloat16"))
    assert ybf.dtype == torch.float32
    want = ss.ssm_scan_plain(*[t.float() for t in to_torch(arrays, "bfloat16")])
    assert torch.equal(ybf, want)
    assert not torch.equal(ybf, y32)


@pytest.mark.parametrize("shape,dtype,window,match", [
    ((1, 64, 64, 4, 2, 12), torch.float32, None, "head_dim"),
    ((1, 64, 64, 4, 2, 264), torch.float32, None, "head_dim"),
    ((1, 64, 64, 6, 4, 64), torch.float32, None, "multiple of Hk"),
    ((1, 64, 64, 4, 2, 64), torch.float16, None, "dtypes"),
    ((1, 64, 64, 4, 2, 64), torch.float32, 0, "window"),
    ((1, 64, 8, 4, 2, 64), torch.float32, 4, "see no key"),
])
def test_flash_rejects_what_the_kernel_does_not_take(shape, dtype, window,
                                                     match):
    B, Sq, Skv, H, Hk, d = shape
    q = torch.zeros(B, Sq, H, d, dtype=dtype)
    k = torch.zeros(B, Skv, Hk, d, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k, causal=False, window=window)


def test_flash_window_edge_is_accepted():
    """The last row that still sees a key (Sq - 1 == Skv + window - 2)."""
    q, k, v = to_torch(flash_inputs(1, 11, 8, 2, 1, 16, seed=5))
    out = ops.flash_attention(q, k, v, causal=False, window=4)
    assert bool(torch.isfinite(out).all())


def test_split_p_meets_the_card_rule_and_one_rounding_does_not():
    """Why the tensor-core flash kernel splits P into two bf16 terms.  Its
    P.V emulated in fp32 (exact row max and sum; P V accumulated in fp32
    from bf16 operands), causal S 256, d 64, two heads of bf16 inputs: with
    P = P_hi + P_lo the bf16 output meets the card's rule against the fp32
    oracle (atol 2e-5, rtol 2e-5 + 2**-8); with P rounded once to bf16 it
    misses the rule some 30-fold."""
    S, d, H = 256, 64, 2
    q, k, v = (t.bfloat16() for t in to_torch(flash_inputs(1, S, S, H, H, d,
                                                           seed=11)))
    want = ref.attention_reference(q.float(), k.float(), v.float(),
                                   causal=True)
    limit = 2e-5 + (2e-5 + 2**-8) * want.abs()
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) / math.sqrt(d)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()

    def worst(pv):             # error over the limit, after the bf16 output
        out = (pv / l).transpose(1, 2).bfloat16().float()
        return float(((out - want).abs() / limit).max())

    assert worst(hi @ vf + lo @ vf) <= 1.0
    assert worst(hi @ vf) > 10.0


def test_tile_plan_covers_every_head_width():
    """Every head width the wrapper takes maps to a bf16 class that holds it,
    the least such class, with the tile sizes the CUDA source has."""
    for d in range(8, fa.MAX_HEAD_DIM + 1, 8):
        plan = fa.tile_plan(d)
        dp, bq, bk = plan
        assert plan in fa._CLASSES and bq % 64 == 0 and bk % 16 == 0
        assert d <= dp and all(c < d for c, _, _ in fa._CLASSES if c < dp)
    assert [fa.tile_plan(d)[0] for d in (24, 64, 80, 128, 136, 256)] == \
        [64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head_dim"):
        fa.tile_plan(264)


@pytest.mark.parametrize("dims,match", [
    (dict(N=3), "state dim"),
    (dict(N=64), "state dim"),
    (dict(x_S=5), "dt and x"),
    (dict(A_di=7), "A_log"),
    (dict(B_S=5), "B and C"),
])
def test_ssm_rejects_what_the_kernel_does_not_take(dims, match):
    B, S, di, N = 1, 8, 16, dims.get("N", 8)
    dt = torch.zeros(B, S, di)
    x = torch.zeros(B, dims.get("x_S", S), di)
    Bc = torch.zeros(B, dims.get("B_S", S), N)
    Cc = torch.zeros(B, S, N) if "B_S" not in dims else torch.zeros(B, 5, N + 1)
    A_log = torch.zeros(dims.get("A_di", di), N)
    with pytest.raises(ValueError, match=match):
        ops.ssm_scan(dt, x, Bc, Cc, A_log)


def test_kernels_refuse_cpu_tensors():
    q, k, v = to_torch(flash_inputs(1, 64, 64, 4, 2, 64, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_cuda(*to_torch(ssm_inputs(1, 8, 16, 8, seed=1)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hk,d,causal,window", FLASH_CASES + [
    (1, 128, 128, 4, 2, 64, True, None),        # the catalog's flash-prefill
    (1, 200, 300, 4, 2, 80, True, None),        # ragged tiles, d 80
    (2, 100, 100, 6, 2, 24, False, 50),         # window without causal
    (1, 64, 64, 2, 1, 256, True, None),         # d 256
    # the tensor-core kernel's edges: Sq 1, 63, 65, 200; Sq != Skv; a
    # window without causal at d 24; d 256 with a window
    (1, 1, 1, 2, 1, 128, True, None),
    (1, 1, 77, 4, 2, 64, False, None),
    (2, 63, 63, 4, 2, 128, True, None),
    (1, 65, 130, 4, 1, 80, True, None),
    (1, 200, 200, 2, 2, 256, True, 64),
    (1, 96, 160, 4, 2, 24, False, 40),
    # seamless-m4t-medium's encoder (non-causal, d 64, MHA), its cross
    # attention (Sq != Skv) and its decoder's self attention;
    # granite-moe-1b-a400m (d 64, G 2); pixtral-12b (1024 patches + 1024
    # tokens, d 128, G 4)
    (2, 1024, 1024, 16, 16, 64, False, None),
    (2, 512, 1024, 16, 16, 64, False, None),
    (2, 512, 512, 16, 16, 64, True, None),
    (2, 2048, 2048, 16, 8, 64, True, None),
    (1, 2048, 2048, 32, 8, 128, True, None),
    # deepseek-v2-lite-16b's MLA prefill: q.k width 192 (the 256 class; v
    # zero-padded to it), MHA, B2 x 2048; its SMOKE width 24 (16 + 8)
    (2, 2048, 2048, 16, 16, 192, True, None),
    (2, 19, 19, 4, 4, 24, True, None),
])
def test_flash_kernel_vs_plain_on_card(dtype, B, Sq, Skv, H, Hk, d, causal,
                                       window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.cuda() for t in to_torch(
        flash_inputs(B, Sq, Skv, H, Hk, d, seed=2), dtype))
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_reads_strided_views_on_card(dtype):
    """K and V as the first Hk heads of a cache with room for 2*Hk, q as a
    slice of a wider projection: the kernel follows the strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, Sq, Skv, H, Hk, d = 2, 130, 200, 4, 2, 80
    rng = np.random.default_rng(7)
    big_q = torch.from_numpy(rng.standard_normal((B, Sq, 2 * H, d),
                                                 np.float32))
    big = torch.from_numpy(rng.standard_normal((2, B, Skv, 2 * Hk, d),
                                               np.float32))
    big_q, big = (t.to(getattr(torch, dtype)).cuda() for t in (big_q, big))
    q, k, v = big_q[:, :, H:], big[0][:, :, :Hk], big[1][:, :, Hk:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    out = ops.flash_attention(q, k, v, causal=True, window=96)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=True, window=96)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])


SSM_CARD_CASES = SSM_CASES + [
    (2, 64, 128, 8, 16),                        # the catalog's ssm-scan
    (1, 100, 70, 4, 1),                         # ragged steps and channels
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,chunk,a_log", ssm_params(
    [(*c, "shared") for c in SSM_CARD_CASES]
    + [(*c, "per_channel") for c in SSM_CARD_CASES + [
        (1, 33, 36, 1, 1),                      # N 1 and 2, channels not
        (3, 17, 44, 2, 1),                      # a multiple of a block
        (1, 70, 130, 32, 1),                    # N 32
    ]]))
def test_ssm_kernel_vs_plain_on_card(B, S, di, N, chunk, a_log):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = [t.cuda() for t in to_torch(ssm_inputs(B, S, di, N, seed=2,
                                                    a_log=a_log))]
    before = ss.launches
    out = ops.ssm_scan(*arrays)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    want = ss.ssm_scan_plain(*arrays)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=SSM_TOL, rtol=SSM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dq,dv", [(2, 2048, 16, 192, 128),
                                         (2, 19, 4, 24, 16)])
def test_flash_padded_v_route_on_card(dtype, B, S, H, dq, dv):
    """MLA's prefill route through the kernel: v zero-padded to the q.k
    width, the output cut back, held against the plain version on the
    unpadded inputs (its scale is q's width too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, _ = flash_inputs(B, S, S, H, H, dq, seed=4)
    v = flash_inputs(B, S, S, H, H, dv, seed=5)[2]
    q, k, v = (t.cuda() for t in to_torch((q, k, v), dtype))
    before = fa.launches
    out = L.pad_v(ops.flash_attention)(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and tuple(out.shape) == (B, S, H, dv)
    want = L.pad_v(fa.flash_attention_plain)(q.float(), k.float(), v.float(),
                                             causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])
