"""The port's decode attention against the JAX package: the plain PyTorch
version vs the Pallas kernel (interpret mode) and the jnp oracle, over
tests/test_kernels.py's decode sweep plus ragged (B,) kv_len.

JAX is imported inside the helpers, so that the module also imports where
only PyTorch is installed and the card-only case can run there."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import layers as L

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# On the card the kernel is held against the plain version run in fp32 on
# the same inputs.  The kernel computes in fp32 whatever the input type, so
# it must agree within the fp32 limit, plus, for a bf16 output, its one
# rounding to bf16: at most half an ulp, 2**-8 of the value.
CARD_RTOL = {"float32": 2e-5, "bfloat16": 2e-5 + 2**-8}

# (B, Skv, H, Hk, d, kv_len, block_k); the ragged rows cross the CUDA
# kernel's tile and split boundaries
CASES = [
    (2, 256, 4, 2, 128, 200, 128),
    (1, 512, 8, 1, 128, 512, 256),      # MQA, full cache
    (3, 256, 4, 4, 128, 17, 128),       # MHA, short prefix
    (3, 256, 4, 2, 128, [1, 100, 256], 128),
    (4, 512, 8, 2, 64, [5, 256, 257, 511], 128),
    (3, 256, 8, 2, 80, [1, 16, 256], 128),   # h2o-danube-1.8b: d 80, G 4
]


def make_inputs(B, Skv, H, Hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, d), np.float32),
            rng.standard_normal((B, Skv, Hk, d), np.float32),
            rng.standard_normal((B, Skv, Hk, d), np.float32))


def jax_outputs(q, k, v, kv_len, block_k, dtype):
    """(Pallas kernel in interpret mode, jnp oracle), as fp32 numpy."""
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.decode_attention import decode_attention
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (q, k, v))
    lens = jnp.asarray(kv_len, jnp.int32)
    out = decode_attention(jq, jk, jv, lens, block_k=block_k, interpret=True)
    want = ref.decode_attention_reference(jq, jk, jv, lens)
    return np.asarray(out, np.float32), np.asarray(want, np.float32)


def to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Skv,H,Hk,d,kv_len,block_k", CASES)
def test_plain_decode_attention_vs_jax(dtype, B, Skv, H, Hk, d, kv_len,
                                       block_k):
    q, k, v = make_inputs(B, Skv, H, Hk, d, seed=Skv + H)
    kernel, oracle = jax_outputs(q, k, v, kv_len, block_k, dtype)
    tq, tk, tv = to_torch((q, k, v), dtype)
    lens = torch.tensor(kv_len)
    plain = da.decode_attention_plain(tq, tk, tv, lens).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(plain, kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(plain, oracle, atol=tol, rtol=tol)


def test_ops_takes_plain_version_on_cpu():
    q, k, v = to_torch(make_inputs(2, 256, 4, 2, 128, seed=0), "float32")
    before = da.launches
    out = ops.decode_attention(q, k, v, torch.tensor([3, 256]))
    assert da.launches == before == 0
    assert torch.equal(out, da.decode_attention_plain(
        q, k, v, torch.tensor([3, 256])))


@pytest.mark.parametrize("shape,dtype,kv_len,match", [
    ((2, 256, 4, 2, 12), torch.float32, 5, "head_dim"),
    ((2, 256, 4, 2, 264), torch.float32, 5, "head_dim"),
    ((2, 256, 32, 2, 64), torch.float32, 5, "multiple of Hk"),
    ((2, 256, 6, 4, 64), torch.float32, 5, "multiple of Hk"),
    ((2, 256, 4, 2, 64), torch.float16, 5, "dtypes"),
    ((2, 256, 4, 2, 64), torch.float32, 0, "kv_len"),
    ((2, 256, 4, 2, 64), torch.float32, [1, 257], "kv_len"),
    ((2, 256, 4, 2, 64), torch.float32, [1, 2, 3], "kv_len"),
])
def test_rejects_what_the_kernel_does_not_take(shape, dtype, kv_len, match):
    B, Skv, H, Hk, d = shape
    q = torch.zeros(B, 1, H, d, dtype=dtype)
    k = torch.zeros(B, Skv, Hk, d, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ops.decode_attention(q, k, k, torch.tensor(kv_len))


@pytest.mark.parametrize("B,Hk,Skv,tile,sms,occ", [
    (1, 1, 64, 32, 132, 8),
    (8, 8, 4096, 32, 132, 4),
    (8, 8, 4096, 16, 132, 8),
    (1, 8, 4096, 32, 132, 4),
    (3, 2, 1000, 64, 132, 3),
    (64, 8, 4096, 32, 132, 4),       # B*Hk beyond one wave: one split
    (2, 1, 4095, 8, 16, 2),
    (4, 2, 129, 32, 132, 4),
])
def test_split_plan_covers_the_cache_in_one_wave(B, Hk, Skv, tile, sms, occ):
    ns, split_len = da.split_plan(B, Hk, Skv, tile, sms, occ)
    assert split_len % tile == 0 and split_len >= tile
    assert (ns - 1) * split_len < Skv <= ns * split_len    # [0, Skv) exactly
    if B * Hk <= sms * occ:
        assert B * Hk * ns <= sms * occ
    else:
        assert ns == 1
    assert ns <= -(-Skv // da.MIN_SPLIT_ROWS)


def test_split_plan_sensible_plans():
    # the main path's decode at full width: 8 splits of 512 rows fill one
    # wave of 4 blocks on each of 132 SMs (512 of 528 places)
    assert da.split_plan(8, 8, 4096, 32, 132, 4) == (8, 512)
    # a lone short sequence and a short capacity take one split
    assert da.split_plan(1, 1, 64, 32, 132, 4) == (1, 64)
    assert da.split_plan(8, 8, 118, 32, 132, 4) == (1, 128)
    assert da.split_plan(8, 8, da.MIN_SPLIT_ROWS, 32, 132, 4)[0] == 1
    # few sequences and a long cache: many splits, still one wave
    assert da.split_plan(1, 1, 4096, 32, 132, 4) == (32, 128)
    with pytest.raises(ValueError):
        da.split_plan(0, 8, 4096, 32, 132, 4)


def test_kernel_refuses_cpu_tensors():
    q, k, v = to_torch(make_inputs(1, 256, 4, 2, 64, seed=1), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, k, v, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Skv,H,Hk,d,kv_len,block_k", CASES + [
    (8, 4096, 32, 8, 128, [1, 17, 512, 1000, 2048, 3000, 4095, 4096], 512),
    (8, 4096, 32, 8, 80, [1, 16, 80, 1000, 2048, 3333, 4095, 4096], 512),
    # kv_len 1 and the capacity, one split and many, G 1, 3 and 8
    (2, 64, 3, 1, 128, [1, 64], 64),
    (2, 4096, 8, 1, 64, [1, 4096], 512),
    (1, 1000, 1, 1, 256, 999, 128),
    (3, 2048, 24, 8, 128, [1, 1500, 2048], 512),
    (4, 1024, 64, 8, 128, [1, 129, 1000, 1024], 256),
    # seamless-m4t-medium's cross attention (d 64, MHA) over 1024 source
    # rows; granite-moe-1b-a400m's self attention (d 64, G 2), ragged and
    # full
    (2, 1024, 16, 16, 64, 1024, 512),
    (8, 4096, 16, 8, 64, [1, 17, 512, 1000, 2048, 3000, 4095, 4096], 512),
    (8, 4096, 16, 8, 64, 4096, 512),
    # deepseek-v2-lite-16b's MLA decode: q.k width 192 (v zero-padded to
    # it), MHA, at B8 on a 4096-row cache, ragged and full; its SMOKE width
    # 24 (16 + 8)
    (8, 4096, 16, 16, 192, [1, 17, 512, 1000, 2048, 3000, 4095, 4096], 512),
    (8, 4096, 16, 16, 192, 4096, 512),
    (3, 40, 4, 4, 24, [1, 20, 40], 64),
])
def test_kernel_vs_plain_on_card(dtype, B, Skv, H, Hk, d, kv_len, block_k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.cuda() for t in to_torch(make_inputs(B, Skv, H, Hk, d, 2),
                                            dtype))
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = da.launches
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    want = da.decode_attention_plain(q.float(), k.float(), v.float(), lens)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Skv,Hk,many", [(2, 64, 2, False),
                                          (1, 4096, 1, True)])
def test_kernel_one_split_and_many_on_card(dtype, B, Skv, Hk, many):
    """A short capacity takes one split (one launch, no merge); a long one
    with few sequences takes many.  Both against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    H, d = 4 * Hk, 128
    q, k, v = (t.cuda() for t in to_torch(make_inputs(B, Skv, H, Hk, d, 3),
                                            dtype))
    lib = da._library()
    ns, split_len = da.split_plan(B, Hk, Skv, *da._card_plan(
        lib, q.device, q.dtype, H, Hk, d))
    assert (ns > 1) == many and ns * split_len >= Skv
    lens = torch.tensor([Skv] * B, dtype=torch.int32, device="cuda")
    out = da.decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    want = da.decode_attention_plain(q.float(), k.float(), v.float(), lens)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Skv,H,dq,dv,kv_len", [
    (8, 4096, 16, 192, 128, [1, 17, 512, 1000, 2048, 3000, 4095, 4096]),
    (3, 40, 4, 24, 16, [1, 20, 40]),
])
def test_padded_v_route_on_card(dtype, B, Skv, H, dq, dv, kv_len):
    """MLA's route through the kernel: v zero-padded to the q.k width, the
    output cut back, held against the plain version on the unpadded
    inputs (its scale is q's width too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, _ = make_inputs(B, Skv, H, H, dq, 4)
    v = make_inputs(B, Skv, H, H, dv, 5)[2]
    q, k, v = (t.cuda() for t in to_torch((q, k, v), dtype))
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = da.launches
    out = L.pad_v(ops.decode_attention)(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.launches == before + 1 and tuple(out.shape) == (B, 1, H, dv)
    want = L.pad_v(da.decode_attention_plain)(q.float(), k.float(),
                                              v.float(), lens)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Skv,H,Hk,d,kv_len,block_k", CASES)
def test_plain_return_lse_is_the_scores_logsumexp(dtype, B, Skv, H, Hk, d,
                                                  kv_len, block_k):
    """return_lse: the plain version's lse equals a logsumexp of the
    materialised fp32 scores over each row's visible keys; its output is
    fp32 whatever q's type, the fp32 softmax times V at 2e-5, and rounded
    to q's type it is the output without return_lse, bit for bit."""
    q, k, v = to_torch(make_inputs(B, Skv, H, Hk, d, 4), dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32).expand(B)
    out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    assert out.shape == (B, 1, H, d) and out.dtype == torch.float32
    assert torch.equal(out.to(q.dtype), ops.decode_attention(q, k, v, lens))
    G = H // Hk
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=2))[:, :, 0] / d**0.5
    s = torch.where(torch.arange(Skv)[None, None] < lens[:, None, None], s,
                    -torch.inf)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5, rtol=1e-6)
    pv = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, -1),
                      v.float().repeat_interleave(G, dim=2))
    np.testing.assert_allclose(out[:, 0].numpy(), pv.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_custom_op_fake_dtypes(dtype, return_lse):
    """The custom op's fake implementation, on meta tensors and under a
    fake-tensor mode: out in q's type without return_lse and fp32 with it
    (the kernel's and the plain version's types), lse (B, H) fp32 or
    empty."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, Skv, H, Hk, d = 2, 64, 8, 2, 32
    dt = getattr(torch, dtype)
    want = torch.float32 if return_lse else dt

    def check(q, k, v, lens):
        out, lse = torch.ops.repro_torch.decode_attention(q, k, v, lens,
                                                          None, return_lse)
        assert out.shape == (B, 1, H, d) and out.dtype == want
        assert lse.dtype == torch.float32
        assert lse.shape == ((B, H) if return_lse else (0,))

    def inputs(device):
        return (torch.empty((B, 1, H, d), dtype=dt, device=device),
                torch.empty((B, Skv, Hk, d), dtype=dt, device=device),
                torch.empty((B, Skv, Hk, d), dtype=dt, device=device),
                torch.full((B,), Skv, dtype=torch.int32, device=device))

    check(*inputs("meta"))
    with FakeTensorMode():
        check(*inputs("cpu"))
    out, lse = torch.ops.repro_torch.decode_attention(
        *to_torch(make_inputs(B, Skv, H, Hk, d, 6), dtype),
        torch.full((B,), Skv, dtype=torch.int32), None, return_lse)
    assert out.dtype == want and lse.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Skv,H,Hk,d,kv_len,block_k", CASES + [
    (8, 4096, 32, 8, 128, [1, 17, 512, 1000, 2048, 3000, 4095, 4096], 512)])
def test_kernel_return_lse_on_card(dtype, B, Skv, H, Hk, d, kv_len, block_k):
    """The kernel's lse (one split and merged splits) against the plain
    version's in fp32 at 2e-5, and its output, fp32 whatever the input
    type (not rounded), at the same fp32 limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.cuda() for t in to_torch(make_inputs(B, Skv, H, Hk, d, 5),
                                            dtype))
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda").expand(B)
    out, lse = ops.decode_attention(q, k, v, lens.contiguous(),
                                    return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = da.decode_attention_plain(q.float(), k.float(),
                                               v.float(), lens,
                                               return_lse=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)
