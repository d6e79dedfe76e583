"""The port's int8 KV-cache quantization (`serving/kv_quant.py`) and
gradient compression (`runtime/compression.py`) against `repro`'s, on the
same arrays, at the bounds of tests/test_serving_extras.py:17-43 and
tests/test_infra.py:108."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.runtime import compression as JC
from repro.serving import kv_quant as JQ
from repro_torch.kernels import ref
from repro_torch.runtime import compression as C
from repro_torch.serving import kv_quant as Q


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("B,S,H,seed", [(1, 4, 1, 0), (2, 37, 3, 1),
                                        (3, 64, 4, 2)])
def test_kv_quantize_matches_jax_and_stays_within_a_quantum(B, S, H, seed):
    kv = normal((B, S, H, 16), seed, 3.0)
    q, scale = Q.kv_quantize(torch.from_numpy(kv))
    jq, jscale = JQ.kv_quantize(jnp.asarray(kv))
    assert q.dtype == torch.int8 and scale.dtype == torch.float16
    assert tuple(scale.shape) == (B, S, H, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = Q.kv_dequantize(q, scale)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JQ.kv_dequantize(jq, jscale)))
    # at most one quantum off (tests/test_serving_extras.py:17-26)
    assert float((back - torch.from_numpy(kv)).abs().max()) <= \
        float(np.abs(kv).max()) / 127.0 + 1e-6


@pytest.mark.parametrize("kv_len", [100, [1, 128]])
def test_quantized_decode_attention_matches_jax(kv_len):
    """Against `repro`'s quantized decode (fp32 limit) and within 2e-2 of
    the fp32 oracle on the unquantized cache."""
    B, S, H, Hk, d = 2, 128, 8, 2, 64
    q, k, v = normal((B, 1, H, d), 0), normal((B, S, Hk, d), 1), \
        normal((B, S, Hk, d), 2)
    kq, ks = Q.kv_quantize(torch.from_numpy(k))
    vq, vs = Q.kv_quantize(torch.from_numpy(v))
    lens = np.asarray(kv_len, np.int32)
    out = Q.decode_attention_quantized(torch.from_numpy(q), kq, ks, vq, vs,
                                       torch.from_numpy(lens))
    jkq, jks = JQ.kv_quantize(jnp.asarray(k))
    jvq, jvs = JQ.kv_quantize(jnp.asarray(v))
    # compiled whole: op by op each small operation compiles on its own
    want = jax.jit(functools.partial(JQ.decode_attention_quantized,
                                     kv_len=jnp.asarray(lens)))(
        jnp.asarray(q), jkq, jks, jvq, jvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    oracle = ref.decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(
        jax.jit(jax_ref.decode_attention_reference)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens))), atol=2e-5, rtol=2e-5)


def test_quantized_cache_bytes_match_jax():
    for shape in [(128, 32768, 8, 128), (1, 1, 1, 1)]:
        assert Q.quantized_cache_bytes(*shape) == \
            JQ.quantized_cache_bytes(*shape)
    full_bf16 = 2 * 128 * 32768 * 8 * 128 * 2
    assert Q.quantized_cache_bytes(128, 32768, 8, 128) * 2 < full_bf16 * 0.55


@pytest.mark.parametrize("mode,max_rel", [("int8", 0.02), ("topk", 1.0)])
def test_grad_compression_matches_jax(mode, max_rel):
    """Two rounds with error feedback on a dict of gradients: the decoded
    gradients, residuals and byte counts are `repro`'s, within the bounds of
    tests/test_infra.py:108."""
    g = {"a": normal((64, 64), 0), "b": normal((128,), 1)}
    comp, jcomp = C.GradCompressor(mode=mode, k_frac=0.2), \
        JC.GradCompressor(mode=mode, k_frac=0.2)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    state, jstate = comp.init(tg), jcomp.init(jg)
    for _ in range(2):
        dec, state, wire, raw = comp.compress_decompress(tg, state)
        jdec, jstate, jwire, jraw = jcomp.compress_decompress(jg, jstate)
        assert (wire, raw) == (jwire, jraw) and wire < raw * 0.5
        for k in g:
            np.testing.assert_allclose(dec[k].numpy(), np.asarray(jdec[k]),
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(state.residual[k].numpy(),
                                       np.asarray(jstate.residual[k]),
                                       atol=1e-6, rtol=1e-6)
    if mode == "int8":
        err = float((dec["a"] - tg["a"]).abs().max() / tg["a"].abs().max())
        assert err < max_rel
    else:
        assert sum(float(r.abs().sum()) for r in state.residual.values()) > 0


def test_compressor_keeps_a_list_of_gradients_and_refuses_a_bad_mode():
    grads = [torch.ones(3), torch.arange(4.0).reshape(2, 2)]
    comp = C.GradCompressor("topk", k_frac=0.5)
    dec, state, _, _ = comp.compress_decompress(grads, comp.init(grads))
    assert isinstance(dec, list) and [tuple(t.shape) for t in dec] == [
        (3,), (2, 2)]
    assert isinstance(state.residual, list)
    with pytest.raises(ValueError, match="mode"):
        C.GradCompressor("fp8")


def test_int8_and_topk_codecs_match_jax():
    x = normal((10, 7), 3)
    q, scale = C.int8_encode(torch.from_numpy(x))
    jq, jscale = JC.int8_encode(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    vals, idx, shape = C.topk_encode(torch.from_numpy(x), 0.1)
    jvals, jidx, jshape = JC.topk_encode(jnp.asarray(x), 0.1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert shape == tuple(jshape)
    np.testing.assert_array_equal(C.topk_decode(vals, idx, shape).numpy(),
                                  np.asarray(JC.topk_decode(jvals, jidx,
                                                            jshape)))
