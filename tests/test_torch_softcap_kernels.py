"""The logit cap (cap*tanh(s/cap)) at the kernels' entry points: the plain
versions' cap against the formula, its route through `ops`, the refusal of
a cap that is not positive, and on the card (the `cuda` cases) both
kernels with a cap against their plain versions run in fp32.  This module
imports no jax, so that the card's machine runs it:
`python -m pytest -q -m cuda tests/test_torch_softcap_kernels.py`."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# the card's rule (chip_smoke.py phase 3): 2e-5, plus the bf16 output's
# one rounding
CARD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}


def inputs(shape_q, shape_kv, seed: int, spread: float, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(*shape_q, generator=g) * spread
    k = torch.randn(*shape_kv, generator=g) * spread
    v = torch.randn(*shape_kv, generator=g)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("softcap", [50.0, 5.0])
def test_plain_versions_cap_the_scaled_scores(softcap):
    """One query head against one key head: the capped plain versions are
    the softmax of cap*tanh((q.k/sqrt(d))/cap) over the visible keys."""
    q, k, v = inputs((1, 3, 1, 16), (1, 3, 1, 16), 0, 3.0)
    s = (q[0, :, 0] @ k[0, :, 0].T) / 4.0
    s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(torch.ones(3, 3, dtype=torch.bool).triu(1), -math.inf)
    want = torch.softmax(s, -1) @ v[0, :, 0]
    got = fa.flash_attention_plain(q, k, v, causal=True, softcap=softcap)
    torch.testing.assert_close(got[0, :, 0], want, atol=1e-6, rtol=1e-6)
    got = da.decode_attention_plain(q[:, 2:], k, v, 3, softcap)
    torch.testing.assert_close(got[0, 0, 0], want[2], atol=1e-6, rtol=1e-6)


def test_ops_route_the_cap_to_the_plain_versions_on_the_cpu():
    q, k, v = inputs((2, 8, 4, 16), (2, 8, 2, 16), 1, 3.0)
    for cap in (None, 7.0):
        assert torch.equal(ops.flash_attention(q, k, v, softcap=cap),
                           fa.flash_attention_plain(q, k, v, softcap=cap))
        assert torch.equal(ops.decode_attention(q[:, :1], k, v, 5, cap),
                           da.decode_attention_plain(q[:, :1], k, v, 5, cap))
    assert not torch.equal(ops.flash_attention(q, k, v, softcap=1.0),
                           ops.flash_attention(q, k, v))


@pytest.mark.parametrize("bad", [0.0, -1.0, float("inf"), float("nan")])
def test_kernels_refuse_a_cap_that_is_not_positive(bad):
    q = torch.zeros(1, 1, 2, 8)
    with pytest.raises(ValueError, match="softcap"):
        da.decode_attention_plain(q, q, q, 1, bad)
    with pytest.raises(ValueError, match="softcap"):
        fa.flash_attention_plain(q, q, q, softcap=bad)
    assert ref.check_softcap(None) == 0.0 and ref.check_softcap(5) == 5.0


def test_capped_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, q, q, 1, 50.0)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q, softcap=50.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [50.0, 5.0])
@pytest.mark.parametrize("H,Hk,d", [(16, 16, 256), (32, 8, 80),
                                    (32, 8, 128)])
def test_capped_kernels_on_card(dtype, softcap, H, Hk, d):
    """Both kernels with a cap against their plain versions in fp32 on the
    same inputs, scores spread to about 30 (17 for the fp32 flash kernel,
    as in chip_smoke.py phase 3), under the card's rule; and the cap
    bites."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.cuda() for t in inputs((2, 1, H, d), (2, 512, Hk, d), 2,
                                        2.5, dtype))
    lens = torch.tensor([300, 512], dtype=torch.int32, device="cuda")
    before = da.launches
    out = ops.decode_attention(q, k, v, lens, softcap)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    want = da.decode_attention_plain(q.float(), k.float(), v.float(), lens,
                                     softcap)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])
    free = da.decode_attention_plain(q.float(), k.float(), v.float(), lens)
    assert float((want - free).abs().max()) > 1e-2
    spread = 2.5 if dtype == torch.bfloat16 else 1.8
    q, k, v = (t.cuda() for t in inputs((1, 300, H, d), (1, 300, Hk, d), 3,
                                        spread, dtype))
    out = ops.flash_attention(q, k, v, causal=True, softcap=softcap)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=True, softcap=softcap)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=CARD_RTOL[dtype])
