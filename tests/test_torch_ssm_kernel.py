"""What of the selective-scan kernel's design can be checked without a card:
its lane plan over every state width and size, its arithmetic emulated in
fp32 against the reference over a long sequence, the SASS reader that
counts its hot loop's instructions, and the initial and final state (`h0`,
`return_state`) of its plain version, against the Pallas kernel and
`repro`'s Mamba mixer; with a card (`-m cuda`), the kernel's state path
against the plain version."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import sass_mix
from repro_torch.kernels import ssm_scan as ss

SSM_TOL = 1e-4                                 # tests/test_kernels.py:73
H100_SMS = 132
JAMBA = (1, 16384, 16)                         # B, di, N of jamba-1.5-large
CATALOG = (2, 128, 8)                          # the profile catalog's ssm-scan
SIZES = [1, 3, 31, 70, 128, 200, 1000, 2048, 4096, 4225, 5000, 8192, 16384]


@pytest.mark.parametrize("N", ss.STATE_DIMS)
def test_lane_plan_over_every_state_width(N):
    """For B * di from 1 to jamba's: L divides N, the block and the grid are
    within the card's limits, and the plan is the best of the candidates.
    Balance: the busiest SM holds fewer than c * (1 + B / sms) channels
    more than the mean, c being the smallest block's channels (as many
    lanes as N allows); at jamba's width, within 4 % of the mean."""
    for B in (1, 2, 8, 64):
        for di in SIZES:
            for sms in (H100_SMS, 114):
                plan = ss.lane_plan(B, di, N, sms)
                L, C = plan.lanes, plan.channels
                assert L in ss.LANES and N % L == 0
                assert C * L == ss.THREADS <= 1024
                assert plan.blocks == B * math.ceil(di / C) <= 2**31 - 1
                assert plan.busiest == math.ceil(plan.blocks / sms) * C
                assert plan.mean == B * di / sms <= plan.busiest
                for lanes in ss.LANES:
                    if lanes <= N:
                        c = ss.THREADS // lanes
                        alt = math.ceil(B * math.ceil(di / c) / sms) * c
                        assert plan.busiest <= alt
                c_min = ss.THREADS // max(x for x in ss.LANES if x <= N)
                assert plan.busiest - plan.mean < c_min * (1 + B / sms)


def test_lane_plan_at_the_main_shapes():
    jamba = ss.lane_plan(*JAMBA, H100_SMS)
    assert jamba.busiest == 128 and jamba.busiest / jamba.mean < 1.04
    assert jamba.lanes == 2 and jamba.blocks == 2 * H100_SMS - 8
    catalog = ss.lane_plan(*CATALOG, H100_SMS)
    assert catalog.lanes == 4 and catalog.blocks == 8


@pytest.mark.parametrize("args", [(0, 16, 16, 132), (1, 16, 3, 132),
                                  (1, 16, 64, 132), (1, 0, 16, 132),
                                  (1, 16, 16, 0)])
def test_lane_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="lane_plan"):
        ss.lane_plan(*args)


def _fma(a, b, c):
    """fp32 a*b + c with one rounding (the product is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_kernel(dt, x, Bc, Cc, A_log, L, ex2_rel_err, seed=0):
    """The CUDA kernel's arithmetic in fp32, in its order: A2 = -exp(A_log)
    * log2(e) once per (channel, state); each step dA = 2^(dt * A2), off by
    a relative ex2_rel_err of random sign (the SFU's approximation),
    h = fma(dA, h, (dt * x) * B); each of the L lanes sums its N / L states
    in order, y = fma(h, C, y), and the lanes are summed by an xor
    butterfly, as the shuffles do."""
    Bsz, S, di = x.shape
    N = Bc.shape[-1]
    NS = N // L
    gen = torch.Generator().manual_seed(seed)
    a2 = -torch.exp(A_log) * torch.tensor(math.log2(math.e),
                                          dtype=torch.float32)
    h = torch.zeros(Bsz, di, N)
    ys = []
    for t in range(S):
        dtv = dt[:, t, :, None]
        bx = dtv * x[:, t, :, None]
        sign = torch.randint(0, 2, (Bsz, di, N), generator=gen) * 2 - 1
        dA = torch.exp2(dtv * a2) * (1 + ex2_rel_err * sign.float())
        h = _fma(dA, h, bx * Bc[:, t, None, :])
        hv = h.view(Bsz, di, L, NS)
        cv = Cc[:, t].reshape(Bsz, 1, L, NS).expand(Bsz, di, L, NS)
        lane = torch.zeros(Bsz, di, L)
        for k in range(NS):
            lane = _fma(hv[..., k], cv[..., k], lane)
        off = L // 2
        while off:
            lane = lane + lane[..., [j ^ off for j in range(L)]]
            off //= 2
        ys.append(lane[..., 0])
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("L", ss.LANES)
def test_kernel_arithmetic_emulated_meets_the_limit(L):
    """B1 S2048 di8 N16 with A_log drawn per (channel, state): the kernel's
    exp2 of a pre-scaled A, its FMAs and its per-thread order of the state
    sum stay within the 1e-4 limit of the reference, also with every
    factor off by 2**-22 of itself (about 2 ulp)."""
    from test_torch_prefill_kernels import ssm_inputs, to_torch
    arrays = to_torch(ssm_inputs(1, 2048, 8, 16, seed=9, a_log="per_channel"))
    want = ref.ssm_scan_reference(*arrays)
    for err in (0.0, 2.0**-22):
        got = emulate_kernel(*arrays, L=L, ex2_rel_err=err)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=SSM_TOL,
                                   rtol=SSM_TOL)


SASS = """
  Function : _ZN12_GLOBAL__N_115ssm_scan_kernelILi16ELi1EEEvPKfS2_
  /*0000*/ MOV R1, c[0x0][0x28] ; /* 0x00000a0000017a02 */
      /* 0x000fe40000000f00 */
  /*0010*/ S2R R0, SR_TID.X ; /* 0x0000000000007919 */
      /* 0x000e220000002100 */
  /*0020*/ LDS R2, [R0] ; /* 0x0000000000027984 */
      /* 0x000e240000000800 */
  /*0030*/ FMUL R3, R2, R4 ; /* 0x0000000402037220 */
      /* 0x001fca0000400000 */
  /*0040*/ MUFU.EX2 R3, R3 ; /* 0x0000000300037308 */
      /* 0x000e240000000800 */
  /*0050*/ FFMA R5, R3, R5, R6 ; /* 0x0000000503057223 */
      /* 0x001fe20000000006 */
  /*0060*/ SHFL.BFLY PT, R7, R5, 0x1, 0x1f ; /* 0x0c201f0005077f89 */
      /* 0x000fe200000e0000 */
  /*0070*/ MUFU.EX2 R8, R3 ; /* 0x0000000300087308 */
      /* 0x000e240000000800 */
  /*0080*/ IADD3 R0, R0, 0x1, RZ ; /* 0x0000000100007810 */
      /* 0x000fca0007ffe0ff */
  /*0090*/ @P0 BRA 0x20 ; /* 0xffffff8000000947 */
      /* 0x000fea000383ffff */
  /*00a0*/ BAR.SYNC.DEFER_BLOCKING 0x0 ; /* 0x0000000000007b1d */
      /* 0x000fec0000010000 */
  /*00b0*/ @P1 BRA 0x0 ; /* 0xffffff4000001947 */
      /* 0x000fea000383ffff */
  /*00c0*/ EXIT ; /* 0x000000000000794d */
      /* 0x000fea0003800000 */
"""


def test_sass_mix_counts_the_innermost_loop_with_exponentials():
    kernels = sass_mix.parse(SASS)
    (name, insns), = kernels.items()
    assert "ssm_scan_kernel" in name and len(insns) == 13
    mix = sass_mix.hot_loop(insns)
    assert mix["loop"] == "0x20-0x90" and mix["instructions"] == 8
    assert (mix["mio"], mix["mufu"], mix["fp32"], mix["int"],
            mix["other"]) == (2, 2, 2, 1, 1)
    assert mix["mufu_ex2"] == 2 and mix["per_exp"]["mio"] == 1.0
    # stall counts (bits 41-44 of the second word) of 0x20..0x90:
    # 2 + 5 + 2 + 1 + 1 + 2 + 5 + 5
    assert [st for _, _, _, st in insns[2:10]] == [2, 5, 2, 1, 1, 2, 5, 5]
    assert mix["stall_clocks"] == 23
    assert sass_mix.hot_loop(insns[:3]) is None


# ------------------------------------------------ the state in and out (h0)

def _state(B, di, N, seed):
    return np.random.default_rng(seed).standard_normal((B, di, N)).astype(
        np.float32)


@pytest.mark.parametrize("B,S,di,N,chunk,a_log", [
    (1, 64, 128, 16, 16, "shared"),
    (2, 96, 64, 8, 32, "per_channel"),
    (2, 48, 40, 4, 16, "per_channel"),
])
def test_plain_scan_at_zero_state_matches_the_pallas_kernel(B, S, di, N, chunk,
                                                            a_log):
    """h0 = 0 and return_state: y is the Pallas kernel's in interpret mode
    (which takes dt * x premultiplied and S a multiple of its chunk) within
    1e-4; h0=None is the same scan."""
    import jax.numpy as jnp

    from repro.kernels.ssm_scan import ssm_scan as pallas_scan
    from test_torch_prefill_kernels import ssm_inputs, to_torch
    arrays = ssm_inputs(B, S, di, N, seed=S + di, a_log=a_log)
    want = np.asarray(pallas_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                  interpret=True))
    args = to_torch(arrays)
    y, h_last = ss.ssm_scan_plain(*args, h0=torch.zeros(B, di, N),
                                  return_state=True)
    assert tuple(h_last.shape) == (B, di, N) and h_last.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, atol=SSM_TOL, rtol=SSM_TOL)
    assert torch.equal(y, ss.ssm_scan_plain(*args))


def test_h_last_matches_repros_mamba_mixer():
    """The final state of `repro`'s chunked `mamba_mixer` (jamba SMOKE in
    fp32, S 24 in chunks of 8, from a random h0) against the plain scan on
    the mixer's own dt, x_conv, B and C, from the same h0: within 1e-4."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import ssm as JS
    cfg = dataclasses.replace(jax_get_config("jamba-1.5-large-398b",
                                             smoke=True), dtype=jnp.float32)
    p = JS.mamba_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    h0 = _state(2, cfg.ssm_d_inner, cfg.ssm_state_dim, 5)
    _, want = JS.mamba_mixer(p, x, cfg, h0=jnp.asarray(h0))
    dt, B_ssm, C_ssm, _, x_conv = JS._mamba_inputs(p, x, cfg)
    args = [torch.from_numpy(np.asarray(a)) for a in
            (dt, x_conv, B_ssm, C_ssm, p["A_log"])]
    _, h_last = ops.ssm_scan(*args, h0=torch.from_numpy(h0),
                             return_state=True)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want),
                               atol=SSM_TOL, rtol=SSM_TOL)


@pytest.mark.parametrize("S", [2, 37, 64])
def test_a_scan_splits_at_its_state(S):
    """A scan over S steps from h0 is two scans over its halves, the second
    from the first's h_last: y and h_last the same to the bit (the plain
    loop does the same operations in the same order)."""
    from test_torch_prefill_kernels import ssm_inputs, to_torch
    dt, x, Bc, Cc, A_log = to_torch(ssm_inputs(2, S, 24, 8, seed=S,
                                               a_log="per_channel"))
    h0 = torch.from_numpy(_state(2, 24, 8, S))
    y, h = ops.ssm_scan(dt, x, Bc, Cc, A_log, h0=h0, return_state=True)
    m = S // 2
    y1, h1 = ops.ssm_scan(dt[:, :m], x[:, :m], Bc[:, :m], Cc[:, :m], A_log,
                          h0=h0, return_state=True)
    y2, h2 = ops.ssm_scan(dt[:, m:], x[:, m:], Bc[:, m:], Cc[:, m:], A_log,
                          h0=h1, return_state=True)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


@pytest.mark.parametrize("h0,match", [
    (torch.zeros(2, 16, 8), "h0 must be"),
    (torch.zeros(1, 16, 4), "h0 must be"),
    (torch.zeros(1, 15, 8), "h0 must be"),
    (torch.zeros(1, 16, 8, dtype=torch.int32), "float"),
])
def test_h0_checks(h0, match):
    """h0 must be (B, di, N) and float, through the entry point and both
    versions alike; the kernel's version refuses CPU tensors first."""
    from test_torch_prefill_kernels import ssm_inputs, to_torch
    args = to_torch(ssm_inputs(1, 8, 16, 8, seed=1))
    for fn in (ops.ssm_scan, ss.ssm_scan_plain):
        with pytest.raises(ValueError, match=match):
            fn(*args, h0=h0)
    with pytest.raises(ValueError, match=match):
        ss.ssm_scan_cuda(*args, h0=h0)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan_cuda(*args, h0=torch.zeros(1, 16, 8), return_state=True)


def test_reference_state_is_differentiable():
    """Under autograd the plain loop carries gradients to h0 and A_log
    (the kernel has no backward; the Mamba mixer's train path takes it)."""
    from test_torch_prefill_kernels import ssm_inputs, to_torch
    dt, x, Bc, Cc, A_log = to_torch(ssm_inputs(1, 6, 8, 4, seed=7))
    h0 = torch.from_numpy(_state(1, 8, 4, 8)).requires_grad_(True)
    A_log.requires_grad_(True)
    y, h = ref.ssm_scan_reference(dt, x, Bc, Cc, A_log, h0=h0,
                                  return_state=True)
    g0, ga = torch.autograd.grad(y.sum() + h.sum(), (h0, A_log))
    assert g0.shape == h0.shape and ga.shape == A_log.shape
    assert bool(g0.abs().sum() > 0) and bool(ga.abs().sum() > 0)


# (B, S, di, N): the tests' shapes, S not a multiple of the kernel's 16
# steps a tile, channels not a multiple of a block, and jamba's Mamba width
SSM_STATE_CARD = [(1, 64, 128, 16), (2, 100, 70, 4), (3, 17, 44, 2),
                  (2, 33, 130, 32), (1, 4096, 16384, 16), (1, 4093, 16384, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N", SSM_STATE_CARD)
def test_ssm_kernel_state_vs_plain_on_card(B, S, di, N):
    """The kernel from a random h0 at every L it takes: y and h_last
    against the plain version within 1e-4, one launch a call; then a split
    at S // 2, the second half from the first's h_last."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_prefill_kernels import ssm_inputs, to_torch
    dt, x, Bc, Cc, A_log = (t.cuda() for t in to_torch(
        ssm_inputs(B, S, di, N, seed=11, a_log="per_channel")))
    h0 = torch.from_numpy(_state(B, di, N, 12)).cuda()
    want_y, want_h = ss.ssm_scan_plain(dt, x, Bc, Cc, A_log, h0=h0,
                                       return_state=True)
    for lanes in (L for L in ss.LANES if L <= N):
        before = ss.launches
        y, h = ss.ssm_scan_cuda(dt, x, Bc, Cc, A_log, h0=h0,
                                return_state=True, lanes=lanes)
        torch.cuda.synchronize()
        assert ss.launches == before + 1
        for got, want in ((y, want_y), (h, want_h)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       atol=SSM_TOL, rtol=SSM_TOL)
    m = S // 2
    y1, h1 = ops.ssm_scan(dt[:, :m], x[:, :m], Bc[:, :m], Cc[:, :m], A_log,
                          h0=h0, return_state=True)
    y2, h2 = ops.ssm_scan(dt[:, m:], x[:, m:], Bc[:, m:], Cc[:, m:], A_log,
                          h0=h1, return_state=True)
    torch.cuda.synchronize()
    for got, want in ((torch.cat([y1, y2], dim=1), want_y), (h2, want_h)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=SSM_TOL, rtol=SSM_TOL)
