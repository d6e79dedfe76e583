"""Public entry points for the port's kernels, dispatched by tensor device.

A CUDA tensor always goes to the hand-written kernel (which raises if it
cannot build or launch); a CPU tensor goes to the kernel's plain PyTorch
version; any other device raises.  `repro.kernels.ops` switched the Pallas
kernels to interpret mode off the TPU instead; the port has no such switch.

Each kernel is a `torch.library.custom_op` (`repro_torch::...`) with:
  * its implementation: the kernel on CUDA, the plain version on the CPU;
  * a fake implementation (`register_fake`) that gives the output shapes
    and types, so that fake and meta tensors trace the card's route (the
    dry-run);
  * a FLOP formula (`register_flop_formula`) that counts what the kernel
    computes, stated at each formula: the query-key pairs it visits, where
    `repro`'s dry-run counted its dense jnp attention over every pair
    (ROADMAP.md F14).
A DTensor argument takes the kernel's sharding rule (`_local_heads`,
`_sharded_decode`): each rank runs the kernel on its own shard (batch over
the data axes, heads or Mamba channels over `model`), and a decode over a
cache split along its sequence merges the ranks' partial softmaxes.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.obs.spans import span

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import ssm_scan as _ssm


def _route(t: torch.Tensor, name: str, cuda, plain):
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no {name} for device {t.device}")


def _check_device(t: torch.Tensor, name: str) -> None:
    """Raise for a device with no route; the meta device (shapes only)
    takes the fake implementation."""
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no {name} for device {t.device}")


# ------------------------------------------------------------ custom ops

@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_op(q: Tensor, k_cache: Tensor, v_cache: Tensor, kv_len: Tensor,
               softcap: float | None, return_lse: bool
               ) -> tuple[Tensor, Tensor]:
    fn = _route(q, "decode_attention", _decode.decode_attention_cuda,
                _decode.decode_attention_plain)
    res = fn(q, k_cache, v_cache, kv_len, softcap, return_lse=True) \
        if return_lse else (fn(q, k_cache, v_cache, kv_len, softcap),
                            q.new_empty((0,), dtype=torch.float32))
    return res


@_decode_op.register_fake
def _(q, k_cache, v_cache, kv_len, softcap, return_lse):
    _decode.check_shapes(q, k_cache, v_cache)
    B, _, H, _ = q.shape
    return (torch.empty_like(q, dtype=torch.float32 if return_lse else None),
            q.new_empty((B, H) if return_lse else (0,), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              window: int | None, softcap: float | None) -> Tensor:
    fn = _route(q, "flash_attention", _flash.flash_attention_cuda,
                _flash.flash_attention_plain)
    return fn(q, k, v, causal=causal, window=window, softcap=softcap)


@_flash_op.register_fake
def _(q, k, v, causal, window, softcap):
    _flash.check_args(q, k, v, window)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_op(dt: Tensor, x: Tensor, B_ssm: Tensor, C_ssm: Tensor,
            A_log: Tensor, h0: Tensor | None, return_state: bool
            ) -> tuple[Tensor, Tensor]:
    fn = _route(x, "ssm_scan", _ssm.ssm_scan_cuda, _ssm.ssm_scan_plain)
    if return_state:
        return fn(dt, x, B_ssm, C_ssm, A_log, h0=h0, return_state=True)
    return (fn(dt, x, B_ssm, C_ssm, A_log, h0=h0),
            x.new_empty((0,), dtype=torch.float32))


@_ssm_op.register_fake
def _(dt, x, B_ssm, C_ssm, A_log, h0, return_state):
    _ssm.check_args(dt, x, B_ssm, C_ssm, A_log, h0)
    Bsz, S, di = x.shape
    N = B_ssm.shape[2]
    return (x.new_empty((Bsz, S, di), dtype=torch.float32),
            x.new_empty((Bsz, di, N) if return_state else (0,),
                        dtype=torch.float32))


# ------------------------------------------------------------ FLOP formulas

@register_flop_formula(torch.ops.repro_torch.decode_attention, get_raw=True)
def _decode_flops(q, k_cache, v_cache, kv_len, softcap, return_lse, *,
                  out=None, **kw) -> int:
    """2 flops a multiply-add of q.k and of p.v over the rows each sequence
    reads: 4 * H * d * sum(kv_len).  Lengths that cannot be read (meta or
    fake tensors) count every cache row passed, which is what the model
    passes (its caches cut to the longest live row)."""
    B, _, H, d = q.shape
    rows = B * k_cache.shape[1]
    if kv_len.device.type in ("cpu", "cuda") and not _is_fake(kv_len):
        rows = int(kv_len.clamp(1, k_cache.shape[1]).sum())
    return 4 * H * d * rows


def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """Query-key pairs the flash kernel visits for one head: query row i
    (position i) sees keys j <= i when causal and j > i - window."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i, max=Skv - 1) if causal else torch.full_like(i, Skv - 1)
    lo = (torch.clamp(i - window + 1, min=0) if window is not None
          else torch.zeros_like(i))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _flash_flops(q, k, v, causal, window, softcap, *, out=None,
                 **kw) -> int:
    """4 * B * H * d * visible_pairs: the pairs the causal and window masks
    leave (`repro` counted its dense attention's Sq * Skv)."""
    B, Sq, H, d = q.shape
    return 4 * B * H * d * visible_pairs(Sq, k.shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.ssm_scan, get_raw=True)
def _ssm_flops(dt, x, B_ssm, C_ssm, A_log, h0, return_state, *, out=None,
               **kw) -> int:
    """7 a step, channel and state: dt*A and its exp, the two products and
    the sum of the recurrence, the product and the sum of the readout."""
    Bsz, S, di = x.shape
    return 7 * Bsz * S * di * B_ssm.shape[2]


def _is_fake(t: Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


# ------------------------------------------------------------ entry points

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len,
                     softcap: float | None = None,
                     return_lse: bool = False):
    """q: (B,1,H,d); caches: (B,Skv,Hk,d); kv_len: valid entries (int or
    (B,), each >= 1); softcap: scores cap*tanh(s/cap), or None.  Returns
    (B,1,H,d) in q.dtype; with return_lse, (out (B,1,H,d) fp32, not yet
    rounded to q's type, lse (B,H) fp32), the log-sum-exp of each row's
    scores: what a merge over a cache split across devices needs to round
    once.  The kernel's call is the span `decode.attention` (over
    DTensors, each rank's call on its own rows)."""
    if _is_dtensor(q, k_cache):
        return _sharded_decode(q, k_cache, v_cache, kv_len, softcap,
                               return_lse)
    with span("decode.attention"):
        _check_device(q, "decode_attention")
        lens = _decode.kv_lengths(kv_len, q.shape[0], k_cache.shape[1],
                                  q.device)
        out, lse = torch.ops.repro_torch.decode_attention(
            q, k_cache, v_cache, lens, softcap, return_lse)
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q: (B,Sq,H,d); k, v: (B,Skv,Hk,d), H a multiple of Hk; causal and/or
    sliding-window (keys in (i - window, i] for query row i); softcap:
    scores cap*tanh(s/cap), or None.  Returns (B,Sq,H,d) in q.dtype."""
    if _is_dtensor(q, k):
        return _local_heads(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal,
                                               window=window,
                                               softcap=softcap), q, k, v)
    _check_device(q, "flash_attention")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                 softcap)


def ssm_scan(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
             C_ssm: torch.Tensor, A_log: torch.Tensor,
             h0: torch.Tensor | None = None, return_state: bool = False):
    """dt, x: (B,S,di); B_ssm, C_ssm: (B,S,N); A_log: (di,N); h0: (B,di,N)
    initial state (zero if None).  Returns fp32 y (B,S,di), without the D*x
    skip, or (y, h_last (B,di,N) fp32) with return_state."""
    if _is_dtensor(x):
        return _sharded_scan(dt, x, B_ssm, C_ssm, A_log, h0, return_state)
    _check_device(x, "ssm_scan")
    y, h_last = torch.ops.repro_torch.ssm_scan(dt, x, B_ssm, C_ssm, A_log,
                                               h0, return_state)
    return (y, h_last) if return_state else y


# ------------------------------------------------------------ sharding rules
# (DTensor helpers from `sharding.context`, imported where used: this
# module is imported by the model code before any mesh exists)

def _is_dtensor(*ts) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def _kv_heads_of(mesh, H: int, Hk: int, q_spec, kv_spec):
    """(first, count) of the KV heads this rank's query heads read, when q's
    heads are split over `model` and the KV heads are not (they do not
    divide it); None when both or neither are split.  `repro` replicated k
    and v and split the repeated heads; here each rank passes the kernel
    only its own query heads' KV heads, and no rank gathers another's."""
    if q_spec[2] is None or kv_spec[2] is not None:
        return None
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    Hl, G = H // tp, H // Hk
    h0 = mesh.get_local_rank("model") * Hl
    first, last = h0 // G, (h0 + Hl - 1) // G
    count = last - first + 1
    if Hl % count or (Hl // count != G and count != 1):
        raise NotImplementedError(
            f"{Hl} query heads a rank over {Hk} KV heads of {G} each do not "
            "map to whole KV heads")
    return first, count


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient leaves contiguous: the attention's einsum
    gradients come back transposed, and DTensor reshapes a shard's
    gradient with `view`."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_heads(fn, q, k, v):
    """Run fn(q, k, v) (attention over (B, S, heads, d)) on each rank's
    shard: batch over the data axes, query heads over `model` (the layout
    of `repro`'s constrain(q, "dp", None, "tp", None)), KV heads over
    `model` where they divide it.  Returns a DTensor in q's layout."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.context import from_shard, resolve, to_layout
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q_spec = resolve(mesh, ("dp", None, "tp", None), q.shape)
    kv_spec = resolve(mesh, ("dp", None, "tp", None), k.shape)
    kv_spec = (q_spec[0],) + kv_spec[1:]
    q, k, v = (to_layout(q, mesh, q_spec), to_layout(k, mesh, kv_spec),
               to_layout(v, mesh, kv_spec))
    sel = _kv_heads_of(mesh, q.shape[2], k.shape[2], q_spec, kv_spec)
    # under autograd, a rank's gradient of KV heads it selected from a
    # replicated k or v is its part of their gradient: a partial sum
    kv_grad = None
    if sel is not None:
        from torch.distributed.tensor import Partial
        kv_grad = [Partial() if n == "model" else p
                   for n, p in zip(mesh.mesh_dim_names, k.placements)]
    ql = _ContiguousGrad.apply(q.to_local())
    kl, vl = (_ContiguousGrad.apply(t.to_local(grad_placements=kv_grad))
              for t in (k, v))
    if sel is not None:
        kl, vl = (t[:, :, sel[0]:sel[0] + sel[1]] for t in (kl, vl))
    out = fn(ql, kl, vl)
    return from_shard(out, mesh, q.placements,
                       tuple(q.shape[:3]) + tuple(out.shape[3:]))


def _sharded_decode(q, k_cache, v_cache, kv_len, softcap, return_lse):
    """decode_attention over DTensors.  The cache keeps its own layout
    (`sharding.rules.cache_sharding`): batch over the data axes or, where
    the batch does not divide them, the sequence; KV heads over `model` or,
    where they do not divide it, the sequence.  The query takes the
    cache's batch layout and its heads over `model` when the cache's are.

    Over a cache split along its sequence each rank runs the kernel on its
    own rows with return_lse (a rank whose rows are all past kv_len takes
    lse = -inf) and the ranks merge: the max of the lse over those axes,
    then the sums of exp(lse - max) * out and of exp(lse - max), the
    all-reduces GSPMD lowers `repro`'s constrain(scores, "dp", "tp", None,
    None) to.  The ranks' outputs come in fp32 and the merged one is
    rounded to q's type once, as `repro`'s fp32 partial sums are, and as
    the kernel's own split merges them on one device.  The query is
    replicated over those axes: one token a row.  With return_lse the
    output is fp32, as from the one-device op."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard
    from repro_torch.sharding.context import (axis_index, from_shard,
                                              resolve, to_layout)
    from repro_torch.sharding.rules import spec_of
    mesh = k_cache.device_mesh
    kv_spec = spec_of(k_cache)
    seq = kv_spec[1]
    seq_axes = () if seq is None else ((seq,) if isinstance(seq, str)
                                       else seq)
    q_heads = resolve(mesh, ("dp", None, "tp", None), q.shape)[2]
    if kv_spec[2] is not None or "model" in seq_axes:
        q_heads = kv_spec[2]
    q_spec = (kv_spec[0], None, q_heads, None)
    q = to_layout(q, mesh, q_spec)
    v_cache = to_layout(v_cache, mesh, kv_spec)
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    sel = _kv_heads_of(mesh, q.shape[2], k_cache.shape[2], q_spec, kv_spec)
    if sel is not None:
        kl, vl = (t[:, :, sel[0]:sel[0] + sel[1]] for t in (kl, vl))
    Bl, Sl = ql.shape[0], kl.shape[1]
    lens = _decode.kv_lengths(kv_len, q.shape[0], k_cache.shape[1],
                              ql.device)
    if kv_spec[0] is not None:
        bi = axis_index(mesh, kv_spec[0])
        lens = lens[bi * Bl:(bi + 1) * Bl]
    if not seq_axes:
        res = decode_attention(ql, kl, vl, lens, softcap, return_lse)
        out, lse = res if return_lse else (res, None)
    else:
        local = torch.clamp(lens - axis_index(mesh, seq_axes) * Sl, 0, Sl)
        o, lse = decode_attention(ql, kl, vl, torch.clamp(local, min=1),
                                  softcap, True)
        lse = torch.where(local[:, None] > 0, lse, -math.inf)
        m = lse
        for a in seq_axes:
            m = funcol.all_reduce(m, "max", mesh.get_group(a))
        m = torch.where(torch.isfinite(m), m, 0.0)
        w = torch.exp(lse - m)                              # (Bl, Hl)
        num, den = o * w[:, None, :, None], w
        for a in seq_axes:
            num = funcol.all_reduce(num, "sum", mesh.get_group(a))
            den = funcol.all_reduce(den, "sum", mesh.get_group(a))
        out = num / den[:, None, :, None]
        if not return_lse:
            out = out.to(q.dtype)                   # the one rounding
        lse = m + torch.log(den)
    out = from_shard(out, mesh, q.placements, q.shape)
    if not return_lse:
        return out
    lse_pl = [Shard(1) if p == Shard(2) else p for p in q.placements]
    return out, from_shard(lse, mesh, lse_pl, (q.shape[0], q.shape[2]))


def ssm_scan_differentiable(dt, x, B_ssm, C_ssm, A_log, h0=None,
                            return_state: bool = False):
    """The scan's plain version (`ref.ssm_scan_reference`, a loop autograd
    differentiates), with the kernel's sharding rule over DTensors: the
    scan under autograd, where the kernel has no backward."""
    from repro_torch.kernels.ref import ssm_scan_reference
    if _is_dtensor(x):
        return _sharded_scan(dt, x, B_ssm, C_ssm, A_log, h0, return_state,
                             fn=ssm_scan_reference)
    return ssm_scan_reference(dt, x, B_ssm, C_ssm, A_log, h0, return_state)


def _sharded_scan(dt, x, B_ssm, C_ssm, A_log, h0, return_state, fn=None):
    """ssm_scan over DTensors: batch over the data axes, the channels di
    over `model`; B and C replicated over `model`, A_log over (model,
    None) and h0 (B, di, N) with its channels over `model`.  Each rank
    scans its own channels with `fn` (the kernel's entry point by
    default).  Under autograd a rank's gradient of a replicated input (B
    and C over `model`, A_log over the data axes that split the batch)
    covers its own part of the work: a partial sum."""
    from torch.distributed.tensor import Partial
    from repro_torch.sharding.context import from_shard, resolve, to_layout
    from repro_torch.sharding.rules import placements
    mesh = x.device_mesh
    xs = resolve(mesh, ("dp", None, "tp"), x.shape)
    bs = (xs[0], None, None)
    dt, x = to_layout(dt, mesh, xs), to_layout(x, mesh, xs)
    B_ssm, C_ssm = to_layout(B_ssm, mesh, bs), to_layout(C_ssm, mesh, bs)
    A_log = to_layout(A_log, mesh, (xs[2], None))

    def partial_over(spec, axes) -> list:
        pl = placements(mesh, spec)
        for a in axes:
            i = mesh.mesh_dim_names.index(a)
            if mesh.shape[i] > 1:
                pl[i] = Partial()
        return pl

    split = lambda e: () if e is None else ((e,) if isinstance(e, str)  # noqa
                                            else tuple(e))
    hs = (xs[0], xs[2], None)
    h0l = None if h0 is None else to_layout(h0, mesh, hs).to_local()
    args = (dt.to_local(), x.to_local(),
            B_ssm.to_local(grad_placements=partial_over(bs, split(xs[2]))),
            C_ssm.to_local(grad_placements=partial_over(bs, split(xs[2]))),
            A_log.to_local(grad_placements=partial_over(
                (xs[2], None), split(xs[0]))), h0l)
    res = (fn or ssm_scan)(*args, return_state=return_state)
    y, h_last = res if return_state else (res, None)
    y = from_shard(y, mesh, x.placements, x.shape)
    if not return_state:
        return y
    N = B_ssm.shape[2]
    return y, from_shard(h_last, mesh, placements(mesh, hs),
                          (x.shape[0], x.shape[2], N))
