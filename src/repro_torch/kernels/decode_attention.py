"""Decode attention: one query token per sequence against a KV cache.

Port of the Pallas TPU kernel `repro/kernels/decode_attention.py`.  The
CUDA kernel (`csrc/decode_attention.cu`, whose note gives its bound and
design) is flash-decoding: K/V tiles stream into shared memory through a
three-stage cp.async ring, the KV axis is cut into `num_splits` splits, each
split reduces to a partial (max, sum, acc) per query head, and a second
kernel merges the partials.  `split_plan` sizes the split from the card's SM
count and the kernel's occupancy so that the grid is at most one wave; when
it gives one split, the first kernel writes the output and the merge is not
launched.  `softcap` caps the scores as `repro`'s model attention does
(cap*tanh(s/cap)); `repro`'s Pallas kernel has no cap.
With `return_lse` the call also returns each (sequence, query head)'s
log-sum-exp of its scores, (B, H) fp32: the merged softmax's max and sum,
which a decode over a cache split across devices needs to merge the
devices' outputs (`kernels.ops`); the output is then fp32 whatever q's
type, not yet rounded, so that such a merge rounds once.
`decode_attention_plain` is the same function in plain PyTorch
(`ref.decode_attention_reference` behind the kernel's checks); it serves CPU
tensors and the tests, and is what the kernel is held against on the card.

`launches` counts the kernel's launches (one per call of
`decode_attention_cuda`, however many CUDA launches the call makes), so a
run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import check_softcap, decode_attention_reference

MAX_GROUP = 8       # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256
MIN_SPLIT_ROWS = 128    # cache rows a split must have on average

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_occupancy: dict[tuple, tuple[int, int, int]] = {}


def split_plan(B: int, Hk: int, Skv: int, tile_rows: int, sms: int,
               blocks_per_sm: int) -> tuple[int, int]:
    """(num_splits, split_len) for a cache of capacity Skv: the most splits
    that keep the B*Hk*num_splits blocks within one wave of `sms` SMs with
    `blocks_per_sm` resident each, but no more than one per MIN_SPLIT_ROWS
    rows of the cache (so a short cache takes one split); split_len is a
    multiple of `tile_rows`, and the splits cover [0, Skv)."""
    if min(B, Hk, Skv, tile_rows, sms, blocks_per_sm) < 1:
        raise ValueError("split_plan needs positive sizes")
    per_pair = (sms * blocks_per_sm) // (B * Hk)
    ns = max(1, min(per_pair, _cdiv(Skv, MIN_SPLIT_ROWS)))
    split_len = _cdiv(_cdiv(Skv, ns), tile_rows) * tile_rows
    return _cdiv(Skv, split_len), split_len


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_shapes(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, d), got {tuple(q.shape)}")
    B, _, H, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != d:
        raise ValueError(f"caches must be (B, Skv, Hk, d) matching q: "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    Hk = k_cache.shape[2]
    if H % Hk or H // Hk > MAX_GROUP:
        raise ValueError(f"H={H} must be a multiple of Hk={Hk}, "
                         f"at most {MAX_GROUP} times it")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 8, <= {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes must all be fp32 or bf16: "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def kv_lengths(kv_len, B: int, Skv: int, device: torch.device) -> torch.Tensor:
    """kv_len (int, or a (B,) / scalar tensor) as int32 (B,) on `device`.
    Values that live on the host are checked to lie in [1, Skv]; a tensor
    already on the card is not (that would wait for the card), and the
    kernel clamps it into that range."""
    if isinstance(kv_len, torch.Tensor) and kv_len.device == device \
            and kv_len.dtype == torch.int32 and kv_len.shape == (B,) \
            and kv_len.is_contiguous():
        return kv_len                   # as the model passes it to each layer
    lens = torch.as_tensor(kv_len)
    if lens.device.type == "cpu":
        if lens.numel() and not bool(((lens >= 1) & (lens <= Skv)).all()):
            raise ValueError(f"kv_len must lie in [1, {Skv}]: {lens.tolist()}")
    lens = lens.to(device=device, dtype=torch.int32).reshape(-1)
    if lens.numel() not in (1, B):
        raise ValueError(f"kv_len must be a scalar or ({B},), got {lens.numel()}")
    return lens.expand(B).contiguous()


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len,
                           softcap: float | None = None,
                           return_lse: bool = False):
    """The kernel's function in plain PyTorch: the same checks, then
    `ref.decode_attention_reference` (one softmax over the whole cache);
    (out fp32, lse (B, H) fp32) with return_lse."""
    check_shapes(q, k_cache, v_cache)
    check_softcap(softcap)
    lens = kv_lengths(kv_len, q.shape[0], k_cache.shape[1], q.device)
    return decode_attention_reference(q, k_cache, v_cache, lens, softcap,
                                      return_lse=return_lse)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len,
                          softcap: float | None = None,
                          return_lse: bool = False):
    """Launch the CUDA kernel.  q: (B,1,H,d); caches (B,Skv,Hk,d), read in
    place through their strides (unit stride on d); kv_len int or (B,);
    softcap None or a positive cap.  Returns (B,1,H,d) in q's type; with
    return_lse, (out (B,1,H,d) fp32, lse (B,H) fp32).  Raises on anything
    the kernel does not take, or if the launch fails."""
    global launches
    check_shapes(q, k_cache, v_cache)
    cap = check_softcap(softcap)
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError("decode_attention_cuda needs all tensors on one "
                         "CUDA device")
    B, _, H, d = q.shape
    Skv, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    item = q.element_size()
    for t in (k_cache, v_cache):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(t.stride(i) * item % 16 for i in range(3)):
            raise ValueError("caches need unit stride on d and 16-byte "
                             f"aligned rows; strides {t.stride()}")
    q = q.contiguous()
    lens = kv_lengths(kv_len, B, Skv, dev)
    lib = _library()
    ns, split_len = split_plan(B, Hk, Skv, *_card_plan(lib, dev, q.dtype, H,
                                                       Hk, d))
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else None)
    lse = (torch.empty((B, H), device=dev, dtype=torch.float32)
           if return_lse else None)
    parts = [None] * 3          # each split's (max, sum, acc), for the merge
    if ns > 1:
        m = torch.empty(B * Hk * ns * G, device=dev, dtype=torch.float32)
        parts = [m, torch.empty_like(m),
                 torch.empty(m.numel() * d, device=dev, dtype=torch.float32)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_decode_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *(None if t is None else t.data_ptr() for t in parts), B, H, Hk,
            d, Skv, split_len, ns, *k_cache.stride()[:3],
            *v_cache.stride()[:3], cap, stream)
    if err:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return (out, lse) if return_lse else out


def tile_rows(dev: torch.device, dtype: torch.dtype, H: int, Hk: int,
              d: int) -> int:
    """Cache rows of one K/V tile of the kernel that takes this dtype, G
    and d on `dev`: the unit its splits are cut in."""
    return _card_plan(_library(), dev, dtype, H, Hk, d)[0]


def _card_plan(lib: ctypes.CDLL, dev: torch.device, dtype: torch.dtype,
               H: int, Hk: int, d: int) -> tuple[int, int, int]:
    """(tile rows, SM count, resident blocks an SM) of the kernel that
    takes this dtype, G and d on `dev`, asked of the CUDA runtime once."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, dtype, H // Hk, d)
    plan = _occupancy.get(key)
    if plan is None:
        sms, blocks, rows = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            err = lib.repro_decode_occupancy(
                _DTYPE_CODE[dtype], H, Hk, d, ctypes.byref(sms),
                ctypes.byref(blocks), ctypes.byref(rows))
        if err or blocks.value < 1:
            raise RuntimeError(
                "decode_attention occupancy query failed: "
                + lib.repro_cuda_error_string(err).decode())
        plan = _occupancy[key] = (rows.value, sms.value, blocks.value)
    return plan


def _library() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I] + [P] * 9 + [I] * 7 + [L] * 6 + [ctypes.c_float, P]
        fn.restype = I
        occ = lib.repro_decode_occupancy
        occ.argtypes = [I] * 4 + [ctypes.POINTER(I)] * 3
        occ.restype = I
        lib.repro_cuda_error_string.argtypes = [I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib
