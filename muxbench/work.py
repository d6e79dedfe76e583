"""Operation and byte counts from a configuration's shapes, and the peaks
of one NVIDIA H100 SXM they are held against.

Model FLOPs count every multiply-add of the model's matrix products as
two operations: the projections, the attention's scores and weighted sum
over the keys each query sees, the dense FFN, and the output head over
the vocabulary.  Norms, rotary
angles, softmax and the loss are left out.  A train step is the forward
and a backward of twice its products; recomputation is not counted.
`bound` is a copy of `chip_smoke.bound`: the least time for some work is
its bytes over the memory rate or its operations over their peak rate,
whichever is larger.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def token_matmul_flops(m: dict) -> float:
    """Projection FLOPs of one token through the model: every layer's
    attention projections and FFN, and the output head."""
    d, H, Hk, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = d * dh * (H + 2 * Hk) + H * dh * d
    ffn = 3 * d * m["d_ff"]
    return 2.0 * (m["num_layers"] * (attn + ffn) + d * m["vocab_size"])


def visible_keys(pos: int, m: dict) -> int:
    """Keys the query at position `pos` sees (causal, within the window)."""
    w = m.get("window")
    return pos + 1 if w is None else min(pos + 1, w)


def attention_flops(keys: int, m: dict) -> float:
    """Score and weighted-sum FLOPs of one query over `keys` keys, every
    layer."""
    return 4.0 * m["num_layers"] * m["num_heads"] * m["head_dim"] * keys


def decode_step_flops(m: dict, batch: int, pos: int) -> float:
    """One decode step of `batch` sequences, each at position `pos`."""
    return batch * (token_matmul_flops(m)
                    + attention_flops(visible_keys(pos, m), m))


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Forward and backward of `batch` sequences of `seq` tokens."""
    keys = sum(visible_keys(p, m) for p in range(seq))
    fwd = batch * (seq * token_matmul_flops(m) + attention_flops(keys, m))
    return 3.0 * fwd


def decode_attention_bytes(m: dict, batch: int, kv_len: int,
                           dtype: str = "bfloat16") -> float:
    """Bytes one decode-attention call must move: each sequence's kv_len
    key and value rows read once, the queries read and the output
    written."""
    it = ITEM[dtype]
    H, Hk, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return float(batch * (2 * kv_len * Hk * dh + 2 * H * dh) * it)


def decode_attention_flops(m: dict, batch: int, kv_len: int) -> float:
    """Operations of one decode-attention call (one layer)."""
    return 4.0 * batch * m["num_heads"] * m["head_dim"] * kv_len


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least ms for the work, what sets it): bytes over the memory rate,
    or the slowest of the operation counts over their peak rates."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = max(n / rate for n, rate in ops.values())
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
