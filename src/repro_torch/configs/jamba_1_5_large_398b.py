"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H(kv8) ff24576 v65536, MoE 16e
top-2, Mamba+attention 1:7 interleave.  [arXiv:2403.19887; hf]

Structure: 9 super-blocks of 8 layers — attention at in-block index 4, MoE on
odd in-block indices (period 2), Mamba elsewhere; d_inner=2*d_model,
d_state=16, conv=4, dt_rank=d_model/16=512.  Copied from `repro`'s config as
data."""
import dataclasses

from repro_torch.models.model import ModelConfig

_PATTERN = (
    ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
)

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536, pattern=_PATTERN,
    num_experts=16, top_k=2, num_shared_experts=0, moe_d_ff=24576,
    ssm_d_inner=16384, ssm_state_dim=16, ssm_conv_dim=4, ssm_dt_rank=512,
    ssm_chunk=256, rope_theta=10000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, num_experts=4, top_k=2, ssm_d_inner=128,
    ssm_dt_rank=8, ssm_chunk=8, vocab_size=256, vocab_pad_multiple=16,
)
