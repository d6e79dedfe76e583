"""granite-moe-1b-a400m [moe]: 24L d1024 16H(kv8) expert_ff=512 v49155
(padded 49408), 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, pattern=(("attn", "moe"),),
    num_experts=32, top_k=8, num_shared_experts=0, moe_d_ff=512,
    rope_theta=10000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, moe_d_ff=64, num_experts=8, top_k=2, vocab_size=250,
    vocab_pad_multiple=16, ssm_chunk=8,
)
