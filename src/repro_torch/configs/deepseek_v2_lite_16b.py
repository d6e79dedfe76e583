"""deepseek-v2-lite-16b [moe]: 27L d2048 16H MLA(kv_lora=512, rope_dim=64,
head_dim=128) expert_ff=1408 v102400, 64 routed experts top-6 + 2 shared.
[arXiv:2405.04434; hf]

Deviations, `repro`'s: the public V2-Lite has 64 routed experts + 2 shared,
top-6 (160 routed belongs to the full V2), and this config has 64.  The
public V2-Lite uses a dense FFN on layer 0; here all 27 layers are MoE, as
in `repro`, whose layer stack scans uniformly."""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, pattern=(("attn", "moe"),),
    attn_kind="mla", kv_lora_rank=512, rope_head_dim=64,
    num_experts=64, top_k=6, num_shared_experts=2, moe_d_ff=1408,
    rope_theta=10000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    kv_lora_rank=32, rope_head_dim=8, d_ff=64, moe_d_ff=64, num_experts=8,
    top_k=2, num_shared_experts=1, vocab_size=256, vocab_pad_multiple=16,
    ssm_chunk=8,
)
