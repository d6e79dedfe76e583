"""h2o-danube-3-4b [dense]: 24L d3840 32H(kv8) ff10240 v32000, llama+mistral
mix, sliding-window attention.  [arXiv:2401.16818; unverified]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, pattern=(("attn", "dense"),),
    window=4096, rope_theta=10000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=16, vocab_pad_multiple=16, ssm_chunk=8,
)
