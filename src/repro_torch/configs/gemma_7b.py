"""gemma-7b [dense]: 28L d3072 16H(kv16=MHA) ff24576 v256000, GeGLU,
head_dim=256.  [arXiv:2403.08295; hf]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, pattern=(("attn", "dense"),),
    rope_theta=10000.0, ffn_act="gelu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, vocab_pad_multiple=16, ssm_chunk=8,
)
