"""h2o-danube-1.8b [dense]: 24L d2560 32H(kv8) ff6912 v32000, llama+mistral mix,
sliding-window attention (4096).  [arXiv:2401.16818; hf]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000, pattern=(("attn", "dense"),),
    window=4096, rope_theta=10000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=16, vocab_pad_multiple=16, ssm_chunk=8,
)
