"""mistral-nemo-12b [dense]: 40L d5120 32H(kv8) ff14336 v131072, 128k ctx,
head_dim=128.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, pattern=(("attn", "dense"),),
    rope_theta=1_000_000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, vocab_pad_multiple=16, ssm_chunk=8,
)
