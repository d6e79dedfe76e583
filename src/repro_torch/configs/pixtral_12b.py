"""pixtral-12b [vlm]: pixtral-ViT frontend (STUB: the caller provides
precomputed patch embeddings, `batch["patch_embeds"]`) + mistral-nemo-12b
backbone: 40L d5120 32H(kv8) ff14336 v131072.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, pattern=(("attn", "dense"),),
    frontend="patch", num_patches=1024, rope_theta=1_000_000.0, ffn_act="silu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, num_patches=4, vocab_pad_multiple=16, ssm_chunk=8,
)
