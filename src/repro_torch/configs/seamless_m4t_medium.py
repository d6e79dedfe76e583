"""seamless-m4t-medium [audio]: enc-dec, 12L(+12L enc) d1024 16H(kv16) ff4096
v256206 (padded 256256), ReLU.  The audio frontend is a STUB: the caller
provides precomputed frame embeddings, `batch["src_embeds"]`.
[arXiv:2308.11596; hf]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206, pattern=(("attn_cross", "dense"),),
    enc_layers=12, frontend="audio", rope_theta=10000.0, ffn_act="relu",
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, enc_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, vocab_pad_multiple=16, ssm_chunk=8,
)
