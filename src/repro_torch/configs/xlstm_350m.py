"""xlstm-350m [ssm]: 24 mLSTM blocks, d1024 4 heads, v50304, d_ff=0 (the
block's pf=2 up-projection is the FFN).  [arXiv:2405.04517; unverified]"""
import dataclasses

from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304, pattern=(("mlstm", "none"),),
    mlstm_proj_factor=2, ssm_conv_dim=4, ssm_chunk=256,
)

SMOKE = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, head_dim=16, vocab_size=256,
    vocab_pad_multiple=16, ssm_chunk=8,
)
