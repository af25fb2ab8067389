"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48 blocks, d_model=2048, 4 heads (mLSTM head dim 1024), one sLSTM per 8
blocks (the paper's 7:1 ratio), vocab=50304, d_ff=0 (projections live
inside the blocks; sLSTM blocks carry a PF-4/3 gated FFN).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=8, ssm_conv=4, ssm_chunk=256,
)

TINY = CONFIG.replace(num_layers=6, d_model=64, num_heads=4, num_kv_heads=4,
                      vocab_size=512, slstm_every=3, ssm_chunk=8)
