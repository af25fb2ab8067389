"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

38 mamba2 layers (d_model=2048, expand=2 -> d_inner=4096, ssm_state=64,
64 value heads of dim 64), shared GQA(32H, kv=32)+MLP(8192) block invoked
every 6 layers.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    attn_every=6, rope_theta=10000.0,
)

TINY = CONFIG.replace(num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=512, ssm_state=16,
                      attn_every=3, ssm_chunk=8)
