"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=151936. On a
model axis of M shards the experts are padded up to a multiple of M
(``models/moe.padded_experts``): 60 on one card. Shared-expert width =
4 * 1408 = 5632.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=151936, head_dim=128,
    moe_num_experts=60, moe_top_k=4, moe_num_shared=4, moe_d_ff=1408,
    rope_theta=1000000.0,
)

TINY = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      head_dim=16, vocab_size=512, moe_num_experts=8,
                      moe_top_k=2, moe_num_shared=1, moe_d_ff=96)
