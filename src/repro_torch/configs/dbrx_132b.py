"""dbrx-132b [moe]: 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752 vocab=100352.
``fsdp`` is kept as the reference sets it; the port computes on one card,
and only the dry run's specs read it (``models/common.ShardingRules``).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=0, vocab_size=100352, head_dim=128,
    moe_num_experts=16, moe_top_k=4, moe_num_shared=0, moe_d_ff=10752,
    rope_theta=500000.0, fsdp=True,
)

TINY = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, vocab_size=512, moe_num_experts=4,
                      moe_top_k=2, moe_d_ff=96, fsdp=False)
