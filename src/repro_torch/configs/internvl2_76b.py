"""internvl2-76b [vlm]: InternViT frontend (stub) + InternLM2-style backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]. The vision frontend is a stub, as in the
reference: the caller supplies precomputed patch embeddings (B, 256,
d_model), which are linearly projected and prepended.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    frontend="vision_stub", num_frontend_tokens=256,
    rope_theta=500000.0, fsdp=True,
)

# reduced same-family config for the CPU smoke test
TINY = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=512,
                      num_frontend_tokens=8, fsdp=False)
