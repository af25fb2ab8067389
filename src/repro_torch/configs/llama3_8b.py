"""llama3-8b [dense]: GQA + 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500000.0,
)

TINY = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=512)
