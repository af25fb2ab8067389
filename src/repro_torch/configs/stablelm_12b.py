"""stablelm-12b [dense]: GQA [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    rope_theta=10000.0,
)

TINY = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=512)
