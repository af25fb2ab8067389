"""whisper-base [audio]: encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

6-layer encoder + 6-layer decoder, d_model=512, 8 heads (kv=8) of 64,
d_ff=2048, vocab=51865. The conv1d frontend is a stub, as the reference's:
the encoder takes precomputed frame embeddings (B, S, 512).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    tie_embeddings=True, frontend="audio_stub",
)

TINY = CONFIG.replace(num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512)
