"""minicpm3-4b [dense]: MLA (multi-head latent attention)
[hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448; MLA dims from the HF
config: q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
qk_rope_head_dim=32, v_head_dim=64. The KV cache stores latents (256+32
per token). ``mla_seq_shard`` (the reference's sequence-sharded latent
cache for long-context decode) is off, as in the reference's config; the
port runs on one card and ignores the flag.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attn_kind="mla", mla_q_lora=768, mla_kv_lora=256,
    mla_rope_dim=32, mla_nope_dim=64, mla_v_dim=64,
    rope_theta=10000.0,
)

TINY = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=128, vocab_size=512, mla_q_lora=32, mla_kv_lora=16,
                      mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16)
