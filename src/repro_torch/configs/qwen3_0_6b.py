"""qwen3-0.6b: dense 28L d1024, qk-norm, GQA kv=8, tied embeddings.
[hf:Qwen/Qwen3-0.6B]"""
from repro_torch.models.common import ModelConfig

ARCH = "qwen3-0.6b"

CONFIG = ModelConfig(
    name=ARCH, family="dense", n_layers=28, d_model=1024, n_heads=16,
    n_kv=8, d_head=128, d_ff=3072, vocab=151936, act="swiglu",
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=512, act="swiglu",
    qk_norm=True, tie_embeddings=True,
)
