"""paligemma-3b: SigLIP frontend STUB (precomputed patch embeddings) +
gemma-2b decoder, prefix-LM attention over the image tokens.
[arXiv:2407.07726]"""
from repro_torch.models.common import ModelConfig

ARCH = "paligemma-3b"

CONFIG = ModelConfig(
    name=ARCH, family="vlm", n_layers=18, d_model=2048, n_heads=8,
    n_kv=1, d_head=256, d_ff=16384, vocab=257216, act="geglu",
    tie_embeddings=True, scale_embed=True, n_frontend_tokens=256,
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv=1, d_head=16, d_ff=128, vocab=512, act="geglu",
    tie_embeddings=True, scale_embed=True, n_frontend_tokens=8,
)
