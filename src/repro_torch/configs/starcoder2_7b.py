"""starcoder2-7b: dense 36H/4kv, LayerNorm, GELU MLP, 4k sliding window.
[arXiv:2402.19173]"""
from repro_torch.models.common import ModelConfig

ARCH = "starcoder2-7b"

CONFIG = ModelConfig(
    name=ARCH, family="dense", n_layers=32, d_model=4608, n_heads=36,
    n_kv=4, d_head=128, d_ff=18432, vocab=49152, act="gelu", norm="layer",
    window=4096, rope_theta=1e5, tie_embeddings=True, norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=512, act="gelu",
    norm="layer", window=16, tie_embeddings=True, norm_eps=1e-5,
)
