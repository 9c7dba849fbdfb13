"""glm4-9b: dense 40L, GQA kv=2, partial RoPE (half dims). [hf:THUDM/glm-4-9b]"""
from repro_torch.models.common import ModelConfig

ARCH = "glm4-9b"

CONFIG = ModelConfig(
    name=ARCH, family="dense", n_layers=40, d_model=4096, n_heads=32,
    n_kv=2, d_head=128, d_ff=13696, vocab=151552, act="swiglu",
    rope_fraction=0.5,
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=512, act="swiglu",
    rope_fraction=0.5,
)
