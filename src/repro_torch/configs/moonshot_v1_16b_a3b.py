"""moonshot-v1-16b-a3b (Moonlight-16B-A3B): 48L MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.common import ModelConfig, MoEConfig

ARCH = "moonshot-v1-16b-a3b"

CONFIG = ModelConfig(
    name=ARCH, family="moe", n_layers=48, d_model=2048, n_heads=16,
    n_kv=16, d_head=128, d_ff=1408, vocab=163840, act="swiglu",
    rope_theta=50_000.0, moe=MoEConfig(n_experts=64, top_k=6),
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv=4, d_head=16, d_ff=96, vocab=512, act="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2),
)
