"""qwen3-moe-235b-a22b: 94L MoE, 128 experts top-8, GQA kv=4, qk-norm.
[hf:Qwen/Qwen3-235B-A22B family]"""
from repro_torch.models.common import ModelConfig, MoEConfig

ARCH = "qwen3-moe-235b-a22b"

CONFIG = ModelConfig(
    name=ARCH, family="moe", n_layers=94, d_model=4096, n_heads=64,
    n_kv=4, d_head=128, d_ff=1536, vocab=151936, act="swiglu",
    qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8),
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, d_head=16, d_ff=96, vocab=512, act="swiglu", qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2),
)
