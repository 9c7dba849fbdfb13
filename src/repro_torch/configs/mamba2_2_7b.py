"""mamba2-2.7b: attention-free SSD (state-space duality), 64L, state 128.
[arXiv:2405.21060]"""
from repro_torch.models.common import ModelConfig, SSMConfig

ARCH = "mamba2-2.7b"

CONFIG = ModelConfig(
    name=ARCH, family="ssm", n_layers=64, d_model=2560, n_heads=1,
    n_kv=1, d_head=1, d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="ssm", n_layers=2, d_model=64, n_heads=1,
    n_kv=1, d_head=1, d_ff=0, vocab=512, tie_embeddings=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8),
)
