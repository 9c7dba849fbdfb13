"""whisper-medium: 24L encoder + 24L decoder, MHA, conv frontend STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.models.common import ModelConfig

ARCH = "whisper-medium"

CONFIG = ModelConfig(
    name=ARCH, family="encdec", n_layers=24, n_enc_layers=24, d_model=1024,
    n_heads=16, n_kv=16, d_head=64, d_ff=4096, vocab=51865, act="gelu",
    norm="layer", tie_embeddings=True, n_frontend_tokens=1500,
    norm_eps=1e-5,
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=512,
    act="gelu", norm="layer", tie_embeddings=True, n_frontend_tokens=8,
    norm_eps=1e-5,
)
