"""recurrentgemma-9b: hybrid RG-LRU + local attention, pattern
(rec, rec, attn), MQA kv=1, 2k window. [arXiv:2402.19427]"""
from repro_torch.models.common import ModelConfig, HybridConfig

ARCH = "recurrentgemma-9b"

CONFIG = ModelConfig(
    name=ARCH, family="hybrid", n_layers=38, d_model=4096, n_heads=16,
    n_kv=1, d_head=256, d_ff=12288, vocab=256000, act="geglu",
    window=2048, tie_embeddings=True, scale_embed=True,
    hybrid=HybridConfig(d_rnn=4096, conv_width=4, window=2048,
                        pattern=("rec", "rec", "attn")),
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="hybrid", n_layers=3, d_model=64,
    n_heads=4, n_kv=1, d_head=16, d_ff=128, vocab=512, act="geglu",
    window=16, tie_embeddings=True, scale_embed=True,
    hybrid=HybridConfig(d_rnn=64, conv_width=4, window=16,
                        pattern=("rec", "rec", "attn")),
)
