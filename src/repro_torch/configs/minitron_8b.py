"""minitron-8b: dense 32L, pruned Nemotron (squared-ReLU MLP, GQA kv=8).
[arXiv:2407.14679]"""
from repro_torch.models.common import ModelConfig

ARCH = "minitron-8b"

CONFIG = ModelConfig(
    name=ARCH, family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv=8, d_head=128, d_ff=16384, vocab=256000, act="relu2",
)

SMOKE = ModelConfig(
    name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=512, act="relu2",
)
