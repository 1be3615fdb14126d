"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64,
    mixer="rwkv6", subquadratic=True,
)
