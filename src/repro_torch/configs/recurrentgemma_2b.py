"""recurrentgemma-2b [hybrid] — RG-LRU + local attn 1:2 [arXiv:2402.19427; hf]."""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    sliding_window=2048, rnn_per_attention=2, rnn_width=2560,
    mlp_act="gelu", subquadratic=True,
)
