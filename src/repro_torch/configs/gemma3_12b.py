"""gemma3-12b [dense] — 5:1 local:global attention, 128k ctx [hf:google/gemma-3]."""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=240,
    sliding_window=1024, global_every=6,    # 5 local : 1 global
    mlp_act="gelu", subquadratic=True,
)
