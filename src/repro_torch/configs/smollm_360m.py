"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM]."""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64,
)
