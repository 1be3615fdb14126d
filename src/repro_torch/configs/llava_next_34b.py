"""llava-next-34b [vlm] — anyres tiling; patch frontend STUB [hf:llava-hf]."""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    n_patches=576, patch_dim=1024,
)
