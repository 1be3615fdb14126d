"""whisper-medium [audio] — enc-dec; conv frontend STUB [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64,
    encoder_layers=24, encoder_seq=1500, mlp_act="gelu",
)
