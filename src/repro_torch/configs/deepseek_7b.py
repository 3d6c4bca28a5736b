"""deepseek-7b — llama-arch dense LM [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchConfig, register_arch

DEEPSEEK_7B = register_arch(ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954; hf",
))
