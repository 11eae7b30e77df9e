"""internvl2-2b [arXiv:2404.16821] ([vlm]): InternViT frontend (STUB patch
embeddings per assignment) + internlm2-1.8b LM: 24L d=2048 16H (GQA kv=8,
head_dim 128) d_ff=8192, vocab 92553."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553, rope_theta=1e6,
    frontend="vision", frontend_len=256,   # precomputed ViT patch embeddings
)
