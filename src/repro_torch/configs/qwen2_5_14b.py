"""qwen2.5-14b [hf:Qwen/Qwen2.5-14B]: 48L d=5120 40H (GQA kv=8, head_dim 128)
d_ff=13824, vocab 152064, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)
