"""starcoder2-15b [arXiv:2402.19173]: 40L d=6144 48H (GQA kv=4, head_dim 128)
d_ff=24576 (non-gated GeLU), vocab 49152, RoPE, biases."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152, gated_mlp=False, qkv_bias=True,
    rope_theta=1e5,
)
