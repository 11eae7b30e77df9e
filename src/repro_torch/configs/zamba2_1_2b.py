"""zamba2-1.2b [arXiv:2411.15242]: 38 Mamba2 layers d=2048 (ssm_state 64)
with a SHARED attention block (32H MHA) applied every 7 layers; d_ff=8192
(shared block MLP), vocab 32000."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.mamba2 import Mamba2Config

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, rope_theta=1e4,
    mamba=Mamba2Config(d_model=2048, d_state=64, head_dim=64),
    attn_every=7,
    supports_long_context=True,
)
