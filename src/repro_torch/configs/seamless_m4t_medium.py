"""seamless-m4t-medium [arXiv:2308.11596] ([audio]): enc-dec backbone,
12 enc + 12 dec layers, d=1024 16H (kv=16, head_dim 64) d_ff=4096,
vocab 256206.  Speech frontend is a ShapeDtypeStruct stub per assignment."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=1024, n_heads=16,
    n_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=256206,
    gated_mlp=False, rope_theta=1e4,
    frontend="audio", frontend_len=1024,   # precomputed speech frames
)
