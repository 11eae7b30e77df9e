"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16,
head_dim 128) d_ff(expert)=1408, vocab 151936, 60 routed top-4 + 4 shared."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=5632, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    moe=MoEConfig(d_model=2048, d_ff_expert=1408, num_experts=60, top_k=4,
                  num_shared_experts=4, d_ff_shared=5632),
)
