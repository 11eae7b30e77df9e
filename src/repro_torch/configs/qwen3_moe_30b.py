"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4,
head_dim 128, QK-norm) d_ff(expert)=768, vocab 151936, MoE 128 experts top-8."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=6144,  # dense-equivalent (unused; MoE on every layer)
    vocab_size=151936, qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(d_model=2048, d_ff_expert=768, num_experts=128, top_k=8),
)
