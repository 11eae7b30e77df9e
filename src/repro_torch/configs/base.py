"""Architecture config schema + registry of the LM stack's architectures
(the JAX package's ``configs/base.py``, field for field)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig
from repro_torch.models.xlstm import XLSTMConfig


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | xlstm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    qk_norm: bool = False
    gated_mlp: bool = True
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # MoE
    moe: Optional[MoEConfig] = None
    # SSM / hybrid
    mamba: Optional[Mamba2Config] = None
    xlstm: Optional[XLSTMConfig] = None
    slstm_positions: Tuple[int, ...] = ()     # xlstm: indices of sLSTM blocks
    attn_every: int = 0          # zamba2: shared attn block every k mamba layers
    # encoder-decoder
    n_encoder_layers: int = 0
    # modality frontend stubs ([audio]/[vlm]): embeddings provided by input_specs
    frontend: Optional[str] = None            # 'audio' | 'vision'
    frontend_len: int = 256                   # frames / patches
    # training behaviour
    remat: bool = True
    scan_layers: bool = True      # False: unroll (decode SPMD experiments)
    # notes for DESIGN/EXPERIMENTS (skips, applicability)
    supports_long_context: bool = False       # sub-quadratic decode?

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    def attn_cfg(self):
        from repro_torch.models.layers import AttnConfig
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                          qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
                          rope_theta=self.rope_theta)

    def reduced(self) -> "ArchConfig":
        """A smoke-test-sized config of the same family (CPU, 1 device)."""
        kw: Dict = dict(
            n_layers=min(self.n_layers, 2), d_model=128,
            n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=32, d_ff=256, vocab_size=512, frontend_len=8)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, d_model=128, d_ff_expert=64, num_experts=4,
                top_k=2,
                d_ff_shared=(64 if self.moe.num_shared_experts else 0))
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(self.mamba, d_model=128,
                                              d_state=16, head_dim=32)
            kw["n_layers"] = min(self.n_layers, 5)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, d_model=128,
                                              n_heads=4)
            kw["n_layers"] = 4
            kw["slstm_positions"] = (3,)
        if self.attn_every:
            kw["n_layers"] = 5
            kw["attn_every"] = 2
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "xlstm-125m",
    "seamless-m4t-medium", "internlm2-20b", "mistral-large-123b",
    "starcoder2-15b", "qwen2.5-14b", "zamba2-1.2b", "internvl2-2b",
)

_MODULE_OF = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internlm2-20b": "internlm2_20b",
    "mistral-large-123b": "mistral_large_123b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen2.5-14b": "qwen2_5_14b",
    "zamba2-1.2b": "zamba2_1_2b",
    "internvl2-2b": "internvl2_2b",
    "kws-paper": "kws_paper",
}


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.CONFIG


# Input shapes assigned to the LM family (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
