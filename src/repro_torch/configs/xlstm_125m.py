"""xlstm-125m [arXiv:2405.04517]: 12 blocks d=768, 4 heads, mLSTM backbone
with sLSTM blocks interleaved (paper's [7:1]-style ratio -> 2 sLSTM)."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.xlstm import XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(d_model=768, n_heads=4),
    slstm_positions=(5, 11),
    supports_long_context=True,
)
