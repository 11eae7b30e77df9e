"""The paper's own model (reconstruction notes: DESIGN.md §4)."""
from repro_torch.models.kws import KWSConfig

CONFIG = KWSConfig()          # full 16000-sample, 6-layer BNN
