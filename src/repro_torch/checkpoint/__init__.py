"""Persistent serving state of the port.

  profiles.py   — per-user customization profiles on disk (``ProfileStore``),
                  one atomically written ``.npz`` per user, the JAX
                  package's file layout
"""

from repro_torch.checkpoint.profiles import (ProfileStore, load_profile,
                                             save_profile)

__all__ = ["ProfileStore", "load_profile", "save_profile"]
