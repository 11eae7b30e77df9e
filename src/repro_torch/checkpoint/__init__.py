"""Persistent state of the port.

  checkpointer.py — training checkpoints (``Checkpointer``): params,
                    optimizer state, data cursor and RNG key, committed
                    atomically, the JAX package's layout
  profiles.py     — per-user customization profiles on disk
                    (``ProfileStore``), one atomically written ``.npz`` per
                    user, the JAX package's file layout
"""

from repro_torch.checkpoint.checkpointer import (Checkpointer, load_pytree,
                                                 save_pytree)
from repro_torch.checkpoint.profiles import (ProfileStore, load_profile,
                                             save_profile)

__all__ = ["Checkpointer", "load_pytree", "save_pytree", "ProfileStore",
           "load_profile", "save_profile"]
