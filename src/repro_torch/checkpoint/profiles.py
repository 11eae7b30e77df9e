"""Persistent store for per-user customization profiles.

Port of ``repro/checkpoint/profiles.py``.  A finished enrollment session
(``serving.customize``) produces a ``CustomizationResult``: compensated
integer IMC biases, the fine-tuned Q1.7 head and the run's accounting.
The store keeps it across server restarts, so
``StreamServer.install_custom`` (or ``submit(user_id=...)`` on a server
built with ``profiles=``) serves a returning user bit-identically to the
stream that enrolled (the arrays lie on exact fixed-point and integer
grids and are stored losslessly).

Layout: ONE ``<root>/<user_id>.npz`` per user, holding ``bias.<layer>``,
``fc_w``, ``fc_b`` and a JSON ``meta`` entry (epochs, n_utterances,
history, energy, the bias layers and the store's save counter ``seq``),
the same layout as the JAX package's, so a profile written by either
package loads in the other.  A save writes a temporary file beside its
destination, flushes and fsyncs it, then ``os.replace``s it into place: a
crash mid-save leaves the complete old profile or the complete new one.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import List, Optional

import numpy as np

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def _check_id(user_id: str) -> str:
    if not _ID_RE.fullmatch(user_id):
        raise ValueError(
            f"invalid profile id {user_id!r}: use letters, digits, '.', "
            f"'_' or '-' (must not start with a separator)")
    return user_id


def _meta(data) -> dict:
    return json.loads(bytes(data["meta"]).decode("utf-8"))


def save_profile(path: str, result, seq: Optional[int] = None) -> str:
    """Write one CustomizationResult to ``path`` (a .npz file) atomically:
    temporary file + fsync + ``os.replace``, safe against crashes even
    when it replaces a profile.  ``seq`` is the store's monotonic save
    counter (``ProfileStore.latest`` orders by it).  Returns ``path``."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    arrays = {f"bias.{name}": np.asarray(v)
              for name, v in result.bias.items()}
    arrays["fc_w"] = np.asarray(result.fc_w)
    arrays["fc_b"] = np.asarray(result.fc_b)
    meta = {
        "epochs": int(result.epochs),
        "n_utterances": int(result.n_utterances),
        "history": result.history,
        "energy": result.energy,
        "bias_layers": sorted(result.bias.keys()),
    }
    if seq is not None:
        meta["seq"] = int(seq)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                   dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(prefix=".tmp.profile.", suffix=".npz",
                               dir=parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)                      # atomic commit
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def load_profile(path: str):
    """Load a profile written by ``save_profile`` (of either package) as
    the port's CustomizationResult, its arrays bit-identical to the saved
    ones."""
    from repro_torch.serving.customize import CustomizationResult

    with np.load(path, allow_pickle=False) as data:
        meta = _meta(data)
        return CustomizationResult(
            bias={name: data[f"bias.{name}"]
                  for name in meta["bias_layers"]},
            fc_w=data["fc_w"], fc_b=data["fc_b"], epochs=meta["epochs"],
            n_utterances=meta["n_utterances"], history=meta["history"],
            energy=meta["energy"])


class ProfileStore:
    """A directory of per-user customization profiles::

        store = ProfileStore("profiles/")
        store.save("alice", session.result)       # after enrollment
        ...                                       # the server restarts
        srv.install_custom("alice-mic", store.load("alice"))
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._max_seq: Optional[int] = None    # scanned once, then kept

    def _path(self, user_id: str) -> str:
        return os.path.join(self.dir, _check_id(user_id) + ".npz")

    def _seq(self, user_id: str) -> int:
        """The stored save counter (0 for files without one)."""
        with np.load(self._path(user_id), allow_pickle=False) as data:
            return int(_meta(data).get("seq", 0))

    def save(self, user_id: str, result) -> str:
        """Atomically store ``result`` under ``user_id``, replacing any
        previous profile.  Returns the profile's path.  The save counter
        behind ``latest`` is scanned from disk once per store, then kept
        in memory."""
        if self._max_seq is None:
            self._max_seq = max((self._seq(u) for u in self.list()),
                                default=0)
        seq = self._max_seq + 1
        path = save_profile(self._path(user_id), result, seq=seq)
        self._max_seq = seq
        return path

    def load(self, user_id: str):
        """The stored CustomizationResult (FileNotFoundError if the user
        never enrolled)."""
        path = self._path(user_id)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no stored profile for {user_id!r}")
        return load_profile(path)

    def exists(self, user_id: str) -> bool:
        return os.path.exists(self._path(user_id))

    def mtime(self, user_id: str) -> Optional[int]:
        """The stored profile's ``st_mtime_ns`` (exact integer
        nanoseconds), or None without a profile.  Every ``save`` is a new
        inode with a new mtime, so a changed value tells a live server
        that its installed copy is stale."""
        try:
            return os.stat(self._path(user_id)).st_mtime_ns
        except FileNotFoundError:
            return None

    def list(self) -> List[str]:
        """User ids with a stored profile (temporary files and foreign
        entries excluded)."""
        return [name[:-4] for name in sorted(os.listdir(self.dir))
                if name.endswith(".npz") and _ID_RE.fullmatch(name[:-4])]

    def delete(self, user_id: str) -> bool:
        """Remove a stored profile; returns whether one existed."""
        try:
            os.remove(self._path(user_id))
            return True
        except FileNotFoundError:
            return False

    def latest(self) -> Optional[str]:
        """The most recently saved user id (by the save counter, which
        holds on coarse-mtime filesystems too), or None."""
        ids = self.list()
        if not ids:
            return None
        return max(ids, key=lambda u: (self._seq(u),
                                       os.path.getmtime(self._path(u))))
