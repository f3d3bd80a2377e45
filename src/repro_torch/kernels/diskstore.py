"""Versioned JSON disk store: the autotuner's persistent cache.

Counterpart of ``repro/kernels/diskstore.py`` (the port keeps its own
copy; it imports nothing of the reference).  The store is a ``{key:
entry}`` map keyed on a problem signature digest:

* **load** tolerates a missing file silently, but a corrupted or unreadable
  one warns, naming the path and the parse error, and loads as EMPTY: the
  store is a performance artifact, never a correctness dependency;
* **save** merges on write (re-reads what another process persisted since
  the load, unions the maps, ours winning conflicts), then writes a
  temporary file and ``os.replace``s it in, so two concurrent writers keep
  each other's entries and a crashed writer never corrupts a reader;
* the ``version`` class attribute gates the schema: a file written at
  another version reads as empty (and is dropped by the merge).
"""
from __future__ import annotations

import json
import os
import warnings


class VersionedJsonStore:
    """JSON-file-backed ``{key: entry}`` map with versioned, merge-on-write
    atomic persistence.  Subclasses pin ``version``."""

    version: int = 1

    def __init__(self, path: str):
        self.path = path
        self.entries: dict = {}

    @classmethod
    def load(cls, path: str) -> "VersionedJsonStore":
        store = cls(path)
        store.entries = cls._read(path, warn=True)
        return store

    @classmethod
    def _read(cls, path: str, *, warn: bool) -> dict:
        try:
            with open(path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError) as e:
            if warn:
                warnings.warn(
                    f"{cls.__name__}: could not read {path} "
                    f"({type(e).__name__}: {e}); loading it as empty: the "
                    "entries persisted there are lost until recorded again",
                    stacklevel=3)
            return {}
        if (isinstance(raw, dict) and raw.get("version") == cls.version
                and isinstance(raw.get("entries"), dict)):
            return raw["entries"]
        return {}

    def get(self, key: str):
        entry = self.entries.get(key)
        return entry if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry

    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # merge on write: a concurrent writer's entries survive, ours win
        # conflicts (we hold the newest measurement for our keys)
        disk = self._read(self.path, warn=False)
        self.entries = {**disk, **self.entries}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": self.version, "entries": self.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
