"""Name -> entry registry (counterpart of srl_tpu/core/registry.py)."""
from __future__ import annotations

from typing import Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, entry: T) -> T:
        self._entries[name] = entry
        return entry

    def __getitem__(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Registered: {sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()
