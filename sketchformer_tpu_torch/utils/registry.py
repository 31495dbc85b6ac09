"""Name -> class registries for models and dataloaders.

Capability parity with the reference's registry pattern (reference:
models/__init__.py, dataloaders/__init__.py — string-name lookup used by the
training CLI to select model and dataloader classes).
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from None

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
