"""Attributes of the program replaced for a while and then put back: how
the benchmark records, times and breaks the program without editing it."""
from __future__ import annotations


class Patches:
    """A context manager over replaced attributes: ``set(owner, name,
    make)`` puts ``make(current)`` in place of ``owner.name``; leaving puts
    every one back, the last first."""

    def __init__(self):
        self._undo = []

    def set(self, owner, name, make) -> "Patches":
        had, old = name in vars(owner), vars(owner).get(name)
        setattr(owner, name, make(getattr(owner, name)))
        self._undo.append((owner, name, had, old))
        return self

    def restore(self) -> None:
        for owner, name, had, old in reversed(self._undo):
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()
        return False
