"""Revert stacks: roll back partial multi-step operations.

reference: pkg/revert — endpoint regeneration pushes a revert function per
completed step; on failure the stack runs in reverse (pkg/endpoint/
bpf.go:561-584).
"""

from __future__ import annotations

from typing import Callable


class RevertStack:
    """reference: revert/revert.go RevertStack."""

    def __init__(self) -> None:
        self._funcs: list[Callable[[], None]] = []

    def push(self, revert_func: Callable[[], None]) -> None:
        self._funcs.append(revert_func)

    def revert(self) -> None:
        """Run in reverse order; the first failure aborts (matching the
        reference's error-on-first-failure)."""
        while self._funcs:
            f = self._funcs.pop()
            f()

    def __len__(self) -> int:
        return len(self._funcs)


class FinalizeList:
    """Functions to run on success (reference: revert.FinalizeList)."""

    def __init__(self) -> None:
        self._funcs: list[Callable[[], None]] = []

    def append(self, f: Callable[[], None]) -> None:
        self._funcs.append(f)

    def finalize(self) -> None:
        for f in self._funcs:
            f()
        self._funcs.clear()
