"""What decides ``correct``: the comparison the configuration names
(``benchmark/checks/<check>.py``) on what the timed path produced, with the
window's batches it compares drawn from the seed (`Reservoir`), and each
number it compares printed beside its limit."""

from __future__ import annotations

import random
import sys

from .cells import module


class Reservoir:
    """A uniform sample of ``size`` of the window's batches, drawn from the
    seed as the batches complete (Algorithm R): the program's outputs of a
    sampled batch are kept, by reference, until the window closes."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def checker(cell):
    """The module of the cell's check, by the configuration's ``check``."""
    return module("checks", cell.config["check"])


def judge(cell, pool, kept, flags, block: int) -> tuple[bool, dict, int, int]:
    """(correct, {name: (value, limit)}, answers compared, failed)."""
    return checker(cell).judge(cell, pool, kept, flags, block)


def print_numbers(numbers: dict, lanes: int) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    print(f"check: {lanes} lanes compared with the reference", file=sys.stderr)
    for name, (value, limit) in numbers.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)


def as_json(numbers: dict) -> dict:
    return {name: {"value": value, "limit": limit} for name, (value, limit) in numbers.items()}
