"""DiceRoller — the canonical hello-world data object.

Reference parity: the dice-roller sample shape (a one-key SharedMap on
the root; every client sees the same roll): the smallest possible
DataObject demonstrating create/load, LWW state and change events.

Run:  python -m fluidframework_tpu_torch.examples.dice_roller
"""

from __future__ import annotations

import random

from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

DICE_KEY = "diceValue"


class DiceRoller(DataObject):
    def initializing_first_time(self, props=None) -> None:
        self.root.set(DICE_KEY, 1)

    def roll(self, rng: random.Random | None = None) -> int:
        value = (rng or random).randint(1, 6)
        self.root.set(DICE_KEY, value)
        return value

    @property
    def value(self) -> int:
        return self.root.get(DICE_KEY)


dice_roller_factory = DataObjectFactory("dice-roller", DiceRoller)


def main(argv=None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    args = parser.parse_args(argv)

    with open_document("dice-roller", args) as session:
        creator, joiner, settle = session
        rolled = creator.roll(random.Random(4))
        settle()
        assert joiner.value == rolled
        again = joiner.roll(random.Random(9))
        settle()
        assert creator.value == again
        print(f"dice_roller: both clients see {creator.value}")


if __name__ == "__main__":
    main()
