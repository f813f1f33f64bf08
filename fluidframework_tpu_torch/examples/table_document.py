"""TableDocument — collaborative spreadsheet over SharedMatrix.

Reference parity: examples/data-objects/table-document (+ table-view):
a SharedMatrix holds the cells (row/col inserts get merge-tree OT, cell
writes are LWW), a SharedMap holds per-column headers, and "=SUM(...)"
formulas evaluate client-side over the converged grid — concurrent
structural edits (one user inserting a row while another sets cells)
resolve deterministically on every replica.

Run:  python -m fluidframework_tpu_torch.examples.table_document
"""

from __future__ import annotations

from typing import Any

from ..dds.map import SharedMap
from ..dds.matrix import SharedMatrix
from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

GRID_ID = "grid"
HEADERS_ID = "headers"


class TableDocument(DataObject):
    def initializing_first_time(self, props=None) -> None:
        grid = self.runtime.create_channel(GRID_ID,
                                           SharedMatrix.channel_type)
        headers = self.runtime.create_channel(HEADERS_ID,
                                              SharedMap.channel_type)
        self.root.set(GRID_ID, grid.handle)
        self.root.set(HEADERS_ID, headers.handle)

    @property
    def grid(self) -> SharedMatrix:
        return self.root.get(GRID_ID).get()

    @property
    def headers(self) -> SharedMap:
        return self.root.get(HEADERS_ID).get()

    # -- table operations ------------------------------------------------------

    def ensure_size(self, rows: int, cols: int) -> None:
        if self.grid.row_count < rows:
            self.grid.insert_rows(self.grid.row_count,
                                  rows - self.grid.row_count)
        if self.grid.col_count < cols:
            self.grid.insert_cols(self.grid.col_count,
                                  cols - self.grid.col_count)

    def set_header(self, col: int, name: str) -> None:
        self.headers.set(f"c{col}", name)

    def set_cell(self, row: int, col: int, value: Any) -> None:
        self.grid.set_cell(row, col, value)

    def insert_row(self, pos: int) -> None:
        self.grid.insert_rows(pos, 1)

    def value_at(self, row: int, col: int) -> Any:
        """Cell value with client-side formula evaluation: a string
        "=SUM(c)" sums column c's numeric cells (table-view's eval)."""
        raw = self.grid.get_cell(row, col)
        if isinstance(raw, str) and raw.startswith("=SUM(") \
                and raw.endswith(")"):
            col_idx = int(raw[5:-1])
            total = 0
            for r in range(self.grid.row_count):
                if r == row:
                    continue
                cell = self.grid.get_cell(r, col_idx)
                if isinstance(cell, (int, float)):
                    total += cell
            return total
        return raw

    def table(self) -> list[list[Any]]:
        return [[self.value_at(r, c) for c in range(self.grid.col_count)]
                for r in range(self.grid.row_count)]


table_document_factory = DataObjectFactory("table-document", TableDocument)


def main(argv=None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    args = parser.parse_args(argv)

    with open_document("table-document", args) as session:
        creator, joiner, settle = session
        creator.ensure_size(3, 2)
        creator.set_header(0, "qty")
        creator.set_header(1, "price")
        settle()
        # One user fills cells while the other inserts a row above them
        # — the permutation vector keeps every value on ITS row.
        creator.set_cell(0, 0, 10)
        creator.set_cell(1, 0, 32)
        joiner.insert_row(0)
        settle()
        assert creator.grid.row_count == joiner.grid.row_count == 4
        # The filled cells slid down with the inserted row.
        assert [creator.grid.get_cell(r, 0) for r in range(4)] == \
            [None, 10, 32, None]
        creator.set_cell(3, 0, "=SUM(0)")
        settle()
        assert creator.table() == joiner.table()
        assert creator.value_at(3, 0) == joiner.value_at(3, 0) == 42
        print(f"table_document: {creator.table()}")


if __name__ == "__main__":
    main()
