"""PLONKish constraint system with a MockProver-equivalent checker.

The reference's proving stack is Halo2: circuits assign witnesses into
advice/fixed/instance columns, custom gates constrain polynomial
relations over rows (with rotations), and copy constraints tie cells
together; `MockProver` checks all of it without cryptographic proving
(the testing backbone; circuit/src/lib.rs:56-163
for the chip framework this re-imagines).

This is a fresh design, not a Halo2 port: a *trace* of named columns,
gates as Python expressions evaluated row-wise over the Bn254 field, a
union-find for copy constraints, and region-free sequential row
allocation (chips return the rows they used).  Gate degree is
unconstrained because satisfaction is checked by direct evaluation —
no quotient polynomial — which keeps chip layouts simple while staying
faithful to the constrain-then-check model.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable

from ..crypto.field import MODULUS

P = MODULUS


@dataclass(frozen=True)
class Column:
    """A named column of one of three kinds: 'advice' (witness),
    'fixed' (circuit constants), 'instance' (public inputs)."""

    name: str
    kind: str


@dataclass(frozen=True)
class Cell:
    column: Column
    row: int


class RowView:
    """Accessor handed to gate polynomials: ``view[col]`` is the value
    at the gate's row, ``view[col, k]`` at rotation +k."""

    __slots__ = ("cs", "row")

    def __init__(self, cs: "ConstraintSystem", row: int):
        self.cs = cs
        self.row = row

    def __getitem__(self, key):
        if isinstance(key, tuple):
            col, rot = key
        else:
            col, rot = key, 0
        return self.cs.value(col, self.row + rot)


@dataclass
class Gate:
    """A named constraint: ``poly(view)`` must return 0 (or a list of
    zeros) at every row where ``selector`` is enabled."""

    name: str
    selector: str
    poly: Callable[[RowView], int | list[int]]


@dataclass
class Failure:
    gate: str
    row: int
    detail: str


@dataclass
class Lookup:
    """A lookup argument: at every row where ``selector`` is enabled,
    the tuple of ``columns`` values must be a member of ``table``
    (Halo2's lookup argument, checked by direct membership here)."""

    name: str
    selector: str
    columns: tuple[Column, ...]
    table: frozenset


class ConstraintSystem:
    """Columns + trace + gates + copy constraints."""

    def __init__(self):
        self.columns: dict[str, Column] = {}
        self.trace: dict[Column, dict[int, int]] = {}
        self.selectors: dict[str, set[int]] = {}
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        self.copies: list[tuple[Cell, Cell]] = []
        self.n_rows = 0
        self._chips: dict[str, object] = {}

    def register_chip(self, key: str, fingerprint: object = None) -> bool:
        """One-time chip registration: returns True on first call for
        ``key``; later calls must carry an identical parameter
        fingerprint (a second chip instance with different parameters
        sharing columns/gates would be silently unsound)."""
        if key not in self._chips:
            self._chips[key] = fingerprint
            return True
        if self._chips[key] != fingerprint:
            raise AssertionError(
                f"chip {key!r} re-registered with different parameters"
            )
        return False

    # -- construction ---------------------------------------------------

    def column(self, name: str, kind: str = "advice") -> Column:
        assert kind in ("advice", "fixed", "instance")
        if name in self.columns:
            col = self.columns[name]
            assert col.kind == kind, f"column {name} re-declared as {kind}"
            return col
        col = Column(name, kind)
        self.columns[name] = col
        self.trace[col] = {}
        return col

    def gate(self, name: str, selector: str, poly) -> None:
        self.selectors.setdefault(selector, set())
        self.gates.append(Gate(name, selector, poly))

    def lookup(self, name: str, selector: str, columns, table) -> None:
        self.selectors.setdefault(selector, set())
        self.lookups.append(
            Lookup(name, selector, tuple(columns), frozenset(table))
        )

    def alloc_rows(self, n: int) -> int:
        """Reserve ``n`` fresh rows; returns the first row index."""
        start = self.n_rows
        self.n_rows += n
        return start

    def assign(self, col: Column, row: int, value: int) -> Cell:
        self.trace[col][row] = value % P
        self.n_rows = max(self.n_rows, row + 1)
        return Cell(col, row)

    def enable(self, selector: str, row: int) -> None:
        self.selectors.setdefault(selector, set()).add(row)

    def copy(self, a: Cell, b: Cell) -> None:
        """Constrain two cells equal (Halo2's equality/permutation
        argument, checked directly here)."""
        self.copies.append((a, b))

    # -- evaluation -----------------------------------------------------

    def value(self, col: Column, row: int) -> int:
        return self.trace[col].get(row, 0)

    def verify(self, max_failures: int = 10) -> list[Failure]:
        """Evaluate every gate at every enabled row and check copy
        constraints; returns failures (empty = satisfied), the
        MockProver::verify analog."""
        failures: list[Failure] = []
        for gate in self.gates:
            rows = self.selectors.get(gate.selector, ())
            for row in sorted(rows):
                out = gate.poly(RowView(self, row))
                values = out if isinstance(out, (list, tuple)) else [out]
                for i, v in enumerate(values):
                    if v % P != 0:
                        failures.append(
                            Failure(gate.name, row, f"poly #{i} = {v % P:#x}")
                        )
                        if len(failures) >= max_failures:
                            return failures
        for lookup in self.lookups:
            for row in sorted(self.selectors.get(lookup.selector, ())):
                entry = tuple(self.value(c, row) for c in lookup.columns)
                key = entry[0] if len(entry) == 1 else entry
                if key not in lookup.table:
                    failures.append(
                        Failure(lookup.name, row, f"{key!r} not in lookup table")
                    )
                    if len(failures) >= max_failures:
                        return failures
        for a, b in self.copies:
            va, vb = self.value(a.column, a.row), self.value(b.column, b.row)
            if va != vb:
                failures.append(
                    Failure(
                        "copy",
                        a.row,
                        f"{a.column.name}[{a.row}] = {va:#x} != "
                        f"{b.column.name}[{b.row}] = {vb:#x}",
                    )
                )
                if len(failures) >= max_failures:
                    return failures
        return failures

    def assert_satisfied(self) -> None:
        failures = self.verify()
        if failures:
            msgs = "\n".join(f"  {f.gate} @ row {f.row}: {f.detail}" for f in failures)
            raise AssertionError(f"constraint system not satisfied:\n{msgs}")

    # -- stats ----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "rows": self.n_rows,
            "columns": len(self.columns),
            "gates": len(self.gates),
            "copies": len(self.copies),
            "assignments": sum(len(v) for v in self.trace.values()),
        }
