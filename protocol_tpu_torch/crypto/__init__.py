"""Cryptographic primitives: Bn254 Fr, Poseidon, BabyJubJub EdDSA.

Every primitive has a pure-Python exact implementation here, mirroring the
reference's ``native/`` modules; the C++ fast path (``crypto.native``,
built from the repository's ``native/`` sources) accelerates batch
attestation verification and must stay bit-compatible.
"""

from __future__ import annotations

from . import babyjubjub, blake512, eddsa, field, poseidon  # noqa: F401
from .field import MODULUS as _P
from .poseidon import POSEIDON_5, PoseidonSponge, permute


def group_pks_hash(pks: list[eddsa.PublicKey]) -> int:
    """The sponge half of the protocol message hash that depends only
    on the neighbour group: ``sponge(xs ‖ ys)``.  Cacheable per group —
    every attestation against the same fixed set shares it, so the
    admission plane hashes it once instead of once per signature."""
    pk_sponge = PoseidonSponge()
    pk_sponge.update([pk.point.x for pk in pks])
    pk_sponge.update([pk.point.y for pk in pks])
    return pk_sponge.squeeze()


def _permute_rows(states: list[list[int]]) -> list[list[int]]:
    """Width-5 Poseidon permutation over many states at once: one
    native batch call when the C++ runtime is available, else the pure
    Python permutation per row (bit-identical either way)."""
    from . import native as cnative

    if len(states) > 1 and cnative.available():
        return cnative.poseidon_permute_batch(states)
    return [permute(s) for s in states]


def permute_one(state: list[int]) -> list[int]:
    """One width-5 Poseidon permutation through the C++ runtime when it
    is available (one call, ~1000x the pure-Python rate), else in pure
    Python; bit-identical either way.  For sequential chains that cannot
    batch, such as the commitment prover's digest."""
    from . import native as cnative

    if cnative.available():
        return cnative.poseidon_permute_batch([state])[0]
    return permute(state)


def message_hash_batch(pks_hash: int, scores: list[list[int]]) -> list[int]:
    """Per-row message hashes for a precomputed ``pks_hash``:
    ``Poseidon(pks_hash, sponge(row), 0, 0, 0)`` for every row, with
    the sponge chunks and the final permutation batched across rows
    (the admission plane's verify workers hash whole batches in two or
    three native permute calls instead of ~3 Python permutes each).
    Bit-identical to :func:`calculate_message_hash`'s per-row half."""
    width = POSEIDON_5.width
    n_rows = len(scores)
    rows = [[x % _P for x in row] for row in scores]
    states = [[0] * width for _ in range(n_rows)]
    chunks = max((len(row) + width - 1) // width for row in rows) if rows else 0
    # Sponge absorb: chunk k of every row folds + permutes together —
    # rows shorter than k*width chunks sit out that round unchanged.
    for k in range(chunks):
        active = [i for i, row in enumerate(rows) if k * width < len(row)]
        merged = []
        for i in active:
            chunk = rows[i][k * width : (k + 1) * width]
            chunk = chunk + [0] * (width - len(chunk))
            merged.append([(chunk[j] + states[i][j]) % _P for j in range(width)])
        for i, state in zip(active, _permute_rows(merged)):
            states[i] = state
    # Final binding permute, batched the same way.
    finals = _permute_rows([[pks_hash, states[i][0], 0, 0, 0] for i in range(n_rows)])
    return [f[0] for f in finals]


def calculate_message_hash(
    pks: list[eddsa.PublicKey], scores: list[list[int]]
) -> tuple[int, list[int]]:
    """Protocol message hash (circuit/src/lib.rs:225-256).

    ``pks_hash = sponge(xs ‖ ys)``; for each score row,
    ``Poseidon(pks_hash, sponge(row), 0, 0, 0)``.  Returns
    ``(pks_hash, per-row message hashes)``.
    """
    n = len(pks)
    for row in scores:
        assert len(row) == n
    pks_hash = group_pks_hash(pks)
    return pks_hash, message_hash_batch(pks_hash, scores)
