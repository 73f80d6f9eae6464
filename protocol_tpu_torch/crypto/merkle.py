"""Poseidon Merkle tree (circuit/src/merkle_tree/native.rs).

Pairs of nodes are hashed as ``Poseidon(left, right, 0, 0, 0)``; missing
leaves are zero-filled to ``2**height``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .poseidon import permute


def _hash_pair(left: int, right: int) -> int:
    return permute([left, right, 0, 0, 0])[0]


@dataclass
class MerkleTree:
    """Levels of the tree: ``levels[0]`` are the (padded) leaves,
    ``levels[height][0]`` the root."""

    levels: list[list[int]]
    height: int

    @property
    def root(self) -> int:
        return self.levels[self.height][0]

    @classmethod
    def build(cls, leaves: list[int], height: int) -> "MerkleTree":
        assert len(leaves) <= 2**height
        level = list(leaves) + [0] * (2**height - len(leaves))
        levels = [level]
        for _ in range(height):
            level = [
                _hash_pair(level[i], level[i + 1]) for i in range(0, len(level), 2)
            ]
            levels.append(level)
        return cls(levels=levels, height=height)


@dataclass
class Path:
    """Authentication path: per level the (left, right) sibling pair, with
    the root appended as the final row (merkle_tree/native.rs::Path)."""

    value: int
    pairs: list[tuple[int, int]]

    @classmethod
    def find(cls, tree: MerkleTree, value: int) -> "Path":
        index = tree.levels[0].index(value)
        pairs = []
        for level in range(tree.height):
            row = tree.levels[level]
            if index % 2 == 1:
                pairs.append((row[index - 1], row[index]))
            else:
                pairs.append((row[index], row[index + 1]))
            index //= 2
        pairs.append((tree.root, 0))
        return cls(value=value, pairs=pairs)

    def verify(self) -> bool:
        for i in range(len(self.pairs) - 1):
            parent = _hash_pair(*self.pairs[i])
            if parent not in self.pairs[i + 1]:
                return False
        return True
