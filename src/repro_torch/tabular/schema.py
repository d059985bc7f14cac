"""Tabular schema: column typing for graph feature tables.

A feature table is ``cont`` (N, n_cont) float32 plus ``cat`` (N, n_cat)
int32, described by a :class:`TableSchema`.  Categorical cardinalities
follow the paper's embedding-size rule ``min(600, round(1.6·|D|^0.56))``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TableSchema:
    n_cont: int
    cat_cards: Tuple[int, ...]        # cardinality per categorical column

    @property
    def n_cat(self) -> int:
        return len(self.cat_cards)

    def embed_dims(self) -> Tuple[int, ...]:
        """Paper §12: min(600, round(1.6 · |D|^0.56))."""
        return tuple(int(min(600, round(1.6 * c ** 0.56)))
                     for c in self.cat_cards)



def infer_schema(cont: np.ndarray, cat: np.ndarray) -> TableSchema:
    """The schema of a host table: ``n_cont`` columns and, per categorical
    column, ``max + 1`` categories (1 for an empty table)."""
    cards = tuple(int(cat[:, j].max()) + 1 if cat.shape[0] else 1
                  for j in range(cat.shape[1]))
    return TableSchema(n_cont=cont.shape[1], cat_cards=cards)
