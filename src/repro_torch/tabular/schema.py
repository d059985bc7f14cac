"""Tabular schema: column typing for graph feature tables.

A feature table is ``cont`` (N, n_cont) float32 plus ``cat`` (N, n_cat)
int32, described by a :class:`TableSchema`.  Categorical cardinalities
follow the paper's embedding-size rule ``min(600, round(1.6·|D|^0.56))``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

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


def split_columns(x: np.ndarray, cont_idx: List[int], cat_idx: List[int]):
    """A raw host table → ``cont`` float32 columns and ``cat`` int32
    codes (each categorical column's sorted distinct values, numbered
    from 0)."""
    cont = x[:, cont_idx].astype(np.float32)
    cat = np.zeros((x.shape[0], len(cat_idx)), np.int32)
    for j, c in enumerate(cat_idx):
        _, inv = np.unique(x[:, c], return_inverse=True)
        cat[:, j] = inv
    return cont, cat
