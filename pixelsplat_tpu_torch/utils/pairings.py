"""Heterogeneous view-pair index tables.

The port's own copy of `pixelsplat_tpu/utils/pairings.py`: integer tables
for "each view against all other views" gathers and their transpose,
computed in numpy from the (static) number of views.
"""

from __future__ import annotations

import numpy as np


def generate_heterogeneous_index(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(index_self, index_other), each (n, n-1): for row v, the other views."""
    arange = np.arange(n)
    index_self = np.repeat(arange[:, None], n - 1, axis=1)
    index_other = np.repeat(arange[None, :], n, axis=0) + np.triu(np.ones((n, n), dtype=np.int64))
    return index_self, index_other[:, :-1]


def generate_heterogeneous_index_transpose(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Index tables that transpose a (view, other_view) table; applying the
    transpose twice is the identity."""
    arange = np.arange(n)
    ones = np.ones((n, n), dtype=np.int64)
    index_self = np.repeat(arange[None, :], n, axis=0) + np.triu(ones)
    index_other = np.repeat(arange[:, None], n, axis=1) - (1 - np.triu(ones))
    return index_self[:, :-1], index_other[:, :-1]
