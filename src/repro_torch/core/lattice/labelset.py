"""Vectorised label-set kernels shared by every lattice DP.

Each lattice state keeps a *set of labels* — rows of a float array whose
columns are monotone-composing cost components (all minimised).  The DPs
spend almost all of their time deciding which labels survive, so the two
primitives here are the hot kernels of the whole query path:

* :func:`nondominated_rows` — dominance pruning of one label array
  (exact Pareto filter, optional multiplicative ε-dominance archive).
  Profiling showed the previous ``np.unique(axis=0)``-based filter paying
  ~110-170 µs per call in structured-dtype machinery alone; this version
  deduplicates via one ``np.lexsort`` pass and switches between a single
  pairwise dominance matrix (small sets) and a chunked frontier sweep
  (large sets), keeping the exact same keep semantics.
* :func:`grouped_nondominated` — dominance pruning of *many* states at
  once.  At ε == 0 a group key can be embedded as an extra objective
  pair ``(key, -key)``: a row can then only dominate a row with the same
  key, so one fused kernel call prunes every state of a DP block instead
  of one Python-level call per state.
* :func:`grouped_topk` — per-group k-smallest selection (the scalar
  k-best lattice's replacement for per-label ``bisect.insort``).

Keep semantics (pinned by ``tests/test_partition.py`` and the
hypothesis property in ``tests/test_vectorized_labels.py``):
exact-duplicate rows collapse to their first occurrence; a row is pruned
iff a distinct row is <= in every column; with ε > 0 a greedy archive in
lexicographic row order additionally drops rows within a factor (1+ε) of
a kept row in every column; returned indices are ascending.
:func:`nondominated_rows_scalar` is the retained scalar reference the
property tests compare against.
"""

from __future__ import annotations

import numpy as np

# above this many unique rows the (m, m, k) pairwise dominance tensor is
# replaced by a chunked sweep in lexicographic order (bounded memory, same
# result)
_PAIRWISE_MAX = 512
_CHUNK = 256


def _lex_unique(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique rows of ``pts`` in ascending lexicographic order (first
    column most significant) plus the original index of each row's first
    occurrence — what ``np.unique(pts, axis=0, return_index=True)``
    returns, without the structured-dtype round trip."""
    n = len(pts)
    order = np.lexsort(pts.T[::-1])      # stable: ties keep index order
    spts = pts[order]
    new = np.empty(n, dtype=bool)
    new[0] = True
    np.any(spts[1:] != spts[:-1], axis=1, out=new[1:])
    return spts[new], order[new]


def _pairwise_alive(uniq: np.ndarray) -> np.ndarray:
    """Boolean mask of rows of ``uniq`` (all distinct) not dominated by
    any other row.

    ``le[i, j] == row j <= row i in every column`` is accumulated one
    column at a time as chained 2-D comparisons — an order of magnitude
    cheaper than the equivalent (m, m, k) broadcast tensor, which spends
    most of its time materialising the 3-D intermediate."""
    c = uniq[:, 0]
    le = c[:, None] >= c[None, :]
    for ci in range(1, uniq.shape[1]):
        c = uniq[:, ci]
        le &= c[:, None] >= c[None, :]
    np.fill_diagonal(le, False)
    return ~le.any(axis=1)


def _covered_by(archive: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Boolean mask over ``cand`` rows having some archive row <= them in
    every column (same chained 2-D accumulation as
    :func:`_pairwise_alive`)."""
    a = archive[:, 0]
    c = cand[:, 0]
    le = a[None, :] <= c[:, None]
    for ci in range(1, cand.shape[1]):
        a = archive[:, ci]
        c = cand[:, ci]
        le &= a[None, :] <= c[:, None]
    return le.any(axis=1)


def _swept_frontier(uniq: np.ndarray, eps: float) -> np.ndarray:
    """Boolean keep-mask over ``uniq`` (distinct rows in ascending
    lexicographic order) from the greedy frontier sweep.

    Every exact dominator of a row sorts lexicographically before it, so
    checking candidates only against already-kept rows is exact at
    ε == 0 and is the canonical greedy archive at ε > 0.  Candidates are
    processed in chunks: each chunk is first tested against the kept
    archive in one batched comparison, then (ε == 0) against itself with
    one pairwise tensor — within-chunk dominance composes transitively
    with the archive, so the union test is exact — or (ε > 0)
    sequentially, because the archive grows inside the chunk.
    """
    m = len(uniq)
    scale = 1.0 + eps
    keep = np.zeros(m, dtype=bool)
    kept = np.empty_like(uniq)
    kcount = 0
    for s in range(0, m, _CHUNK):
        c = uniq[s:s + _CHUNK]
        if kcount:
            covered = _covered_by(kept[:kcount],
                                  c if eps == 0.0 else c * scale)
        else:
            covered = np.zeros(len(c), dtype=bool)
        if eps == 0.0:
            alive = _pairwise_alive(c) & ~covered
            rows = np.flatnonzero(alive)
        else:
            rows = []
            for i in np.flatnonzero(~covered):
                u = c[i] * scale
                lo = kcount - len(rows)   # archive rows added this chunk
                if len(rows) and (kept[lo:kcount] <= u).all(1).any():
                    continue
                kept[kcount] = c[i]
                kcount += 1
                rows.append(i)
            rows = np.asarray(rows, dtype=np.intp)
            keep[s + rows] = True
            continue
        nc = len(rows)
        kept[kcount:kcount + nc] = c[rows]
        kcount += nc
        keep[s + rows] = True
    return keep


def _direct_keep(pts: np.ndarray) -> np.ndarray:
    """Exact ε == 0 keep-indices for small arrays without the
    lexsort/dedup round trip: row i is dropped iff some row j is <= in
    every column and either differs somewhere (strict dominance) or is
    an identical earlier row (duplicate collapse to first occurrence).
    One chained (n, n) comparison pair per column."""
    c = pts[:, 0]
    le = c[:, None] <= c[None, :]
    eq = c[:, None] == c[None, :]
    for ci in range(1, pts.shape[1]):
        c = pts[:, ci]
        le &= c[:, None] <= c[None, :]
        eq &= c[:, None] == c[None, :]
    strict = le & ~eq
    dom = strict.any(axis=0) | np.triu(eq, 1).any(axis=0)
    return np.flatnonzero(~dom)


def nondominated_rows(pts: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Indices of rows of ``pts`` (every column minimised) surviving
    dominance pruning, ascending.

    Exact-duplicate rows collapse to one representative (the first
    occurrence).  With ``eps == 0`` the filter is exact: a row is pruned
    iff some distinct row is <= in every column.  With ``eps > 0`` a row
    is additionally pruned when a *kept* row is within a factor (1+eps)
    in every column (multiplicative ε-dominance, applied greedily in
    lexicographic order so mutually ε-close rows keep exactly one
    representative).
    """
    pts = np.asarray(pts)
    n = len(pts)
    if n <= 1:
        return np.arange(n)
    if n == 2:
        a, b = pts[0], pts[1]
        a_le = bool((a <= b).all())
        b_le = bool((b <= a).all())
        if a_le and b_le:                       # duplicates
            return np.array([0])
        if a_le or b_le:                        # strict dominance
            return np.array([0 if a_le else 1])
        if eps > 0.0:
            lex = 0 if tuple(a) < tuple(b) else 1
            if (pts[lex] <= pts[1 - lex] * (1.0 + eps)).all():
                return np.array([lex])
        return np.array([0, 1])
    if eps == 0.0 and n <= _PAIRWISE_MAX:
        return _direct_keep(pts)
    uniq, first = _lex_unique(pts)
    m = len(uniq)
    if m <= _PAIRWISE_MAX:
        alive = _pairwise_alive(uniq)
        uniq, first = uniq[alive], first[alive]
    if eps > 0.0 or m > _PAIRWISE_MAX:
        keep = _swept_frontier(uniq, eps)
        first = first[keep]
    return np.sort(first)


def nondominated_rows_scalar(pts: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Scalar reference implementation of :func:`nondominated_rows` —
    the unvectorised specification the hypothesis property tests compare
    the fast kernel against, label for label.

    Semantics, spelled out: deduplicate to first occurrences; drop every
    row some distinct row dominates (<= in all columns); then sweep the
    survivors in ascending lexicographic order keeping a greedy archive —
    a row is dropped when an already-kept row is <= row * (1+eps) in all
    columns (a no-op at eps == 0).  Returns ascending original indices.
    """
    pts = np.asarray(pts)
    rows = [tuple(map(float, r)) for r in pts]
    firsts: dict[tuple, int] = {}
    for i, r in enumerate(rows):
        firsts.setdefault(r, i)
    uniq = sorted(firsts)
    alive = []
    for r in uniq:
        dominated = any(o != r and all(x <= y for x, y in zip(o, r))
                        for o in uniq)
        if not dominated:
            alive.append(r)
    scale = 1.0 + eps
    kept: list[tuple] = []
    out: list[int] = []
    for r in alive:
        if any(all(x <= y * scale for x, y in zip(k, r)) for k in kept):
            continue
        kept.append(r)
        out.append(firsts[r])
    return np.asarray(sorted(out), dtype=np.intp)


def grouped_nondominated(pts: np.ndarray, keys: np.ndarray,
                         eps: float = 0.0) -> np.ndarray:
    """Indices (ascending) of rows surviving *per-group* dominance
    pruning: row i may only be pruned by rows j with ``keys[j] ==
    keys[i]``, with the exact per-group semantics of
    :func:`nondominated_rows`.

    At ε == 0 all groups are pruned in one fused kernel call by
    embedding the key as an extra objective pair ``(key, -key)``: a row
    is then <= another in every column only when their keys are equal,
    so plain dominance on the extended array *is* grouped dominance
    (duplicate collapse included — rows equal in the label columns but
    in different groups differ in the key columns).  ε > 0 falls back to
    one kernel call per group: the multiplicative archive test has no
    faithful encoding over the signed key column.
    """
    n = len(pts)
    if n <= 1:
        return np.arange(n)
    keys = np.asarray(keys)
    if eps == 0.0 and n <= _PAIRWISE_MAX:
        # direct pairwise path: group equality gates the comparison
        # matrices, so no key-embedding array is ever built
        gm = keys[:, None] == keys[None, :]
        c = pts[:, 0]
        le = gm & (c[:, None] <= c[None, :])
        eq = gm & (c[:, None] == c[None, :])
        for ci in range(1, pts.shape[1]):
            c = pts[:, ci]
            le &= c[:, None] <= c[None, :]
            eq &= c[:, None] == c[None, :]
        strict = le & ~eq
        dom = strict.any(axis=0) | np.triu(eq, 1).any(axis=0)
        return np.flatnonzero(~dom)
    if eps == 0.0:
        kf = keys.astype(np.float64)
        ext = np.concatenate([pts, kf[:, None], -kf[:, None]], axis=1)
        return nondominated_rows(ext, 0.0)
    out: list[np.ndarray] = []
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    starts = np.flatnonzero(np.r_[True, skeys[1:] != skeys[:-1]])
    bounds = np.r_[starts, len(skeys)]
    for s, e in zip(bounds[:-1], bounds[1:]):
        idx = order[s:e]       # ascending: stable sort over sorted ranges
        out.append(idx[nondominated_rows(pts[idx], eps)])
    return np.sort(np.concatenate(out))


def grouped_topk(keys: np.ndarray, scores: np.ndarray, k: int) -> np.ndarray:
    """Indices (ascending) of the k smallest-score rows of every group.

    Ties on the score keep the earliest rows (stable), matching the
    (score, insertion-order) tie counter of the scalar bounded-insort
    this replaces.  One ``np.lexsort`` + one segmented rank computation —
    no per-row Python.
    """
    n = len(keys)
    if n == 0:
        return np.arange(0)
    order = np.lexsort((scores, keys))   # group-major, score-minor, stable
    skeys = keys[order]
    new_group = np.r_[True, skeys[1:] != skeys[:-1]]
    # rank of each sorted row within its group: position minus the
    # position of the group's first row
    group_start = np.maximum.accumulate(
        np.where(new_group, np.arange(n), 0))
    rank = np.arange(n) - group_start
    return np.sort(order[rank < k])
