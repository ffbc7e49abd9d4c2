"""SPSolver — the exact DP over a series-parallel decomposition tree.

The chain lattices walk blocks left to right with a single open tensor;
this engine walks the :class:`~repro_torch.core.graph.SPNode` tree instead:

* **series** composition is exactly the chain transition — extend the
  open tail block's label by the next leaf, paying per-edge comm on every
  crossing edge (a join leaf pays one comm term per incoming branch: the
  "cut crossed by k tensors transfers the sum of edge bytes" rule);
* **parallel** composition solves each branch *relative* to the fork
  label (cached per fork resource) and merges the per-branch label sets:
  latencies concatenate (one column per open tail — the max is deferred
  to the join leaf, which is where branch finish times actually meet),
  transfer and per-resource compute times add, hop bottlenecks max.

A label is a vector over monotone-composing components

    (finish time per open tail, hop-period max, transfer bytes,
     per-resource compute time T_r ..., −blocks hosted per floored
     resource ...)

grouped by state ``(open tails with their resources, must-use mask)``.
Within a state every component composes monotonically into any completion
(critical-path latency is max/+ in each tail finish; the pipelined
bottleneck is monotone in each ``T_r`` and the hop max; feasibility of
``max_resource_time`` is monotone in ``T_r``, ``min_blocks_on``
anti-monotone in the block counts — hence the negation), so per-state
dominance pruning is exact: the top-1 solve and the frontier match the
DAG-aware exhaustive oracle label-for-label, constraints included
(``max_resource_time`` prunes in-flight, ``min_blocks_on`` gates
finalisation, ``pin``/``exclude``/``max_link_bytes`` gate transitions,
``must_use`` lives in the mask).

k-best beyond the winner uses widened retention (non-dominated set ∪ the
per-state top-k by an objective proxy).  Unlike the chain
:class:`PartitionLattice`, that is not provably exact for ``top_n > 1``
on DAGs — a scalar score does not order multi-tail prefixes — so ranked
tails beyond the top-1 are best-effort; the query engine's exhaustive
strategy remains the ground truth there.

Carried resources: because parallel branches are *unordered*, a resource
may receive blocks from several branches, so — unlike the chain lattices,
which exploit strict tier ordering to close segments eagerly — each label
carries the full per-resource time vector.  That costs label-set width on
large fleets; chain-shaped models keep using the chain lattices, which
are untouched.
"""

from __future__ import annotations

import itertools

import numpy as np

from .chain import (Constraints, LATENCY, Objective, ThroughputObjective,
                    _LatticeBase, pareto_frontier, rank)
from .dag import DagCostModel, DagPartitionConfig
from .labelset import grouped_nondominated, grouped_topk


class SPSolver(_LatticeBase):
    """Exact partitioning DP over a block DAG's SP decomposition tree."""

    def __init__(self, cost: DagCostModel,
                 constraints: Constraints | None = None,
                 epsilon: float = 0.0, plan=None):
        if epsilon < 0.0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        super().__init__(cost, constraints)
        if plan is not None and plan.names == self.names:
            self._plan = plan
        self.epsilon = float(epsilon)
        self.preds = cost.block_preds
        tree = getattr(cost, "tree", None)
        if tree is None:
            from ..graph import SPNode
            tree = SPNode("series", children=[
                SPNode("leaf", block=i) for i in range(cost.n_blocks)])
        self.tree = tree
        self.ridx = {n: i for i, n in enumerate(self.names)}
        self.floored = [n for n in self.names if n in self.nmin]
        self.fidx = {n: i for i, n in enumerate(self.floored)}
        self.R = len(self.names)
        self.F = len(self.floored)
        self.labels_kept = 0
        self.labels_pruned = 0
        self._retain = 0
        self._proxy = None
        self._leaf_cache: dict = {}
        # completed-DP cache: (finals, label rows, label stats) keyed by
        # the knobs that steer the DP itself (retain width + proxy
        # objective).  The label sets depend only on (cost, constraints,
        # epsilon, retain, proxy), so a warm re-query at the same
        # operating point re-prices cached finals instead of re-running
        # the DP — the engine keeps solvers per (constraints, operating
        # point) to exploit this
        self._finals_cache: dict = {}

    # -- label geometry ----------------------------------------------------
    # a state's array has m = len(tails) leading latency columns, then
    # [bmax, xfer, T_0..T_{R-1}, -cnt_0..-cnt_{F-1}]
    def _width(self, m: int) -> int:
        return m + 2 + self.R + self.F

    def _proxy_for(self, objective: Objective):
        div = np.array([self.cost.replicas_for(n) * self.cost.batch_size
                        for n in self.names])

        def proxy(arr: np.ndarray) -> np.ndarray:
            m = arr.shape[1] - 2 - self.R - self.F
            lat = arr[:, :m].max(axis=1) if m else np.zeros(len(arr))
            if isinstance(objective, ThroughputObjective):
                return np.maximum(arr[:, m],
                                  (arr[:, m + 2:m + 2 + self.R] / div).max(1))
            return (objective.w_latency * lat
                    + objective.w_transfer_per_mb * arr[:, m + 1] / 1e6)

        return proxy

    def _finish(self, chunks: list, keys: list) -> dict:
        """Prune every state's candidate labels in one fused kernel call
        and materialise assignment tuples only for survivors.

        ``chunks`` is ``[(gid_rows, label_rows, build), ...]`` where
        ``gid_rows[i]`` indexes the row's state in ``keys`` and
        ``build(loc)`` produces the assignment tuples for chunk-local row
        indices ``loc``.  All chunks of one node share a label width, so
        the whole node prunes via a single :func:`grouped_nondominated`
        call (state index as the group key) instead of one kernel call per
        state; deferring assignment construction makes the DP's Python
        cost proportional to *kept* labels rather than generated
        candidates — the pruned majority never exists as tuples at all.
        """
        states: dict = {}
        if not chunks:
            return states
        big = chunks[0][1] if len(chunks) == 1 \
            else np.concatenate([c[1] for c in chunks])
        gid = chunks[0][0] if len(chunks) == 1 \
            else np.concatenate([c[0] for c in chunks])
        keep = grouped_nondominated(big, gid, self.epsilon)
        if self._retain > 1 and self._proxy is not None \
                and len(keep) < len(big):
            # widen per state by the proxy top-k; states that kept every
            # row contribute only indices already present
            extra = grouped_topk(gid, self._proxy(big), self._retain)
            keep = np.unique(np.concatenate([keep, extra]))
        self.labels_kept += len(keep)
        self.labels_pruned += len(big) - len(keep)
        # keep is ascending, so one forward walk over the chunks maps it
        # back to chunk-local survivors; rows scatter into their states in
        # global candidate order, preserving first-occurrence semantics
        rows_by: list[list] = [[] for _ in keys]
        asg_by: list[list] = [[] for _ in keys]
        off = 0
        ki = 0
        nkeep = len(keep)
        for cg, carr, build in chunks:
            nc = len(carr)
            lo = ki
            while ki < nkeep and keep[ki] < off + nc:
                ki += 1
            if ki > lo:
                sel = keep[lo:ki]
                for i, a in zip(sel.tolist(), build(sel - off)):
                    g = gid[i]
                    rows_by[g].append(i)
                    asg_by[g].append(a)
            off += nc
        for g, key in enumerate(keys):
            if rows_by[g]:
                states[key] = (big[rows_by[g]], asg_by[g])
        return states

    # -- tree walk ---------------------------------------------------------
    def _run_series(self, node, states: dict) -> dict:
        for child in node.children:
            if not states:
                return states
            if child.kind == "leaf":
                states = self._leaf(child.block, states)
            elif child.kind == "parallel":
                states = self._parallel(child, states)
            else:
                states = self._run_series(child, states)
        return states

    def _leaf(self, b: int, states: dict) -> dict:
        cost, cons = self.cost, self.cons
        P = list(self.preds[b])
        keyid: dict = {}
        keys: list = []
        chunks: list = []
        plan = self._get_plan()
        # per-leaf admissibility, compute times, block-0 input comm and
        # per-pred (R, R) comm/hop/validity tables are state-independent —
        # hoist them out of the state loop and cache them per block
        # (parallel-branch leaves re-run once per fork resource)
        cached = self._leaf_cache.get(b)
        if cached is None:
            rinfo = []
            for r in self.names:
                if not cons.allowed(b, r):
                    continue
                t = cost.segment_time(r, b, b)
                tcap = self.tmax.get(r)
                if tcap is not None and t > tcap:
                    continue
                inp = bneck0 = x0 = 0.0
                if b == 0 and r != cost.source:
                    nb = cost.batch_input_bytes
                    if not cons.transition_allowed(cost.source, r, nb):
                        continue
                    inp = cost.comm(cost.source, r, nb)
                    bneck0 = cost.hop_period(cost.source, r, nb)
                    x0 = nb
                rinfo.append((r, self.ridx[r], t, tcap, inp, bneck0, x0))
            # one packed (R, R, 3) table per pred: [comm, hop, bytes] —
            # comm/hop diagonals are exactly 0.0 (zero-latency infinite-
            # bandwidth self link), bytes is zeroed explicitly, and the
            # validity table absorbs the same-resource case, so the
            # transition needs no same-resource special-casing at all
            pmats = {}
            eye = np.eye(len(plan.names), dtype=bool)
            for u in P:
                nb = float(cost.out_bytes[u])
                commu = plan.latm + nb / plan.bwm
                tbl = np.empty((*commu.shape, 3))
                tbl[:, :, 0] = commu
                tbl[:, :, 1] = commu / cost.batch_size
                tbl[:, :, 2] = np.where(eye, 0.0, nb)
                valid = (plan.ok_pair & (nb <= plan.limitm)) | eye
                pmats[u] = (tbl, valid)
            rnames = [ri[0] for ri in rinfo]
            riv = np.array([ri[1] for ri in rinfo], dtype=np.intp)
            tv = np.array([ri[2] for ri in rinfo])
            tcapv = np.array([np.inf if ri[3] is None else ri[3]
                              for ri in rinfo])
            inpv = np.array([ri[4] for ri in rinfo])
            b0v = np.array([ri[5] for ri in rinfo])
            x0v = np.array([ri[6] for ri in rinfo])
            has_cap = any(ri[3] is not None for ri in rinfo)
            bits = [self._bit(r) for r in rnames]
            fsel = np.array([ai for ai, r in enumerate(rnames)
                             if r in self.fidx], dtype=np.intp)
            fcol = np.array([self.fidx[r] for r in rnames
                             if r in self.fidx], dtype=np.intp)
            cached = self._leaf_cache[b] = (
                rnames, riv, tv, tcapv, inpv, b0v, x0v,
                has_cap, bits, fsel, fcol, pmats)
        (rnames, riv, tv, tcapv, inpv, b0v, x0v,
         has_cap, bits, fsel, fcol, pmats) = cached
        Ra = len(rnames)
        if not Ra:
            return {}
        # every state's open-tail set equals the leaf's pred set, and tail
        # tuples are sorted by node id — so label column j holds pred
        # sorted(P)[j] in *every* state, only its resource varies.  That
        # lets the whole transition run once over the concatenation of all
        # state arrays, with per-pred resource-index row vectors selecting
        # each row's comm/hop/validity from (R, R) lookup tables
        members = list(states.items())
        for (tails, _), _ in members:
            if b > 0 and {u for u, _ in tails} != set(P):
                raise ValueError(
                    f"SP tree out of sync with block edges at block {b}: "
                    f"open tails {sorted(u for u, _ in tails)} vs preds {P}")
        arrs = [a for _, (a, _) in members]
        big = arrs[0] if len(members) == 1 else np.concatenate(arrs)
        counts = [len(a) for a in arrs]
        bounds = np.cumsum([0] + counts)
        n = len(big)
        kP = len(P)
        m = kP
        all_assigns: list = []
        for _, (_, asg) in members:
            all_assigns.extend(asg)
        colofu = {u: j for j, u in enumerate(sorted(P))}
        # one (Ra, n, width) candidate block covers every (state row,
        # target resource) pair at once — the per-resource loop is gone;
        # its C-order ravel (resource-major, row-minor) reproduces the
        # old per-resource chunk order exactly
        if kP:
            ruv = np.empty((kP, n), dtype=np.intp)
            for mi, ((tails, _), _) in enumerate(members):
                for u, ru in tails:
                    ruv[colofu[u], bounds[mi]:bounds[mi + 1]] = self.ridx[ru]
            ok = acc = hop = nbsum = None
            for u in P:
                rj = ruv[colofu[u]][:, None]
                tbl, valid = pmats[u]
                g = tbl[rj, riv[None, :]]            # (n, Ra, 3)
                v = valid[rj, riv[None, :]]
                ok = v if ok is None else ok & v
                term = big[:, colofu[u], None] + g[:, :, 0]
                acc = term if acc is None else np.maximum(acc, term)
                hop = g[:, :, 1] if hop is None \
                    else np.maximum(hop, g[:, :, 1])
                nbsum = g[:, :, 2] if nbsum is None \
                    else nbsum + g[:, :, 2]
            lat0 = acc + tv[None, :]
            if ok.all():
                ok = None
        else:
            ok = None
            lat0 = np.broadcast_to(inpv + tv, (n, Ra))
            hop = np.broadcast_to(b0v, (n, Ra))
            nbsum = np.broadcast_to(x0v, (n, Ra))
        w = self._width(1)
        cand = np.empty((Ra, n, w))
        cand[:, :, 0] = lat0.T
        cand[:, :, 1] = np.maximum(big[None, :, m], hop.T)
        cand[:, :, 2] = big[None, :, m + 1] + nbsum.T
        cand[:, :, 3:] = big[None, :, m + 2:]
        ar = np.arange(Ra)
        cand[ar, :, 3 + riv] += tv[:, None]
        if len(fsel):
            cand[fsel, :, 3 + self.R + fcol] -= 1.0
        admit = ok.T if ok is not None else None
        if has_cap:
            tm = cand[ar, :, 3 + riv] <= tcapv[:, None]
            admit = tm if admit is None else admit & tm
        flat = cand.reshape(Ra * n, w)
        # key ids per (target resource, source state) — integer-only
        mids = np.empty((Ra, len(members)), dtype=np.intp)
        for ai in range(Ra):
            r, bit = rnames[ai], bits[ai]
            for mi, ((tails, mask), _) in enumerate(members):
                key = (((b, r),), mask | bit)
                kid = keyid.get(key)
                if kid is None:
                    kid = keyid[key] = len(keys)
                    keys.append(key)
                mids[ai, mi] = kid
        grow = np.repeat(mids.ravel(), np.tile(counts, Ra))
        if admit is None:
            def build(loc):
                return [all_assigns[i % n] + (rnames[i // n],) for i in loc]

            chunks.append((grow, flat, build))
        else:
            rows = np.flatnonzero(admit.ravel())
            if not len(rows):
                return self._finish(chunks, keys)

            def build(loc, rows=rows):
                out = []
                for i in loc:
                    gi = rows[i]
                    out.append(all_assigns[gi % n] + (rnames[gi // n],))
                return out

            chunks.append((grow[rows], flat[rows], build))
        return self._finish(chunks, keys)

    def _parallel(self, node, states: dict) -> dict:
        cache: dict = {}
        keyid: dict = {}
        keys: list = []
        chunks: list = []
        # prefix states entering with the same fork resource see identical
        # branch sub-solves, so they merge in one fused candidate block
        groups: dict = {}
        for (tails, mask), (arr, assigns) in states.items():
            if len(tails) != 1:
                raise ValueError("parallel node entered with >1 open tail")
            groups.setdefault(tails[0], []).append((mask, arr, assigns))
        for (f, rf), members in groups.items():
            results = []
            for bi, branch in enumerate(node.children):
                ck = (bi, rf)
                if ck not in cache:
                    seed = {(((f, rf),), 0):
                            (np.zeros((1, self._width(1))), [()])}
                    cache[ck] = self._run_series(branch, seed)
                results.append(cache[ck])
            if not all(results):
                continue
            k = len(results)
            # flatten each branch's state dict: one label array, one
            # state-id row vector, one concatenated assignment list
            barr, bgid, bmasks, btails, basg = [], [], [], [], []
            for br in results:
                items = list(br.items())
                arrs_b = [a for _, (a, _) in items]
                barr.append(arrs_b[0] if len(items) == 1
                            else np.concatenate(arrs_b))
                bgid.append(np.repeat(np.arange(len(items)),
                                      [len(a) for a in arrs_b]))
                bmasks.append([bm for (_, bm), _ in items])
                btails.append([bts[0] for (bts, _), _ in items])
                flat_asg: list = []
                for _, (_, asg) in items:
                    flat_asg.extend(asg)
                basg.append(flat_asg)
            src_arrs = [a for _, a, _ in members]
            src = src_arrs[0] if len(members) == 1 \
                else np.concatenate(src_arrs)
            sgid = np.repeat(np.arange(len(members)),
                             [len(a) for a in src_arrs])
            src_asg: list = []
            for _, _, asg in members:
                src_asg.extend(asg)
            Ls = len(src)
            # one meshgrid over (branch rows ..., prefix rows) covers every
            # branch-state combo and every prefix state of the group at once
            grids = np.indices(
                (*[len(ba) for ba in barr], Ls)).reshape(k + 1, -1)
            I0 = grids[k]
            # branch exit blocks (and the kept fork tensor on a direct
            # fork→join edge) fix the tail column order for every combo
            us = [btails[j][0][0] for j in range(k)]
            if node.direct:
                us.append(f)
            order = np.argsort(us, kind="stable")
            mlen = len(us)
            # per-combo state keys, built once per (branch states...,
            # member) tuple in integer space and gathered per row
            S = [len(bm) for bm in bmasks]
            M = len(members)
            lut = np.empty(int(np.prod(S)) * M, dtype=np.intp)
            for ci, combo in enumerate(
                    itertools.product(*[range(s) for s in S])):
                tail_list = [btails[j][combo[j]] for j in range(k)]
                if node.direct:
                    tail_list.append((f, rf))
                new_tails = tuple(tail_list[i] for i in order)
                cmask = 0
                for j in range(k):
                    cmask |= bmasks[j][combo[j]]
                for mi, (mask, _, _) in enumerate(members):
                    key = (new_tails, mask | cmask)
                    kid = keyid.get(key)
                    if kid is None:
                        kid = keyid[key] = len(keys)
                        keys.append(key)
                    lut[ci * M + mi] = kid
            cidx = bgid[0][grids[0]]
            for j in range(1, k):
                cidx = cidx * S[j] + bgid[j][grids[j]]
            grow = lut[cidx * M + sgid[I0]]
            new = np.empty((grids.shape[1], self._width(mlen)))
            lat_cols = [src[I0, 0] + barr[j][grids[j], 0]
                        for j in range(k)]
            if node.direct:
                lat_cols.append(src[I0, 0])
            for dst, srcidx in enumerate(order):
                new[:, dst] = lat_cols[srcidx]
            bm_rel = barr[0][grids[0], 1]
            for j in range(1, k):
                bm_rel = np.maximum(bm_rel, barr[j][grids[j], 1])
            new[:, mlen] = np.maximum(src[I0, 1], bm_rel)
            xfer = barr[0][grids[0], 2]
            for j in range(1, k):
                xfer = xfer + barr[j][grids[j], 2]
            new[:, mlen + 1] = src[I0, 2] + xfer
            tail_block = new[:, mlen + 2:]
            tail_block[:] = src[I0, 3:]
            for j in range(k):
                tail_block += barr[j][grids[j], 3:]
            rows = np.arange(grids.shape[1])
            for rn, cap in self.tmax.items():
                c = mlen + 2 + self.ridx[rn]
                rows = rows[new[rows, c] <= cap]
                if not len(rows):
                    break
            if not len(rows):
                continue
            sub = grids[:, rows]

            def build(loc, sub=sub, src_asg=src_asg, basg=basg, k=k):
                res = []
                for i in loc:
                    a = src_asg[sub[k][i]]
                    for j in range(k):
                        a = a + basg[j][sub[j][i]]
                    res.append(a)
                return res

            chunks.append((grow[rows], new[rows], build))
        return self._finish(chunks, keys)

    # -- entry points ------------------------------------------------------
    def _finals(self) -> tuple[list, np.ndarray]:
        """Feasible complete assignments plus their final label rows.

        The labels let the entry points rank/filter candidates *before*
        pricing them — ``evaluate_assignment`` is the dominant cost of a
        solve once the DP itself is vectorised."""
        self.labels_kept = self.labels_pruned = 0
        if self.infeasible:
            return [], np.empty((0, self._width(1)))
        seed = {((), 0): (np.zeros((1, self._width(0))), [()])}
        states = self._run_series(self.tree, seed)
        finals: list[tuple] = []
        rows: list[np.ndarray] = []
        seen: set = set()
        for (tails, mask), (arr, assigns) in states.items():
            if mask != self.full_mask:
                continue
            ok = np.ones(len(arr), dtype=bool)
            for rn, floor in self.nmin.items():
                c = len(tails) + 2 + self.R + self.fidx[rn]
                ok &= arr[:, c] <= -float(floor)
            for i in np.nonzero(ok)[0]:
                a = assigns[i]
                if a not in seen:
                    seen.add(a)
                    finals.append(a)
                    rows.append(arr[i])
        if not rows:
            return finals, np.empty((0, self._width(1)))
        return finals, np.stack(rows)

    def _finals_for(self, key: tuple) -> tuple[list, np.ndarray]:
        """Memoised :meth:`_finals` — ``key`` must capture every knob that
        steers the DP (retain width, proxy objective); callers set
        ``_retain``/``_proxy`` before calling."""
        hit = self._finals_cache.get(key)
        if hit is not None:
            finals, rows, kept, pruned = hit
            self.labels_kept, self.labels_pruned = kept, pruned
            return finals, rows
        finals, rows = self._finals()
        self._finals_cache[key] = (finals, rows,
                                   self.labels_kept, self.labels_pruned)
        return finals, rows

    # relative safety band for label-based pre-ranking: label columns are
    # built from the same comm/compute floats as evaluate_assignment but
    # parallel merges may sum per-resource times in a different order, so
    # scores can differ in the last ulps.  Any candidate within the band
    # of the provisional cutoff is still priced exactly.
    _SCORE_BAND = 1e-9

    def solve(self, objective: Objective = LATENCY,
              top_n: int = 1) -> list[DagPartitionConfig]:
        """Ranked feasible configs; the winner is exact (see module doc)."""
        self._retain = max(1, int(top_n))
        self._proxy = self._proxy_for(objective)
        finals, rows = self._finals_for(
            ("solve", self._retain, type(objective).__name__,
             getattr(objective, "w_latency", None),
             getattr(objective, "w_transfer_per_mb", None)))
        if len(finals) > 2 * self._retain \
                and type(objective) in (Objective, ThroughputObjective):
            scores = self._proxy(rows)
            order = np.argsort(scores, kind="stable")
            kth = scores[order[min(self._retain, len(order)) - 1]]
            cut = kth + abs(kth) * self._SCORE_BAND + 1e-300
            sel = np.sort(order[scores[order] <= cut])
            configs = [self.cost.evaluate_assignment(finals[i])
                       for i in sel]
        else:
            configs = [self.cost.evaluate_assignment(a) for a in finals]
        return rank(configs, objective, top_n)

    def frontier(self) -> list[DagPartitionConfig]:
        """The exact (ε = 0) non-dominated set over (latency, bottleneck,
        transfer); ε > 0 applies the same ε-dominance as ParetoLattice."""
        self._retain = 0
        self._proxy = None
        finals, rows = self._finals_for(("front",))
        if len(finals) > 8:
            # drop finals some other final beats by more than the band in
            # every objective — they cannot be frontier members; ties and
            # near-ties all survive to exact pricing
            m = rows.shape[1] - 2 - self.R - self.F
            div = np.array([self.cost.replicas_for(n) * self.cost.batch_size
                            for n in self.names])
            pts = np.stack([
                rows[:, :m].max(axis=1),
                np.maximum(rows[:, m],
                           (rows[:, m + 2:m + 2 + self.R] / div).max(1)),
                rows[:, m + 1]], axis=1)
            shr = pts - (np.abs(pts) * self._SCORE_BAND + 1e-300)
            dominated = (pts[:, None, :] <= shr[None, :, :]).all(2).any(0)
            finals = [a for a, d in zip(finals, dominated) if not d]
        configs = [self.cost.evaluate_assignment(a) for a in finals]
        return pareto_frontier(configs)
