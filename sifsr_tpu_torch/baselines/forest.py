"""Bagged regression trees with leaf ridges, fitted and applied in torch.

The Data-Mining Sharpener's regressor (``baselines/dms.py``). The JAX
package builds it from scikit-learn (a ``BaggingRegressor`` of decision trees
whose leaves carry a ``Ridge``, ``sifsr_tpu/baselines/dms.py:40-68``,
``:143-150``); the port fits the same ensemble itself, on any torch device,
and imports no scikit-learn. What scikit-learn 1.9 does, and this module
reproduces:

- **Bootstrap.** ``seeds = RandomState(random_state).randint(2**31 - 1,
  n_estimators)``; tree ``i`` draws ``RandomState(seeds[i]).choice(n, n,
  p=w / w.sum())`` and is fitted on every row with the draw counts as its
  sample weights (``sklearn/ensemble/_bagging.py:63-94, 160-171``). Rows
  drawn no time take no part in the splits.
- **Splits** (``sklearn/tree/_splitter.pyx`` ``node_split_best``, MSE
  criterion). Features in float32; a candidate lies between sorted values
  ``x[p-1]`` and ``x[p]`` with ``x[p] > float32(x[p-1] + 1e-7)``, with at least
  ``min_samples_leaf`` rows (rows, not weights) on each side; the split
  maximises ``S_L²/W_L + S_R²/W_R`` over the weighted sums of the target;
  the first candidate in sorted order wins an exact tie, and with several
  features the lowest feature index does (scikit-learn visits features in a
  random order, and the first visited wins its ties). The threshold is
  ``x[p-1]/2 + x[p]/2`` in float64.
- **Stopping** (``_tree.pyx``): a node with fewer than ``max(2,
  2·min_samples_leaf)`` rows, an impurity at most float64 eps, no valid
  split, or an improvement below -eps is a leaf, and its value is the
  weighted mean of its targets. Without ``max_leaf_nodes`` the trees grow
  until every node stops; with it, best-first growth splits the frontier
  node of largest weighted impurity improvement until ``max_leaf_nodes``
  leaves are reached. Each node's split depends on its own rows alone, so
  the best-first tree is the subtree that greedy order takes from the full
  one, which is how it is built here.
- **Leaf ridges** (``dms.py:49-68``): the training rows, all of them, are
  grouped by the *value* of the leaf they land in (leaves with equal values
  share a group); each group fits ``Ridge(alpha=1)`` with an intercept on the
  float64 features, and keeps the group's target range. A prediction in the
  group is refined by its ridge and clipped to the range widened by
  ``extrapolation_ratio`` of its width on each side. The groups are taken in
  ascending value order and refine in place, so a refined value equal to a
  later group's value is refined again by that group; that is reproduced.
- **Bagging**: the trees' predictions summed in order, over
  ``n_estimators``.

The trees of a forest grow together, one level a step: the rows of every
open node of every tree are sorted by (node, feature rank) so that each
node is a contiguous segment, and the segment sums come from
``ops.segments.segment_scan``: elementwise float64 additions in a fixed
order, so the card and the CPU build the same trees. Exact ties in exact
arithmetic (duplicate targets) are decided by rounding here as in
scikit-learn, whose incremental sums round otherwise: there the two can
build different trees.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.ops.segments import segment_scan

__all__ = ["bootstrap_counts", "BaggedTrees"]

FEATURE_THRESHOLD = 1e-7          # float32, sklearn/tree/_partitioner.pxd:13
EPSILON = float(np.finfo(np.float64).eps)  # sklearn/tree/_tree.pyx:42
MAX_INT = int(np.iinfo(np.int32).max)      # sklearn/ensemble/_bagging.py:47


def bootstrap_counts(w: np.ndarray, n_estimators: int, random_state) -> np.ndarray:
    """(n_estimators, n) int64 draw counts of the weighted bootstrap, the
    sample weights each tree is fitted with."""
    w = np.asarray(w, np.float64)
    n = w.shape[0]
    # a seed as sklearn.utils.check_random_state takes it; None draws fresh
    # entropy (scikit-learn takes numpy's global generator): not repeatable
    rs = (random_state if isinstance(random_state, np.random.RandomState)
          else np.random.RandomState(random_state))
    seeds = rs.randint(MAX_INT, size=n_estimators)
    p = w / np.sum(w)
    return np.stack([np.bincount(np.random.RandomState(s).choice(n, n, replace=True, p=p),
                                 minlength=n) for s in seeds]).astype(np.int64)


def _segments(keys: torch.Tensor):
    """Segments of sorted ``keys``: (segment index of each position, start of
    each position's segment, starts, counts, the longest count)."""
    r = keys.shape[0]
    is_start = torch.ones(r, dtype=torch.bool, device=keys.device)
    is_start[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(is_start).flatten()
    seg = torch.cumsum(is_start, 0) - 1
    counts = torch.diff(starts, append=torch.tensor([r], device=keys.device))
    return seg, starts[seg], starts, counts, int(counts.max())


@dataclasses.dataclass
class _Trees:
    """The nodes of a forest, indexed by node id (tree ``t``'s root is node
    ``t``). A leaf's feature is 0 and its children are itself."""
    tree: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    miss_left: torch.Tensor
    value: torch.Tensor
    leaf: torch.Tensor
    depth: int

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """(T, m) leaf ids of the (m, B) float64 queries, walked as
        scikit-learn walks them: features cast to float32, ``x <= threshold``
        goes left, NaN to the side that held more training rows."""
        xq = x.to(torch.float32).to(torch.float64)
        n_trees, m = int(self.tree.max()) + 1, x.shape[0]
        node = torch.arange(n_trees, device=x.device)[:, None].expand(n_trees, m).contiguous()
        cols = torch.arange(m, device=x.device)[None, :]
        for _ in range(self.depth):
            xv = xq[cols, self.feature[node]]
            go_left = (xv <= self.threshold[node]) | (torch.isnan(xv) & self.miss_left[node])
            node = torch.where(go_left, self.left[node], self.right[node])
        return node


def _grow(xf: torch.Tensor, y: torch.Tensor, counts: torch.Tensor, min_samples_leaf: int,
          max_leaf_nodes: int | None) -> _Trees:
    """Fit one tree per row of ``counts`` (T, n), the rows' sample weights, on
    float32 features ``xf`` (n, B) and float64 targets ``y`` (n,)."""
    dev = xf.device
    n, n_feat = xf.shape
    n_trees = counts.shape[0]
    msl = int(min_samples_leaf)
    min_split = max(2, 2 * msl)
    xf = xf + 0.0  # -0.0 -> +0.0: one order of the keys on every device
    ranks, n_ranks = [], []
    for f in range(n_feat):
        uniq, inv = torch.unique(xf[:, f], sorted=True, return_inverse=True)
        ranks.append(inv)
        n_ranks.append(uniq.shape[0])
    thr32 = torch.tensor(FEATURE_THRESHOLD, dtype=torch.float32, device=dev)
    w_all = counts.to(torch.float64)
    w_tree = w_all.sum(dim=1)  # integer-valued: exact in any order
    # the proxy and impurities on targets shifted by one of them: the argmax
    # does not move, and the sums keep more digits
    shift = torch.sort(y).values[n // 2]
    yc = y - shift

    rows_tree, rows_sample = torch.nonzero(counts > 0, as_tuple=True)
    rows_w = w_all[rows_tree, rows_sample]
    node = rows_tree.clone()
    level_start, next_id = 0, n_trees
    levels = []
    while rows_sample.numel():
        n_open = next_id - level_start
        tree_ids = (torch.arange(n_trees, device=dev) if not levels
                    else levels[-1]["child_tree"])
        best_gain = torch.full((n_open,), -torch.inf, dtype=torch.float64, device=dev)
        best = None
        for f in range(n_feat):
            order = torch.argsort(node * n_ranks[f] + ranks[f][rows_sample], stable=True)
            s = rows_sample[order]
            w = rows_w[order]
            yv = yc[s]
            wy = w * yv
            stats = torch.stack([w, wy, wy * yv, w * y[s]])
            seg, seg_start, starts, cnt, longest = _segments(node[order])
            scan = segment_scan(stats, seg_start, longest)
            tot = scan[:, starts + cnt - 1]
            if f == 0:
                w_n, s_n, q_n, raw_n = tot
                mean_n = s_n / w_n
                impurity = q_n / w_n - mean_n * mean_n
                value = raw_n / w_n
                n_rows = cnt
            # candidate p: rows [start, p) left, [p, end) right
            left = torch.nn.functional.pad(scan[:, :-1], (1, 0))
            w_l, s_l = left[0], left[1]
            w_r, s_r = tot[0][seg] - w_l, tot[1][seg] - s_l
            gain = s_l * s_l / w_l + s_r * s_r / w_r
            x = xf[s, f]
            x_prev = torch.nn.functional.pad(x[:-1], (1, 0))
            r = torch.arange(s.shape[0], device=dev) - seg_start
            valid = ((r >= msl) & (cnt[seg] - r >= msl) & (r >= 1)
                     & (x > x_prev + thr32))
            gain = torch.where(valid, gain, torch.full_like(gain, -torch.inf))
            seg_best = torch.full((n_open,), -torch.inf, dtype=torch.float64, device=dev)
            seg_best = seg_best.scatter_reduce(0, seg, gain, "amax")
            pos = torch.arange(s.shape[0], device=dev)
            first = torch.where(valid & (gain == seg_best[seg]), pos,
                                torch.full_like(pos, s.shape[0]))
            p_best = torch.full((n_open,), s.shape[0], dtype=torch.long, device=dev)
            p_best = p_best.scatter_reduce(0, seg, first, "amin")
            better = seg_best > best_gain
            if not better.any():
                continue
            best_gain = torch.where(better, seg_best, best_gain)
            p = p_best.clamp(max=s.shape[0] - 1)
            thr = (x_prev[p].to(torch.float64) / 2.0 + x[p].to(torch.float64) / 2.0)
            lw, ls, lq = scan[0][p - 1], scan[1][p - 1], scan[2][p - 1]
            rw, rs, rq = tot[0] - lw, tot[1] - ls, tot[2] - lq
            ml, mr = ls / lw, rs / rw
            imp_l, imp_r = lq / lw - ml * ml, rq / rw - mr * mr
            n_left = p - starts
            cand = (torch.full_like(p, f), thr, imp_l, imp_r, lw, rw, n_left > cnt - n_left)
            best = cand if best is None else tuple(
                torch.where(better, c, b) for c, b in zip(cand, best))
        stop = (n_rows < min_split) | (impurity <= EPSILON) | ~torch.isfinite(best_gain)
        if best is None:
            feat = torch.zeros(n_open, dtype=torch.long, device=dev)
            thr = torch.zeros(n_open, dtype=torch.float64, device=dev)
            improvement = torch.zeros(n_open, dtype=torch.float64, device=dev)
            miss_left = torch.zeros(n_open, dtype=torch.bool, device=dev)
        else:
            feat, thr, imp_l, imp_r, lw, rw, miss_left = best
            improvement = (w_n / w_tree[tree_ids]) * (impurity - rw / w_n * imp_r
                                                     - lw / w_n * imp_l)
            stop |= improvement + EPSILON < 0
        ids = torch.arange(level_start, next_id, device=dev)
        split = ~stop
        k = torch.cumsum(split, 0) - 1
        left_id = torch.where(split, next_id + 2 * k, ids)
        right_id = torch.where(split, next_id + 2 * k + 1, ids)
        levels.append({
            "tree": tree_ids, "feature": torch.where(split, feat, torch.zeros_like(feat)),
            "threshold": torch.where(split, thr, torch.zeros_like(thr)), "left": left_id,
            "right": right_id, "miss_left": miss_left & split, "value": value,
            "leaf": stop, "improvement": torch.where(split, improvement,
                                                     torch.zeros_like(improvement)),
            "child_tree": torch.repeat_interleave(tree_ids[split], 2)})
        # route the rows of the split nodes to their children
        local = node - level_start
        keep = split[local]
        node, rows_sample, rows_w, local = node[keep], rows_sample[keep], rows_w[keep], local[keep]
        xv = xf[rows_sample, feat[local]].to(torch.float64)
        node = torch.where(xv <= thr[local], left_id[local], right_id[local])
        level_start, next_id = next_id, next_id + 2 * int(split.sum())
    cat = {k: torch.cat([lv[k] for lv in levels]) for k in levels[0] if k != "child_tree"}
    trees = _Trees(tree=cat["tree"], feature=cat["feature"], threshold=cat["threshold"],
                   left=cat["left"], right=cat["right"], miss_left=cat["miss_left"],
                   value=cat["value"], leaf=cat["leaf"], depth=len(levels) - 1)
    if max_leaf_nodes is not None:
        trees = _best_first(trees, cat["improvement"], max_leaf_nodes)
    return trees


def _best_first(trees: _Trees, improvement: torch.Tensor, max_leaf_nodes: int) -> _Trees:
    """The subtree of each fully grown tree that scikit-learn's best-first
    growth keeps: pop the frontier node of largest improvement, split it
    while fewer than ``max_leaf_nodes - 1`` splits were made."""
    left, right = trees.left.cpu().numpy(), trees.right.cpu().numpy()
    leaf = trees.leaf.cpu().numpy().copy()
    gain = improvement.cpu().numpy()
    n_trees = int(trees.tree.max()) + 1
    keep_leaf = np.ones_like(leaf)
    depth = 0
    for t in range(n_trees):
        budget = max_leaf_nodes - 1
        frontier = [(-gain[t], 0, t, 0)]
        count = 1
        while frontier:
            _, _, nid, d = heapq.heappop(frontier)
            depth = max(depth, d)
            if leaf[nid] or budget <= 0:
                continue
            budget -= 1
            keep_leaf[nid] = False
            for child in (left[nid], right[nid]):
                heapq.heappush(frontier, (-gain[child], count, child, d + 1))
                count += 1
    keep = torch.as_tensor(keep_leaf, device=trees.leaf.device)
    ids = torch.arange(keep.shape[0], device=keep.device)
    return dataclasses.replace(
        trees, leaf=keep, left=torch.where(keep, ids, trees.left),
        right=torch.where(keep, ids, trees.right),
        feature=torch.where(keep, torch.zeros_like(trees.feature), trees.feature),
        depth=depth)


class BaggedTrees:
    """``BaggingRegressor(n_estimators)`` of regression trees, each with a
    ridge a leaf value when ``leaf_ridge`` (``LeafLinearTreeRegressor``),
    fitted and applied on ``device`` (the card unless the caller asks for
    the CPU).

    ``min_samples_leaf`` and ``max_leaf_nodes`` are the trees' options
    (``None``: grown until every node stops)."""

    def __init__(self, n_estimators: int = 10, leaf_ridge: bool = True,
                 extrapolation_ratio: float = 0.25, min_samples_leaf: int = 1,
                 max_leaf_nodes: int | None = None, random_state=None,
                 device: str | torch.device = "cuda"):
        self.n_estimators = n_estimators
        self.leaf_ridge = leaf_ridge
        self.extrapolation_ratio = extrapolation_ratio
        self.min_samples_leaf = min_samples_leaf
        self.max_leaf_nodes = max_leaf_nodes
        self.random_state = random_state
        self.device = resolve_device(device)

    def fit(self, x: np.ndarray, y: np.ndarray, sample_weight: np.ndarray) -> "BaggedTrees":
        x = np.asarray(x, np.float64).reshape(len(y), -1)
        counts = bootstrap_counts(sample_weight, self.n_estimators, self.random_state)
        dev = self.device
        xd = torch.as_tensor(x, device=dev)
        yd = torch.as_tensor(np.asarray(y, np.float64), device=dev)
        self.trees_ = _grow(
            xd.to(torch.float32), yd, torch.as_tensor(counts, device=dev),
            self.min_samples_leaf, self.max_leaf_nodes)
        self.counts_ = counts
        if self.leaf_ridge:
            self._fit_ridges(xd, yd)
        return self

    def _fit_ridges(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """One ``Ridge(alpha=1)`` a leaf value of each tree, on every training
        row, in float64: coef = (XcᵀXc + I)⁻¹ Xcᵀyc on the group's centred rows."""
        n_trees, n = self.n_estimators, x.shape[0]
        dev = x.device
        vals = self.trees_.value[self.trees_.apply(x)]  # (T, n)
        vs, order = torch.sort(vals, dim=1, stable=True)
        tree = torch.arange(n_trees, device=dev)[:, None].expand(n_trees, n).reshape(-1)
        vs, order = vs.reshape(-1), order.reshape(-1)
        new = torch.ones_like(vs, dtype=torch.bool)
        new[1:] = (vs[1:] != vs[:-1]) | (tree[1:] != tree[:-1])
        seg = torch.cumsum(new, 0) - 1
        starts = torch.nonzero(new).flatten()
        cnt = torch.diff(starts, append=torch.tensor([vs.shape[0]], device=dev))
        seg_start, ends, longest = starts[seg], starts + cnt - 1, int(cnt.max())
        xs, ys = x[order], y[order]  # (R, B), (R,)
        n_feat = xs.shape[1]
        sums = segment_scan(torch.cat([xs.T, ys[None]]), seg_start, longest)[:, ends]
        nf = cnt.to(torch.float64)
        mean = sums / nf  # (B + 1, G)
        xc = xs.T - mean[:n_feat][:, seg]
        yc = ys - mean[n_feat][seg]
        prods = torch.cat([(xc[:, None] * xc[None]).reshape(n_feat * n_feat, -1), xc * yc])
        c = segment_scan(prods, seg_start, longest)[:, ends]
        gram = c[:n_feat * n_feat].T.reshape(-1, n_feat, n_feat)
        xty = c[n_feat * n_feat:].T
        if n_feat == 1:
            coef = xty / (gram[:, :, 0] + 1.0)
        else:
            eye = torch.eye(n_feat, dtype=torch.float64, device=dev)
            coef = torch.linalg.solve(gram + eye, xty)
        intercept = mean[n_feat] - (mean[:n_feat].T * coef).sum(dim=1)
        lo = torch.full_like(nf, torch.inf).scatter_reduce(0, seg, ys, "amin")
        hi = torch.full_like(nf, -torch.inf).scatter_reduce(0, seg, ys, "amax")
        slack = self.extrapolation_ratio * (hi - lo)
        # groups per tree, padded with +inf for searchsorted
        tree_of = tree[starts]
        per_tree = torch.bincount(tree_of, minlength=n_trees)
        width = int(per_tree.max())
        first = torch.cumsum(per_tree, 0) - per_tree
        col = torch.arange(starts.shape[0], device=dev) - first[tree_of]
        table = torch.full((n_trees, width), torch.inf, dtype=torch.float64, device=dev)
        table[tree_of, col] = vs[starts]
        self.groups_ = (table, first, coef, intercept, lo - slack, hi + slack)

    def n_leaves(self) -> list[int]:
        """Leaves of each tree (``DecisionTreeRegressor.get_n_leaves``)."""
        t = self.trees_
        reach = self._reachable()
        return torch.bincount(t.tree[t.leaf & reach], minlength=self.n_estimators).tolist()

    def thresholds(self, i: int) -> np.ndarray:
        """Sorted split thresholds of tree ``i``."""
        t = self.trees_
        sel = (t.tree == i) & ~t.leaf & self._reachable()
        return np.sort(t.threshold[sel].cpu().numpy())

    def _reachable(self) -> torch.Tensor:
        t = self.trees_
        reach = torch.zeros_like(t.leaf)
        reach[: self.n_estimators] = True
        for _ in range(t.depth):
            inner = reach & ~t.leaf
            reach[t.left[inner]] = True
            reach[t.right[inner]] = True
        return reach

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Mean of the trees' predictions for (m, B) (or (m,)) features,
        float64 on the host. A non-finite feature raises ``ValueError`` as
        scikit-learn's ``Ridge`` does (NaN is walked, and so allowed, only
        without leaf ridges)."""
        x = np.asarray(x, np.float64)
        x = x.reshape(x.shape[0], -1)
        if not np.isfinite(x).all() and (self.leaf_ridge or np.isinf(x).any()):
            raise ValueError("Input X contains NaN or infinity.")
        xd = torch.as_tensor(x, device=self.device)
        leaf = self.trees_.apply(xd)
        pred = self.trees_.value[leaf]  # (T, m)
        if self.leaf_ridge:
            pred = self._refine(xd, pred)
        acc = pred[0]
        for t in range(1, self.n_estimators):
            acc = acc + pred[t]
        return (acc / self.n_estimators).cpu().numpy()

    def _refine(self, x: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """Each prediction through its value group's ridge and clip, again
        through a later group's whose value it then equals exactly."""
        table, first, coef, intercept, lo, hi = self.groups_
        # a tree's groups: table[t, :count[t]], coef[first[t]:first[t] + count[t]]
        last = (torch.isfinite(table).sum(dim=1) - 1)[:, None]
        col = torch.searchsorted(table, pred)
        done = torch.full_like(col, -1)
        while True:
            own = torch.minimum(col, last)
            hit = (col > done) & (table.gather(1, own) == pred)
            if not hit.any():
                return pred
            g = first[:, None] + own
            refined = (x[None] * coef[g]).sum(dim=-1) + intercept[g]
            refined = torch.minimum(torch.maximum(refined, lo[g]), hi[g])
            pred = torch.where(hit, refined, pred)
            done = torch.where(hit, col, done)
            col = torch.where(hit, torch.searchsorted(table, pred), col)
