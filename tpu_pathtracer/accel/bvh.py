"""Top-down sweep-SAH BVH builder with breadth-first flattening.

Produces exactly the tree the reference builder produces
(reference: src/passes/raytrace.ts:540-694):

  * one leaf per triangle (buildBVH, raytrace.ts:540-560),
  * 2-element fast path: children in incoming order (raytrace.ts:587-589),
  * split axis = longest axis with the reference's exact tie-breaking
    expression `x > y ? (x > z ? x : z) : y` (raytrace.ts:592),
  * stable sort of children by AABB-centroid on that axis (raytrace.ts:595-600),
  * full-sweep surface-area-heuristic cost
    `leftArea * nLeft + rightArea * nRight`, first minimum wins
    (raytrace.ts:626-655),
  * flatten: BFS order, root at index 0, leaves store the triangle index,
    internal nodes store child indices (raytrace.ts:667-694).

Unlike the reference (which recomputes each side's bbox per candidate split —
O(n^2) per level — and flattens with an O(n^2) indexOf), this builder uses
prefix/suffix min-max scans, so it is O(n log n) overall while making the
identical split decisions.  A C++ native builder with the same contract lives
in csrc/ (see accel/native.py); this numpy version is the portable fallback
and the semantic oracle.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np


def _surface_area(size: np.ndarray) -> np.ndarray:
    """2*(xy+xz+yz); `size` is (..., 3)."""
    x, y, z = size[..., 0], size[..., 1], size[..., 2]
    return 2.0 * (x * y + x * z + y * z)


def build_bvh_flat(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                   native: bool = True) -> Dict[str, np.ndarray]:
    """Build and flatten the BVH for a triangle soup.

    Returns dict of arrays: min/max (K,3) f32, left/right/tri/is_leaf (K,) i32.
    K = 2*N-1 for N triangles (K=0 for an empty scene, matching the
    empty-buffer early-out in raytrace.wgsl:205-211).

    Dispatches to the C++ builder (csrc/bvh_builder.cpp) when available —
    bit-identical output, ~40x faster on large meshes; `native=False` forces
    this numpy implementation (the oracle).
    """
    if native:
        from . import native as _native

        out = _native.build_bvh_flat_native(p0, p1, p2)
        if out is not None:
            return out
    n = int(p0.shape[0])
    if n == 0:
        return {
            "min": np.zeros((0, 3), np.float32),
            "max": np.zeros((0, 3), np.float32),
            "left": np.zeros((0,), np.int32),
            "right": np.zeros((0,), np.int32),
            "tri": np.zeros((0,), np.int32),
            "is_leaf": np.zeros((0,), np.int32),
        }

    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) / 2.0

    # Node records, build order (DFS); renumbered to BFS below.
    rec_min: list = []
    rec_max: list = []
    rec_left: list = []
    rec_right: list = []
    rec_tri: list = []
    rec_leaf: list = []

    def alloc(bmin, bmax, leaf, tri):
        rec_min.append(bmin)
        rec_max.append(bmax)
        rec_left.append(-1)
        rec_right.append(-1)
        rec_tri.append(tri)
        rec_leaf.append(leaf)
        return len(rec_min) - 1

    # Work stack of (ordered triangle-index array, parent node id, side).
    stack: list = [(np.arange(n, dtype=np.int64), -1, 0)]
    root_id = -1
    while stack:
        idxs, parent, side = stack.pop()
        count = idxs.shape[0]
        bmins = tri_min[idxs]
        bmaxs = tri_max[idxs]
        bmin = bmins.min(axis=0)
        bmax = bmaxs.max(axis=0)

        if count == 1:
            nid = alloc(bmin, bmax, 1, int(idxs[0]))
        else:
            nid = alloc(bmin, bmax, 0, -1)
            if count == 2:
                left_idxs, right_idxs = idxs[:1], idxs[1:]
            else:
                size = bmax - bmin
                # Reference tie-breaking: x>y ? (x>z ? x : z) : y
                if size[0] > size[1]:
                    axis = 0 if size[0] > size[2] else 2
                else:
                    axis = 1
                order = np.argsort(centroid[idxs, axis], kind="stable")
                idxs = idxs[order]
                bmins = bmins[order]
                bmaxs = bmaxs[order]

                # Prefix (left side) and suffix (right side) bbox scans.
                lmin = np.minimum.accumulate(bmins, axis=0)
                lmax = np.maximum.accumulate(bmaxs, axis=0)
                rmin = np.minimum.accumulate(bmins[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(bmaxs[::-1], axis=0)[::-1]

                counts = np.arange(1, count, dtype=np.float64)
                left_area = _surface_area(lmax[:-1] - lmin[:-1])
                right_area = _surface_area(rmax[1:] - rmin[1:])
                cost = left_area * counts + right_area * (count - counts)
                split = int(np.argmin(cost)) + 1  # first minimum, like `<` in ref
                left_idxs, right_idxs = idxs[:split], idxs[split:]

            # Push right first so left is processed first (cosmetic; BFS
            # renumbering fixes the final order regardless).
            stack.append((right_idxs, nid, 1))
            stack.append((left_idxs, nid, 0))

        if parent < 0:
            root_id = nid
        elif side == 0:
            rec_left[parent] = nid
        else:
            rec_right[parent] = nid

    k = len(rec_min)
    left = np.asarray(rec_left, np.int64)
    right = np.asarray(rec_right, np.int64)

    # BFS renumber so the flat layout matches the reference flattener.
    order = np.empty(k, np.int64)
    new_id = np.empty(k, np.int64)
    q = deque([root_id])
    pos = 0
    while q:
        nid = q.popleft()
        order[pos] = nid
        new_id[nid] = pos
        pos += 1
        if rec_leaf[nid] == 0:
            q.append(left[nid])
            q.append(right[nid])

    leaf = np.asarray(rec_leaf, np.int32)[order]
    out_left = np.where(leaf == 1, -1, new_id[np.maximum(left[order], 0)]).astype(np.int32)
    out_right = np.where(leaf == 1, -1, new_id[np.maximum(right[order], 0)]).astype(np.int32)

    return {
        "min": np.asarray(rec_min, np.float32)[order],
        "max": np.asarray(rec_max, np.float32)[order],
        "left": out_left,
        "right": out_right,
        "tri": np.asarray(rec_tri, np.int32)[order],
        "is_leaf": leaf,
    }


def flat_to_links(flat: Dict[str, np.ndarray], end: int | None = None,
                  native: bool = True) -> Dict[str, np.ndarray]:
    """Re-lay the flat BFS BVH in DFS preorder with skip links.

    This is the device traversal layout: a ray walks nodes with a single
    pointer — on AABB hit at an internal node it advances to `i + 1` (the
    first child, contiguous in preorder), otherwise it jumps to `miss[i]`
    (the next node in preorder that is not in i's subtree).  Leaves test
    their triangle and then always take `miss[i]`.  `end` (default K) is the
    termination sentinel.  Same nearest-hit result as the reference's
    stack traversal (raytrace.wgsl:154-203) without per-ray stack state —
    and no 64-deep overflow failure mode.

    Returns {"min","max","tri","miss"} with tri = -1 for internal nodes.
    """
    if native:
        from . import native as _native

        out = _native.flat_to_links_native(flat, end)
        if out is not None:
            return out
    k = flat["left"].shape[0]
    end = k if end is None else end
    if k == 0:
        return {
            "min": np.zeros((0, 3), np.float32),
            "max": np.zeros((0, 3), np.float32),
            "tri": np.zeros((0,), np.int32),
            "miss": np.zeros((0,), np.int32),
        }

    left, right = flat["left"], flat["right"]
    is_leaf = flat["is_leaf"]

    # DFS preorder over the BFS tree.
    preorder = np.empty(k, np.int64)
    new_id = np.empty(k, np.int64)
    stack = [0]
    pos = 0
    while stack:
        n = stack.pop()
        preorder[pos] = n
        new_id[n] = pos
        pos += 1
        if is_leaf[n] == 0:
            stack.append(right[n])  # pushed first -> visited after left subtree
            stack.append(left[n])

    miss = np.full(k, end, np.int64)  # new-id indexed
    for pos in range(k):
        n = preorder[pos]
        if is_leaf[n] == 0:
            miss[new_id[left[n]]] = new_id[right[n]]
            miss[new_id[right[n]]] = miss[pos]

    return {
        "min": flat["min"][preorder],
        "max": flat["max"][preorder],
        "tri": np.where(is_leaf[preorder] == 1, flat["tri"][preorder], -1).astype(np.int32),
        "miss": miss.astype(np.int32),
    }


def links_to_fat(links: Dict[str, np.ndarray], packed_tri_pos: np.ndarray,
                 tri_packed_id: np.ndarray, max_leaf: int = 8,
                 end: int | None = None) -> np.ndarray:
    """Collapse the 1-triangle-leaf skip-link BVH into a fat-leaf layout and
    pack each node's box AND its leaf triangles into ONE wide row.

    The lockstep traversal pays per STEP (one row gather per ray per
    visited node), so a leaf holding up to `max_leaf` triangles inline
    cuts both the node count (~max_leaf x fewer leaves) and the per-visit
    gather count (box + all triangles in one row); the extra triangle
    tests are cheap elementwise work.

    Works on the DFS-preorder skip-link arrays from `flat_to_links` (before
    padding): a node's subtree is the contiguous span [i, skip(i)), and the
    packed triangle rows (scene compile lays triangles in DFS *leaf order*)
    of that subtree form a contiguous range — so a fat leaf is just
    (tri_start, count) plus the inlined vertex rows.

    Row layout (width 9 + 9*max_leaf):
      [min(3), max(3), bitcast(miss), bitcast(tri_start), bitcast(count),
       tri_pos rows of the leaf's triangles (padded with degenerate zeros)]
    Internal nodes have count == 0.  The termination sentinel is the
    returned node count, re-targeted to `end` when given (for padding).

    `tri_packed_id[j]` = packed (DFS leaf order) triangle row of skip-link
    node j's triangle (-1 for internal nodes).
    """
    k = links["tri"].shape[0]
    width = 9 + 9 * max_leaf
    if k == 0:
        return np.zeros((0, width), np.float32)

    miss = links["miss"].astype(np.int64)
    tri = links["tri"].astype(np.int64)
    is_leaf = tri >= 0
    leaf_pre = np.concatenate([[0], np.cumsum(is_leaf)])

    def span_end(i):  # first preorder index NOT in i's subtree
        # miss links may carry a padded sentinel (> k): any target past the
        # real node count means "end of tree"
        return min(int(miss[i]), k) if miss[i] > i else k

    def collapsed(n):
        return is_leaf[n] or (leaf_pre[span_end(n)] - leaf_pre[n]) <= max_leaf

    # preorder emission, skipping the interiors of collapsed subtrees
    order = []
    stack = [0]
    while stack:
        n = stack.pop()
        order.append(n)
        if collapsed(n):
            continue
        c1 = n + 1  # first child follows in preorder
        c2 = span_end(c1)  # second child = end of first child's subtree
        stack.append(c2)
        stack.append(c1)
    new_id = {old: new for new, old in enumerate(order)}
    k2 = len(order)
    sentinel = k2 if end is None else end

    out = np.zeros((k2, width), np.float32)
    ivals = np.zeros(3, np.int32)
    for new, old in enumerate(order):
        e = span_end(old)
        out[new, 0:3] = links["min"][old]
        out[new, 3:6] = links["max"][old]
        # e is always either an emitted node or the end of the whole tree
        ivals[0] = new_id.get(e, sentinel) if e < k else sentinel
        if collapsed(old):
            leaf_nodes = np.arange(old, e)[is_leaf[old:e]]
            packed_ids = tri_packed_id[leaf_nodes]
            tstart = int(packed_ids.min())
            count = len(packed_ids)
            assert int(packed_ids.max()) == tstart + count - 1, (
                "packed triangle rows of a subtree must be contiguous"
            )
            ivals[1] = tstart
            ivals[2] = count
            out[new, 9 : 9 + 9 * count] = (
                packed_tri_pos[tstart : tstart + count].reshape(-1)
            )
        else:
            ivals[1] = -1
            ivals[2] = 0
        out[new, 6:9] = ivals.view(np.float32)
    return out
