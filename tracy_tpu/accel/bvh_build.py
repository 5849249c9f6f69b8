"""Host-side binned-SAH BVH builder (numpy reference implementation).

The reference ships a duplicating kd-tree (src/kdtree.h:42-429, built with
object duplication into overlapping children and SAH optionally disabled) and
an empty BVH stub whose comment asks for exactly what we build here: a
"faster to build, simpler to use in gpu-like code" structure (bvh.h:13-21).

Design: top-down binned SAH (64 bins, all 3 axes), fixed element ranges (no
duplication — every triangle lands in exactly one leaf), max-depth bounded so
device traversal stacks are statically sized, flattened to SoA arrays:

  node_bounds [Nn, 6]  (min xyz, max xyz) float32
  node_meta   [Nn, 3]  int32: leaf  -> (first_slot, count,  -1)
                               inner -> (left_child, 0, right_child)
  tri_order   [T]      permutation: slot -> original triangle id

A C++ builder with the same contract lives in native/bvh_builder.cpp for
large scenes; this numpy version is the oracle it is tested against.
"""

from __future__ import annotations

import dataclasses
import numpy as np

NUM_BINS = 64  # 16 -> 64: dragon wave-2 leaf visits -5%, inner -6% (replay)
TRAVERSAL_COST = 1.0
INTERSECT_COST = 2.0


@dataclasses.dataclass
class HostBVH:
    node_bounds: np.ndarray  # [Nn, 6] float32
    node_meta: np.ndarray  # [Nn, 3] int32
    tri_order: np.ndarray  # [T] int32
    max_depth: int  # deepest node depth actually produced (root = 0)

    @property
    def num_nodes(self) -> int:
        return len(self.node_meta)


def build_bvh(
    tri_min: np.ndarray,  # [T, 3]
    tri_max: np.ndarray,  # [T, 3]
    leaf_size: int = 8,
    max_depth: int = 60,
    cost_mode: str = "tris",  # 'tris' = classic SAH (per-triangle
    # intersection cost); 'chunks' = per-LEAF-VISIT cost, for a traversal
    # that tests a whole fixed-width leaf chunk at count-independent cost:
    # the objective minimizes expected CHUNK visits
    # (ceil(count/leaf_size) replaces count in the split cost).
) -> HostBVH:
    t_count = len(tri_min)
    assert t_count > 0
    centroids = 0.5 * (tri_min + tri_max)
    order = np.arange(t_count, dtype=np.int64)

    nb: list = []  # bounds rows
    nm: list = []  # meta rows
    deepest = 0

    # Stack of (node_id, start, end, depth); node rows appended before children
    # are known, then patched.
    nb.append(np.zeros(6, np.float32))
    nm.append(np.zeros(3, np.int32))
    stack = [(0, 0, t_count, 0)]

    while stack:
        node_id, start, end, depth = stack.pop()
        deepest = max(deepest, depth)
        idx = order[start:end]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        nb[node_id] = np.concatenate([bmin, bmax]).astype(np.float32)

        count = end - start
        if count <= leaf_size or depth >= max_depth:
            nm[node_id] = np.array([start, count, -1], np.int32)
            continue

        split = _find_split(centroids[idx], tri_min[idx], tri_max[idx],
                            count, leaf_size, cost_mode)
        if split is None:
            # Degenerate centroid spread: median split on largest axis.
            axis = int(np.argmax(bmax - bmin))
            key = np.argsort(centroids[idx, axis], kind="stable")
            mid = count // 2
            order[start:end] = idx[key]
        else:
            axis, go_left = split
            order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
            mid = int(go_left.sum())
            if mid == 0 or mid == count:
                key = np.argsort(centroids[idx, axis], kind="stable")
                order[start:end] = idx[key]
                mid = count // 2

        left_id = len(nb)
        nb.append(np.zeros(6, np.float32))
        nm.append(np.zeros(3, np.int32))
        right_id = len(nb)
        nb.append(np.zeros(6, np.float32))
        nm.append(np.zeros(3, np.int32))
        nm[node_id] = np.array([left_id, 0, right_id], np.int32)
        # Push right first so the left child is processed next (DFS order).
        stack.append((right_id, start + mid, end, depth + 1))
        stack.append((left_id, start, start + mid, depth + 1))

    return HostBVH(
        node_bounds=np.stack(nb),
        node_meta=np.stack(nm),
        tri_order=order.astype(np.int32),
        max_depth=deepest,
    )


def _surface_area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _find_split(cent, tmin, tmax, count, leaf_size=8, cost_mode="tris"):
    """Binned SAH over all 3 axes; returns (axis, go_left mask) or None."""
    cmin = cent.min(axis=0)
    cmax = cent.max(axis=0)
    extent = cmax - cmin
    best = None

    if cost_mode == "chunks":
        def isect_cost(n):
            return np.ceil(n / leaf_size)
    else:
        def isect_cost(n):
            return n
    best_cost = INTERSECT_COST * isect_cost(count)  # making this a leaf

    for axis in range(3):
        if extent[axis] <= 1e-12:
            continue
        scale = NUM_BINS * (1.0 - 1e-6) / extent[axis]
        bin_id = ((cent[:, axis] - cmin[axis]) * scale).astype(np.int64)
        np.clip(bin_id, 0, NUM_BINS - 1, out=bin_id)

        counts = np.bincount(bin_id, minlength=NUM_BINS)
        binned_min = np.full((NUM_BINS, 3), np.inf)
        binned_max = np.full((NUM_BINS, 3), -np.inf)
        for c in range(3):
            np.minimum.at(binned_min[:, c], bin_id, tmin[:, c])
            np.maximum.at(binned_max[:, c], bin_id, tmax[:, c])

        # Prefix/suffix sweep.
        lmin = np.minimum.accumulate(binned_min, axis=0)
        lmax = np.maximum.accumulate(binned_max, axis=0)
        rmin = np.minimum.accumulate(binned_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binned_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = count - lcount

        # Split after bin b (b in 0..NUM_BINS-2).
        la = _surface_area(lmin[:-1], lmax[:-1])
        ra = _surface_area(rmin[1:], rmax[1:])
        valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
        parent_area = max(_surface_area(tmin.min(axis=0), tmax.max(axis=0)), 1e-30)
        cost = TRAVERSAL_COST + INTERSECT_COST * (
            la * isect_cost(lcount[:-1]) + ra * isect_cost(rcount[:-1])
        ) / parent_area
        cost = np.where(valid, cost, np.inf)
        b = int(np.argmin(cost))
        if cost[b] < best_cost:
            best_cost = cost[b]
            best = (axis, bin_id <= b)

    return best


def pad_leaves(bvh: HostBVH, leaf_size: int) -> HostBVH:
    """Ensure tri_order has leaf_size slack past every leaf's range so device
    traversal can gather a fixed-size window (masked by count)."""
    t = len(bvh.tri_order)
    pad = np.full((leaf_size,), bvh.tri_order[-1] if t else 0, np.int32)
    return dataclasses.replace(bvh, tri_order=np.concatenate([bvh.tri_order, pad]))
