"""Host-side 3D connected-component merge across frames.

The per-frame pixel-parallel work (thresholding, 2D labelling, compaction)
happens on device (ops/connected_components.py); what reaches the host is
only the compact strong-pixel list of each frame (a few thousand entries).
This module merges those per-frame fragments into 3D spots — the equivalent
of the reference's global Boost-graph merge (reference:
spotfinder/connected_components/connected_components.cc:270-471) — using a
vectorised union-find over *fragments* (per-frame 2D components) instead of
pixels: intra-frame connectivity is already folded on device, and two
fragments in adjacent frames merge iff they share a strong pixel at the
same (x, y), which is exactly the reference's inter-slice edge rule
(connected_components.cc:350-370).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FramePixels:
    """Compact strong pixels of one frame (host arrays, raster order)."""

    linear_index: np.ndarray  # (n,) int
    intensity: np.ndarray  # (n,) int
    root: np.ndarray  # (n,) int — 2D component root linear index


@dataclass
class Spots3D:
    """Per-spot statistics, one row per 3D (or 2D) connected component."""

    n_pixels: np.ndarray
    sum_intensity: np.ndarray
    com_x: np.ndarray  # +0.5 pixel-centre convention, intensity weighted
    com_y: np.ndarray
    com_z: np.ndarray
    x_min: np.ndarray
    x_max: np.ndarray
    y_min: np.ndarray
    y_max: np.ndarray
    z_min: np.ndarray
    z_max: np.ndarray
    peak_x: np.ndarray
    peak_y: np.ndarray
    peak_z: np.ndarray
    peak_intensity: np.ndarray
    # pixel-level membership, needed for per-spot variance calculations
    pixel_spot: np.ndarray  # (N,) spot id per pixel
    pixel_x: np.ndarray
    pixel_y: np.ndarray
    pixel_z: np.ndarray
    pixel_intensity: np.ndarray

    def __len__(self) -> int:
        return len(self.n_pixels)

    def peak_centroid_distance(self) -> np.ndarray:
        dx = self.peak_x + 0.5 - self.com_x
        dy = self.peak_y + 0.5 - self.com_y
        dz = self.peak_z + 0.5 - self.com_z
        return np.sqrt(dx * dx + dy * dy + dz * dz)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # keep the smaller root: deterministic labelling
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb

    def find_all(self, idx: np.ndarray) -> np.ndarray:
        # full path compression pass, then vectorised lookup
        p = self.parent
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self.parent = p
        return p[idx]

    def union_edges(self, u: np.ndarray, v: np.ndarray) -> None:
        """Batch union of edge arrays via iterated min-hooking.

        Vectorised replacement for a per-edge Python loop (r1 review weak
        #5: a 3600-frame collection with dense inter-slice edges): each
        round fully compresses, hooks every still-split edge's larger root
        onto the smallest root contending for it (np.minimum.at resolves
        conflicts), and repeats — O(log n) rounds.  Produces the same
        min-root partition as sequential keep-smaller-root unions.
        """
        if len(u) == 0:
            return
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        while True:
            p = self.parent
            while True:
                pp = p[p]
                if np.array_equal(pp, p):
                    break
                p = pp
            self.parent = p
            ru, rv = p[u], p[v]
            split = ru != rv
            if not split.any():
                return
            lo = np.minimum(ru[split], rv[split])
            hi = np.maximum(ru[split], rv[split])
            np.minimum.at(self.parent, hi, lo)


def merge_frames(
    frames: list[FramePixels],
    width: int,
) -> Spots3D:
    """Merge per-frame 2D fragments into 3D components and compute stats.

    ``frames`` must be in acquisition order; frame index becomes z.
    """
    # dense per-frame fragment ids and the global fragment numbering
    frag_ids = []
    frag_offsets = []
    total_frags = 0
    frame_roots = []
    for f in frames:
        roots, inv = np.unique(f.root, return_inverse=True)
        frag_ids.append(inv)
        frag_offsets.append(total_frags)
        frame_roots.append(roots)
        total_frags += len(roots)

    uf = _UnionFind(total_frags)
    edges_u, edges_v = [], []
    for z in range(len(frames) - 1):
        a, b = frames[z], frames[z + 1]
        if len(a.linear_index) == 0 or len(b.linear_index) == 0:
            continue
        common, ia, ib = np.intersect1d(
            a.linear_index, b.linear_index, assume_unique=True, return_indices=True
        )
        edges_u.append(frag_ids[z][ia] + frag_offsets[z])
        edges_v.append(frag_ids[z + 1][ib] + frag_offsets[z + 1])
    if edges_u:
        uf.union_edges(np.concatenate(edges_u), np.concatenate(edges_v))

    # flatten pixels with global fragment ids
    all_frag = np.concatenate(
        [frag_ids[z] + frag_offsets[z] for z in range(len(frames))]
    ) if frames else np.zeros(0, dtype=np.int64)
    all_lin = np.concatenate([f.linear_index for f in frames]) if frames else np.zeros(0, int)
    all_int = np.concatenate([f.intensity for f in frames]) if frames else np.zeros(0, int)
    all_z = np.concatenate(
        [np.full(len(f.linear_index), z, dtype=np.int64) for z, f in enumerate(frames)]
    ) if frames else np.zeros(0, int)

    spot_of_frag = uf.find_all(np.arange(total_frags))
    pixel_root = spot_of_frag[all_frag] if total_frags else all_frag
    # dense spot numbering, deterministic (ordered by min fragment id, which
    # is ordered by (frame, root linear index) — matching the reference's
    # slice-then-map iteration order)
    uniq, spot = np.unique(pixel_root, return_inverse=True)
    n_spots = len(uniq)

    x = (all_lin % width).astype(np.int64)
    y = (all_lin // width).astype(np.int64)
    inten = all_int.astype(np.float64)

    sum_i = np.bincount(spot, weights=inten, minlength=n_spots)
    n_pix = np.bincount(spot, minlength=n_spots)
    com_x = np.bincount(spot, weights=inten * x, minlength=n_spots) / sum_i + 0.5
    com_y = np.bincount(spot, weights=inten * y, minlength=n_spots) / sum_i + 0.5
    com_z = np.bincount(spot, weights=inten * all_z, minlength=n_spots) / sum_i + 0.5

    big = np.iinfo(np.int64).max

    def _extreme(vals, take_min):
        out = np.full(n_spots, big if take_min else -big, dtype=np.int64)
        (np.minimum if take_min else np.maximum).at(out, spot, vals)
        return out

    x_min, x_max = _extreme(x, True), _extreme(x, False)
    y_min, y_max = _extreme(y, True), _extreme(y, False)
    z_min, z_max = _extreme(all_z, True), _extreme(all_z, False)

    # peak: max intensity, ties -> smallest (z, y, x)
    # (reference: connected_components.cc:143-157)
    order = np.lexsort((x, y, all_z, -inten, spot))
    first = np.searchsorted(spot[order], np.arange(n_spots), side="left")
    peak_idx = order[first]

    return Spots3D(
        n_pixels=n_pix,
        sum_intensity=sum_i,
        com_x=com_x,
        com_y=com_y,
        com_z=com_z,
        x_min=x_min,
        x_max=x_max,
        y_min=y_min,
        y_max=y_max,
        z_min=z_min,
        z_max=z_max,
        peak_x=x[peak_idx],
        peak_y=y[peak_idx],
        peak_z=all_z[peak_idx],
        peak_intensity=inten[peak_idx],
        pixel_spot=spot,
        pixel_x=x,
        pixel_y=y,
        pixel_z=all_z,
        pixel_intensity=inten,
    )


class StreamingMerger3D:
    """Incremental 3D merge: consume frames as the collection streams.

    The batch :func:`merge_frames` materialises every frame's pixels
    before merging — fine for short scans, but SURVEY §5 calls the
    streaming per-frame label merge the novel long-axis design and the
    reference marks 3D CC "HOT for long scans"
    (connected_components.cc:270-471).  This class carries the
    label-equivalence state across frames:

      * union-find over per-frame 2D FRAGMENTS (min-root hooking, so the
        component root is its smallest global fragment id — the same
        deterministic numbering the batch merge derives);
      * per-fragment integer statistics (counts, intensity-weighted
        coordinate sums, bboxes, peak candidates) accumulated at push
        time — all integer-valued, so the final per-spot sums are exact
        and BIT-IDENTICAL to the batch merge regardless of addition
        order;
      * a component CLOSES as soon as it has no fragment in the newest
        frame (inter-frame edges only ever connect adjacent frames), at
        which point its statistics collapse into one spot record and its
        pixel storage — retained only for OPEN components — is freed.

    Memory is bounded by fragments plus the pixels of currently-open
    components (≈ the last frame's worth), not by the collection length.

    ``keep_pixels=True`` additionally retains every pixel so
    ``finalize()`` reproduces the batch merge's pixel-level fields
    (compat/test mode; memory is then pixel-bound again).

    ``on_spot_closed``: optional callback ``f(record: dict)`` invoked as
    each component closes, with the spot's statistics and (if pixel
    retention is on for open components, which it always is) its pixel
    arrays — the hook for streaming per-spot variance computation.
    """

    _GROW = 4096

    def __init__(self, width: int, *, keep_pixels: bool = False,
                 on_spot_closed=None):
        self.width = width
        self.keep_pixels = keep_pixels
        self.on_spot_closed = on_spot_closed
        self._z = 0
        self._n_frags = 0
        cap = self._GROW
        self._parent = np.arange(cap, dtype=np.int64)
        self._frag_z = np.zeros(cap, dtype=np.int64)
        self._stats = {
            name: np.zeros(cap, dtype=np.int64)
            for name in (
                "n_pix", "sum_i", "sum_ix", "sum_iy", "sum_iz",
                "x_min", "x_max", "y_min", "y_max",
                "peak_i", "peak_z", "peak_y", "peak_x",
            )
        }
        self._open = np.zeros(0, dtype=np.int64)  # open fragment ids
        # per-FRAME pixel retention (freed once every fragment of the
        # frame has closed): z -> (lin_sorted_by_frag, inten, frag_sorted)
        self._pix_frames: dict[int, tuple] = {}
        self._open_in_frame: dict[int, int] = {}
        self._prev: tuple[np.ndarray, np.ndarray] | None = None
        self._cols: dict[str, list] = {
            name: []
            for name in (
                "root", "n_pix", "sum_i", "sum_ix", "sum_iy", "sum_iz",
                "x_min", "x_max", "y_min", "y_max", "z_min", "z_max",
                "peak_i", "peak_z", "peak_y", "peak_x",
            )
        }
        self._all_pixels: list[tuple] = []  # keep_pixels mode

    # -- union-find over the growable parent array ------------------------
    def _grow_to(self, n: int) -> None:
        cap = len(self._parent)
        if n <= cap:
            return
        # geometric growth: fixed-chunk growth copied the 13 stats arrays
        # O(total_frags^2 / chunk) times — ~100 GB of memcpy over a
        # 3600-frame collection's 3M fragments (the 137 s hot spot)
        new_cap = max(n, 2 * cap)
        grown = np.arange(new_cap, dtype=np.int64)
        grown[:cap] = self._parent
        self._parent = grown
        self._frag_z = np.resize(self._frag_z, new_cap)
        for k, v in self._stats.items():
            self._stats[k] = np.resize(v, new_cap)

    def _find_all(self, idx: np.ndarray) -> np.ndarray:
        """Roots with FULL global path compression (finalize-time only:
        a per-frame global compression would be O(total_frags) per frame
        = quadratic over a long collection)."""
        p = self._parent
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self._parent = p
        return p[idx]

    def _roots_of(self, idx: np.ndarray) -> np.ndarray:
        """Roots of just ``idx`` — touches only the chains it follows,
        keeping the per-frame work proportional to the OPEN set."""
        p = self._parent
        r = p[idx]
        while True:
            rr = p[r]
            if np.array_equal(rr, r):
                return r
            r = rr

    def _union_edges(self, u: np.ndarray, v: np.ndarray) -> None:
        while True:
            ru, rv = self._roots_of(u), self._roots_of(v)
            split = ru != rv
            if not split.any():
                return
            lo = np.minimum(ru[split], rv[split])
            hi = np.maximum(ru[split], rv[split])
            np.minimum.at(self._parent, hi, lo)

    # -- streaming interface ----------------------------------------------
    def push_frame(self, f: FramePixels) -> None:
        z = self._z
        self._z += 1
        lin = np.asarray(f.linear_index, dtype=np.int64)
        inten = np.asarray(f.intensity, dtype=np.int64)
        roots, inv = np.unique(np.asarray(f.root, dtype=np.int64),
                               return_inverse=True)
        nf = len(roots)
        base = self._n_frags
        self._n_frags += nf
        self._grow_to(self._n_frags)
        gids = base + np.arange(nf, dtype=np.int64)
        self._frag_z[gids] = z

        if nf:
            x = lin % self.width
            y = lin // self.width
            st = self._stats
            st["n_pix"][gids] = np.bincount(inv, minlength=nf)
            st["sum_i"][gids] = np.bincount(inv, weights=inten, minlength=nf)
            st["sum_ix"][gids] = np.bincount(
                inv, weights=inten * x, minlength=nf
            )
            st["sum_iy"][gids] = np.bincount(
                inv, weights=inten * y, minlength=nf
            )
            st["sum_iz"][gids] = np.bincount(
                inv, weights=inten * z, minlength=nf
            )
            big = np.iinfo(np.int64).max
            for name, vals, take_min in (
                ("x_min", x, True), ("x_max", x, False),
                ("y_min", y, True), ("y_max", y, False),
            ):
                acc = np.full(nf, big if take_min else -big, np.int64)
                (np.minimum if take_min else np.maximum).at(acc, inv, vals)
                st[name][gids] = acc
            # per-fragment peak: max intensity, ties -> smallest (y, x)
            # (z is constant within a fragment)
            order = np.lexsort((x, y, -inten, inv))
            first = np.searchsorted(inv[order], np.arange(nf), side="left")
            pk = order[first]
            st["peak_i"][gids] = inten[pk]
            st["peak_z"][gids] = z
            st["peak_y"][gids] = y[pk]
            st["peak_x"][gids] = x[pk]
            frag_global = gids[inv]
            # bulk per-frame pixel retention: ONE argsort per frame (a
            # per-fragment dict fill was ~3M Python ops over a 3600-frame
            # collection — the 160 s hot spot of the first streaming cut)
            order_f = np.argsort(frag_global, kind="stable")
            self._pix_frames[z] = (
                lin[order_f], inten[order_f], frag_global[order_f]
            )
            self._open_in_frame[z] = nf
            if self.keep_pixels:
                self._all_pixels.append((lin, inten, frag_global, z))
        else:
            frag_global = np.zeros(0, dtype=np.int64)

        # inter-frame edges against the previous frame (shared (x, y))
        if self._prev is not None and nf and len(self._prev[0]):
            plin, pfrag = self._prev
            common, ia, ib = np.intersect1d(
                plin, lin, assume_unique=True, return_indices=True
            )
            if len(common):
                self._union_edges(pfrag[ia], frag_global[ib])

        self._prev = (lin, frag_global)
        self._open = np.concatenate([self._open, gids])
        # sweep for closeable components every few frames: the sweep is
        # ~20 numpy ops over the open set, and closing a component a few
        # frames late is still exact (its statistics are final either
        # way) — this trimmed the 3600-frame merge 9.2 -> ~7 s
        if z % 4 == 3:
            self._close_finished(before_z=z - 2)

    def push_frames(self, frames) -> None:
        for f in frames:
            self.push_frame(f)

    def _close_finished(self, before_z: int | None = None) -> None:
        """Close every open component whose newest fragment is older than
        ``before_z`` (None = close everything)."""
        if not len(self._open):
            return
        roots = self._roots_of(self._open)
        if before_z is not None:
            uniq_r, inv_r = np.unique(roots, return_inverse=True)
            mx = np.full(len(uniq_r), -1, dtype=np.int64)
            np.maximum.at(mx, inv_r, self._frag_z[self._open])
            closing = mx[inv_r] < before_z
        else:
            closing = np.ones(len(self._open), dtype=bool)
        if not closing.any():
            return
        close_frags = self._open[closing]
        close_roots = roots[closing]
        self._open = self._open[~closing]
        # vectorised per-component aggregation (a per-spot Python loop
        # measured 200 s for a 3600-frame collection's 2.9M spots — 18x
        # the batch merge; reduceat segments bring it to numpy speed)
        order = np.argsort(close_roots, kind="stable")
        cf, cr = close_frags[order], close_roots[order]
        uniq, starts = np.unique(cr, return_index=True)
        st = self._stats
        cols = self._cols
        cols["root"].append(uniq)
        for name in ("n_pix", "sum_i", "sum_ix", "sum_iy", "sum_iz"):
            cols[name].append(np.add.reduceat(st[name][cf], starts))
        cols["x_min"].append(np.minimum.reduceat(st["x_min"][cf], starts))
        cols["y_min"].append(np.minimum.reduceat(st["y_min"][cf], starts))
        cols["x_max"].append(np.maximum.reduceat(st["x_max"][cf], starts))
        cols["y_max"].append(np.maximum.reduceat(st["y_max"][cf], starts))
        fz = self._frag_z[cf]
        cols["z_min"].append(np.minimum.reduceat(fz, starts))
        cols["z_max"].append(np.maximum.reduceat(fz, starts))
        # peak combine: max intensity, ties -> smallest (z, y, x) — the
        # first fragment per component in (root, -peak_i, z, y, x) order
        pi, pz = st["peak_i"][cf], st["peak_z"][cf]
        py, px = st["peak_y"][cf], st["peak_x"][cf]
        win = np.lexsort((px, py, pz, -pi, cr))
        first = np.searchsorted(cr[win], uniq, side="left")
        k = win[first]
        cols["peak_i"].append(pi[k])
        cols["peak_z"].append(pz[k])
        cols["peak_y"].append(py[k])
        cols["peak_x"].append(px[k])

        if self.on_spot_closed is not None:
            ends = np.append(starts[1:], len(cf))
            fz_all = self._frag_z[cf]
            for j, r in enumerate(uniq):
                frs = cf[starts[j] : ends[j]]
                frs_z = fz_all[starts[j] : ends[j]]
                lins, ints, zs = [], [], []
                for g, gz in zip(frs, frs_z):
                    fl, fi, ff = self._pix_frames[int(gz)]
                    a = np.searchsorted(ff, g, side="left")
                    b = np.searchsorted(ff, g, side="right")
                    lins.append(fl[a:b])
                    ints.append(fi[a:b])
                    zs.append(np.full(b - a, gz, np.int64))
                rec = {
                    "root": int(r),
                    "n_pixels": int(cols["n_pix"][-1][j]),
                    "sum_intensity": int(cols["sum_i"][-1][j]),
                    "x_min": int(cols["x_min"][-1][j]),
                    "x_max": int(cols["x_max"][-1][j]),
                    "y_min": int(cols["y_min"][-1][j]),
                    "y_max": int(cols["y_max"][-1][j]),
                    "z_min": int(cols["z_min"][-1][j]),
                    "z_max": int(cols["z_max"][-1][j]),
                    "peak_intensity": int(cols["peak_i"][-1][j]),
                    "peak_z": int(cols["peak_z"][-1][j]),
                    "peak_y": int(cols["peak_y"][-1][j]),
                    "peak_x": int(cols["peak_x"][-1][j]),
                    "pixel_linear_index": np.concatenate(lins)
                    if lins else np.zeros(0, np.int64),
                    "pixel_intensity": np.concatenate(ints)
                    if ints else np.zeros(0, np.int64),
                    "pixel_z": np.concatenate(zs)
                    if zs else np.zeros(0, np.int64),
                }
                self.on_spot_closed(rec)
        # free whole frames once every one of their fragments has closed
        closed_per_frame = np.bincount(self._frag_z[cf])
        for zf in np.nonzero(closed_per_frame)[0]:
            left = self._open_in_frame.get(int(zf))
            if left is None:
                continue
            left -= int(closed_per_frame[zf])
            if left <= 0:
                self._open_in_frame.pop(int(zf), None)
                self._pix_frames.pop(int(zf), None)
            else:
                self._open_in_frame[int(zf)] = left

    @property
    def retained_pixels(self) -> int:
        """Pixels currently held for open components (streaming memory)."""
        return sum(len(v[0]) for v in self._pix_frames.values())

    def finalize(self) -> Spots3D:
        """Close all remaining components and build the Spots3D, ordered
        and valued bit-identically to :func:`merge_frames`."""
        self._close_finished(before_z=None)

        def cat(name):
            parts = self._cols[name]
            return (
                np.concatenate(parts) if parts else np.zeros(0, np.int64)
            )

        roots = cat("root")
        order = np.argsort(roots, kind="stable")

        def col(name, dtype=np.int64):
            return cat(name)[order].astype(dtype)

        sum_i = col("sum_i").astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            com_x = col("sum_ix").astype(np.float64) / sum_i + 0.5
            com_y = col("sum_iy").astype(np.float64) / sum_i + 0.5
            com_z = col("sum_iz").astype(np.float64) / sum_i + 0.5

        if self.keep_pixels and self._all_pixels:
            all_lin = np.concatenate([p[0] for p in self._all_pixels])
            all_int = np.concatenate([p[1] for p in self._all_pixels])
            all_frag = np.concatenate([p[2] for p in self._all_pixels])
            all_z = np.concatenate(
                [np.full(len(p[0]), p[3], np.int64) for p in self._all_pixels]
            )
            root_of = self._find_all(all_frag)
            sorted_roots = roots[order]
            spot = np.searchsorted(sorted_roots, root_of).astype(np.int64)
            px = all_lin % self.width
            py = all_lin // self.width
            pint = all_int.astype(np.float64)
        else:
            spot = np.zeros(0, np.int64)
            px = py = all_z = np.zeros(0, np.int64)
            pint = np.zeros(0, np.float64)

        return Spots3D(
            n_pixels=col("n_pix"),
            sum_intensity=sum_i,
            com_x=com_x, com_y=com_y, com_z=com_z,
            x_min=col("x_min"), x_max=col("x_max"),
            y_min=col("y_min"), y_max=col("y_max"),
            z_min=col("z_min"), z_max=col("z_max"),
            peak_x=col("peak_x"), peak_y=col("peak_y"),
            peak_z=col("peak_z"),
            peak_intensity=col("peak_i", np.float64),
            pixel_spot=spot, pixel_x=px, pixel_y=py,
            pixel_z=all_z, pixel_intensity=pint,
        )


def filter_spots(
    spots: Spots3D, min_spot_size: int, max_peak_centroid_separation: float
) -> tuple[np.ndarray, int, int]:
    """(keep mask, n_filtered_by_size, n_filtered_by_separation), matching
    reference filter order (connected_components.cc:207-236)."""
    keep = np.ones(len(spots), dtype=bool)
    n_size = 0
    if min_spot_size > 0:
        size_ok = spots.n_pixels >= min_spot_size
        n_size = int((~size_ok).sum())
        keep &= size_ok
    n_sep = 0
    if max_peak_centroid_separation > 0:
        sep_ok = spots.peak_centroid_distance() <= max_peak_centroid_separation
        n_sep = int((keep & ~sep_ok).sum())
        keep &= sep_ok
    return keep, n_size, n_sep


def variances_in_kabsch_space(
    spots: Spots3D,
    panel,
    scan,
    s0: np.ndarray,
    m2: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-spot (sigma_b_variance, sigma_m_variance, bbox_depth).

    Vectorised port of the per-pixel Kabsch-frame variance accumulation
    (reference: connected_components.cc:159-203): intensity-weighted
    variances of the e1/e2-plane displacement (averaged per dials#2851) and
    the e3 (rotation) displacement, per 3D spot.
    """
    # per-spot reference vectors at the centroid
    xmm, ymm = panel.px_to_mm(spots.com_x, spots.com_y)
    s1 = panel.get_lab_coord(xmm, ymm)  # (S, 3)
    e1 = np.cross(s1, s0)
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(s1, e1)
    e2 /= np.linalg.norm(e2, axis=-1, keepdims=True)
    mags1 = np.linalg.norm(s1, axis=-1)
    zeta = e1 @ m2
    osc_start, osc_width = scan.oscillation
    image_range_0 = scan.image_range[0]
    phi = np.deg2rad(osc_start + (spots.com_z - image_range_0) * osc_width)

    # per-pixel displacements
    pxmm, pymm = panel.px_to_mm(spots.pixel_x + 0.5, spots.pixel_y + 0.5)
    s1p = panel.get_lab_coord(pxmm, pymm)  # (N, 3)
    sid = spots.pixel_spot
    delta = s1p - s1[sid]
    eps1 = np.einsum("ij,ij->i", delta, e1[sid]) / mags1[sid]
    eps2 = np.einsum("ij,ij->i", delta, e2[sid]) / mags1[sid]
    phi_px = np.deg2rad(
        osc_start + (spots.pixel_z + 0.5 - image_range_0) * osc_width
    )
    eps3 = (phi_px - phi[sid]) * zeta[sid]

    w = spots.pixel_intensity
    n = len(spots)
    tot = np.bincount(sid, weights=w, minlength=n)
    varx = np.bincount(sid, weights=w * eps1 * eps1, minlength=n) / tot
    vary = np.bincount(sid, weights=w * eps2 * eps2, minlength=n) / tot
    varz = np.bincount(sid, weights=w * eps3 * eps3, minlength=n) / tot
    depth = spots.z_max - spots.z_min + 1
    # (varx + vary)/2: see dials/dials#2851
    return (varx + vary) / 2.0, varz, depth
