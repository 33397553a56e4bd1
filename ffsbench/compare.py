"""The comparison that decides ``correct``: each pipe line and the spot table
of a run against the plain reference, as numbers each held to a limit of its
own (the configuration's ``limits``).

Numbers (a configuration's ``checks`` picks the groups):

* ``pipe``: ``lines_missing`` (frames due a line without one, plus lines
  for frames not due or sent twice), ``strong_px_diff`` (the sum over lines
  of |strong pixels - reference|), ``spots_2d_diff`` (the same for the spots
  past the size filter);
* ``centers``: ``centers_count_diff`` (the sum over lines of |spot centres -
  reference|) and ``centers_dev`` (the largest |coordinate - reference| in
  pixels over lines with as many centres as the reference);
* ``table``: ``table_rows_diff`` (|rows - reference|) and ``table_dev`` (the
  largest |value - reference| over each column's largest |reference|, over
  the centroids, both variances and the z extent; 1 where the rows differ in
  number).
"""

from __future__ import annotations

import numpy as np

TABLE_COLUMNS = ("xyzobs.px.value", "sigma_b_variance", "sigma_m_variance", "spot_extent_z")


def pipe_numbers(lines: dict, due: list[int], extra: int, ref, k: int, with_centers: bool):
    """(numbers, frames compared, frames that failed)."""
    got = set(lines)
    missing = len(set(due) - got) + len(got - set(due)) + extra
    strong = spots = ccount = 0
    cdev = 0.0
    failed = set(set(due) - got)
    for num in sorted(got & set(due)):
        line, want = lines[num], ref[num % k]
        ds = abs(int(line["num_strong_pixels"]) - len(want.lin))
        dn = abs(int(line["n_spots_total"]) - want.n_spots)
        strong += ds
        spots += dn
        bad = ds or dn
        if with_centers:
            c = np.asarray(line.get("spot_centers", []), dtype=np.float64).reshape(-1, 3)
            if len(c) != len(want.centers):
                ccount += abs(len(c) - len(want.centers))
                bad = True
            elif len(c):
                d = float(np.max(np.abs(c - want.centers.astype(np.float64))))
                cdev = max(cdev, d)
                bad = bad or d > 0
        if bad:
            failed.add(num)
    numbers = {"lines_missing": missing, "strong_px_diff": strong, "spots_2d_diff": spots}
    if with_centers:
        numbers.update(centers_count_diff=ccount, centers_dev=cdev)
    return numbers, len(due), len(failed)


def table_numbers(got: dict, want: dict) -> dict:
    rows_got = len(got["sigma_b_variance"])
    rows_want = len(want["sigma_b_variance"])
    if rows_got != rows_want:
        return {"table_rows_diff": abs(rows_got - rows_want), "table_dev": 1.0}
    dev = 0.0
    for name in TABLE_COLUMNS:
        a = np.asarray(got[name], dtype=np.float64)
        b = np.asarray(want[name], dtype=np.float64)
        if b.size:
            scale = float(np.max(np.abs(b))) or 1.0
            dev = max(dev, float(np.max(np.abs(a - b))) / scale)
    return {"table_rows_diff": 0, "table_dev": dev}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within limits, {name: {"value", "limit"}}); a number without a
    limit, or not finite, fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        within = limit is not None and np.isfinite(value) and value <= limit
        ok = ok and within
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
