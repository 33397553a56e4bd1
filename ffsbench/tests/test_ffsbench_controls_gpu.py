"""The controls on the card, at the cells' own sizes and loads (a short
window), as each configuration's ``control`` block names them.

* ``--control reference``: the reference put in the program's place, with
  one stage one step below what the configuration states (the Eiger spot
  table in float32; the Jungfrau threshold in bfloat16), comes out not
  correct.
* ``--control program``: the program's own float32 threshold path on the
  Eiger cells.  On these frames it gives every strong pixel of the float64
  path, so it meets every guarantee the configuration states and comes out
  correct with every number 0 (PERF.md, section 2).

Run on the card:

    python -m pytest ffsbench/tests/test_ffsbench_controls_gpu.py -m gpu -q -p no:cacheprovider -s
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEEDS = (2200000401, 2200000402, 2200000403)
EIGER = ["eiger16m-rotation-f64.catchup", "eiger16m-rotation-f64.live"]


def control(cell: str, kind: str, seed: int) -> dict:
    r = subprocess.run([sys.executable, "-m", "ffsbench.run", "--workload", cell, "--seed",
                        str(seed), "--seconds", "5", "--control", kind], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [*EIGER, "jungfrau1m-ssx-f32.catchup"])
def test_the_reference_one_step_below_fails(card, cell, seed):
    res = control(cell, "reference", seed)
    print(cell, seed, {k: v["value"] for k, v in res["checks"].items()})
    assert res["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", EIGER)
def test_the_programs_f32_path_gives_the_f64_answer(card, cell, seed):
    res = control(cell, "program", seed)
    print("program f32", cell, seed, {k: v["value"] for k, v in res["checks"].items()})
    assert res["correct"] is True
    assert all(v["value"] == 0 for v in res["checks"].values())
