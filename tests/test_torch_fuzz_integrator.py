"""ffs_tpu_torch.tools.fuzz_integrator against the repo's
tools/fuzz_integrator.py.

Seeds 0 and 1 (the JAX guard's, tests/test_fuzz_integrator_smoke.py) pass
on the CPU, where the port's window gathers run their plain versions.  For
seed 0 the port draws the JAX tool's experiment (bounding boxes, s1, phi,
frames, mask, max_active, deltas, algorithm) and its accumulators equal
those of the JAX tool's KabschIntegrator run, all eight bit for bit.
"""

import pathlib

import numpy as np
import pytest
import torch

from ffs_tpu_torch.tools import fuzz_integrator as tf

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_passes_on_cpu(seed):
    assert tf.run_seed(seed, CPU, verbose=True)


def test_seed0_is_the_jax_experiment(monkeypatch):
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import fuzz_integrator as jfuzz

    seen = {}

    class Recording(jfuzz.kb.KabschIntegrator):
        def __init__(self, **kw):
            seen["kw"] = kw
            super().__init__(**kw)

        def integrate(self, reader, image_numbers, acc, *args, **kwargs):
            seen["reader"], seen["acc"] = reader, acc
            return super().integrate(reader, image_numbers, acc, *args, **kwargs)

    monkeypatch.setattr(jfuzz.kb, "KabschIntegrator", Recording)
    assert jfuzz.run_seed(0)
    kw, reader = seen["kw"], seen["reader"]

    d = tf.draw(0, CPU)
    np.testing.assert_array_equal(d.bboxes, kw["bboxes"])
    np.testing.assert_allclose(d.s1, kw["s1"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(d.phi, kw["phi"], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(d.reader.frames, reader.frames)
    np.testing.assert_array_equal(d.reader.get_mask(), reader.get_mask())
    assert (d.max_active, d.algorithm) == (kw["max_active"], kw["algorithm"])
    assert (d.delta_b, d.delta_m) == (kw["delta_b"], kw["delta_m"])
    assert "pack=1" in d.tag and kw["lane_pack"]

    acc = tf.integrate(d, CPU)
    assert acc.fg_count.sum() > 0
    for name in tf.ACCUMULATORS:
        np.testing.assert_array_equal(getattr(acc, name), np.asarray(getattr(seen["acc"], name)),
                                      err_msg=name)
