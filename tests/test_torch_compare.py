"""The port's XRC result-compare service (:mod:`ffs_tpu_torch.service.
compare`) on the cases of the JAX package's compare tests
(tests/test_cbf_and_compare.py) and its lazy ``workflows.services`` entry
point (tests/test_service.py)."""

import pytest

from ffs_tpu_torch.service import compare as compare_mod
from ffs_tpu_torch.service.compare import XRCCompareCore

from .test_cbf_and_compare import _FakeRW, _FakeTransport, _result_message


def test_xrc_compare_pairs_and_acks():
    core = XRCCompareCore()
    t = _FakeTransport()
    core.compare_xrc(_FakeRW({"dcid": 7, "gpu": True}, t), {"id": "gpu"}, _result_message())
    assert not t.acked  # first result waits for its partner
    core.compare_xrc(_FakeRW({"dcid": 7, "gpu": False}, t), {"id": "cpu"}, _result_message())
    assert {h["id"] for h in t.acked} == {"gpu", "cpu"}
    assert not t.nacked


def test_xrc_compare_rejects_duplicate_side():
    """Two results of one side: both nacked, each message settled once."""
    core = XRCCompareCore()
    t = _FakeTransport()
    core.compare_xrc(_FakeRW({"dcid": 9, "gpu": True}, t), {"id": "g1"}, _result_message())
    core.compare_xrc(_FakeRW({"dcid": 9, "gpu": True}, t), {"id": "g2"}, _result_message())
    assert len(t.nacked) == 2 and not t.acked


def test_xrc_compare_rejects_invalid_message():
    core = XRCCompareCore()
    t = _FakeTransport()
    core.compare_xrc(_FakeRW({"dcid": 5}, t), {"id": "bad"}, {"nope": 1})
    assert t.nacked and not t.acked


def test_xrc_compare_logs_under_the_port_name(caplog):
    core = XRCCompareCore()
    t = _FakeTransport()
    with caplog.at_level("INFO", logger="ffs_tpu_torch.compare"):
        core.compare_xrc(_FakeRW({"dcid": 3, "gpu": True}, t), {"id": "g"}, _result_message(2))
    assert any(r.name == "ffs_tpu_torch.compare" and "Gotten XRC Result for 3 (GPU)"
               in r.getMessage() for r in caplog.records)


def test_zocalo_entry_point_attribute_is_lazy():
    """The `workflows.services` entry point resolves a module attribute that
    builds the CommonService subclass on access; without workflows the
    access raises ImportError (not AttributeError: the hook exists)."""
    try:
        import workflows  # noqa: F401

        have_workflows = True
    except ImportError:
        have_workflows = False
    if have_workflows:
        assert compare_mod.TorchXRCResultCompare.__name__ == "TorchXRCResultCompare"
    else:
        with pytest.raises(ImportError):
            compare_mod.TorchXRCResultCompare
    with pytest.raises(AttributeError):
        compare_mod.XRCResultCompare
    with pytest.raises(AttributeError):
        compare_mod.NoSuchService
