"""The port's copy of the logging set-up (:mod:`ffs_tpu_torch.utils.logging`)
on the cases of tests/test_masking_logging_init.py."""

import logging
import logging.handlers

from ffs_tpu_torch.utils.logging import setup_logging


def test_setup_logging_plain_format_and_level(tmp_path, monkeypatch, capsys):
    """Without a TTY (a container) the records are bare messages; LOG_LEVEL sets the
    threshold; the rotating file sink records formatted lines."""
    monkeypatch.setenv("LOG_LEVEL", "warning")
    monkeypatch.chdir(tmp_path)
    log = setup_logging(name="ffs_torch_test_plain", log_file=str(tmp_path / "f.txt"))
    assert log.level == logging.WARNING
    log.info("hidden")
    log.warning("shown-bare")
    out = capsys.readouterr().out
    assert "hidden" not in out
    assert "shown-bare" in out
    assert "WARNING shown-bare" not in out
    content = (tmp_path / "f.txt").read_text()
    assert "WARNING shown-bare" in content and "hidden" not in content
    # idempotent: re-setup must not duplicate handlers
    n = len(log.handlers)
    assert len(setup_logging(name="ffs_torch_test_plain").handlers) == n


def test_setup_logging_unwritable_file_falls_back(monkeypatch):
    monkeypatch.delenv("LOG_LEVEL", raising=False)
    log = setup_logging(name="ffs_torch_test_nofile", log_file="/proc/nope/f.txt")
    assert log.level == logging.INFO
    assert not any(isinstance(h, logging.handlers.RotatingFileHandler) for h in log.handlers)


def test_setup_logging_default_logger_is_the_port_s(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    log = logging.getLogger("ffs_tpu_torch")
    saved = list(log.handlers), log.level
    try:
        assert setup_logging(log_file=None) is log
    finally:
        log.handlers[:] = saved[0]
        log.setLevel(saved[1])
