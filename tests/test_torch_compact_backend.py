"""The port's ``--compact-backend host`` with the f64 default: the run
stops with ValueError, as the JAX CLI's does, and the help says so."""

import pytest


def test_compact_backend_host_with_f64_stops_the_run(tmp_path, monkeypatch, capsys):
    """--compact-backend host needs the f32 kernel path: with the default
    f64 precision the run raises (as the JAX CLI does) and the help says so."""
    from ffs_tpu_torch.pipeline import spotfinder

    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="compact_backend='host'"):
        spotfinder.run(["--sample", "--images", "1", "--wavelength", "1.0",
                        "--compact-backend", "host"])
    with pytest.raises(SystemExit):
        spotfinder.run(["--help"])
    assert "not ignored" in " ".join(capsys.readouterr().out.split())
