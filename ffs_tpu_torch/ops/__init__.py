"""The port's device and host operations."""


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper that counts its launches: TPU kernel rows
    1-5 and the float64 walker of the CLI's default step.  The modules load
    on the first call, not with the package."""
    from . import bitshuffle_device, window_gather
    from .dispersion_extended_packed import dispersion_extended_packed_raw
    from .dispersion_packed import dispersion_packed_f64, dispersion_packed_raw

    return {
        "dispersion_packed": dispersion_packed_raw,
        "dispersion_extended_packed": dispersion_extended_packed_raw,
        "dispersion_packed_f64": dispersion_packed_f64,
        "window_gather_planes": window_gather.window_gather_planes,
        "window_gather": window_gather.window_gather,
        "bitshuffle_frames": bitshuffle_device.frames_from_planes,
    }
