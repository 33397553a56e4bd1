"""Multi-device runs over torch.distributed: meshes, sharded spotfinding,
halo exchange (counterpart of :mod:`ffs_tpu.parallel`)."""

from .mesh import (  # noqa: F401
    make_mesh,
    shard_frames,
    sharded_chunk_setup,
    sharded_kabsch_block_step,
    sharded_packed_pipeline,
    sharded_packed_sp_pipeline,
    sharded_rotation_compact,
    rotation_frame_pixels,
    sharded_spotfind_counts,
    halo_sharded_dispersion,
)
