"""Flow-file IO (`.flo`, KITTI 16-bit `.png`, `.npy`, `.pfm`)."""

from pcfa_tpu_torch.io.flow_io import (
    read_flow,
    write_flow,
    read_flo,
    write_flo,
    read_kitti_png,
    write_kitti_png,
    read_pfm,
    read_gen,
    read_image,
)

__all__ = [
    "read_flow",
    "write_flow",
    "read_flo",
    "write_flo",
    "read_kitti_png",
    "write_kitti_png",
    "read_pfm",
    "read_gen",
    "read_image",
]
