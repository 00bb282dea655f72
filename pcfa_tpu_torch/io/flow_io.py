"""Flow-file IO: .flo (Middlebury/Sintel), 16-bit .png (KITTI), .npy, .pfm.

The port's own copy of `pcfa_tpu/io/flow_io.py` (numpy; cv2 and PIL
imported only where a KITTI png or an image is read).

Format-compatible rebuild of the reference's two IO stacks
(`flow_library/flow_IO.py` and `helper_functions/frame_utils.py`), vectorized
with numpy (the reference parses .flo row-by-row with `struct`). Invalid flow
("unknown") is represented as NaN, matching `flow_IO.py:7-8,111`:
values with |u| or |v| > 1e9 read as NaN; NaNs write as 1e10.

KITTI 16-bit PNGs are encoded `(uv * 64 + 2**15, valid)` and read and
written with cv2, matching `frame_utils.py:138-156`.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

FLO_TAG_FLOAT = 202021.25
FLO_TAG_STRING = b"PIEH"
FLO_UNKNOWN_FLOW_THRESH = 1e9
FLO_UNKNOWN_FLOW = 1e10


# ---------------------------------------------------------------------------
# .flo
# ---------------------------------------------------------------------------

def read_flo(filepath: str) -> np.ndarray:
    """Read a Middlebury .flo file → float32 array (H, W, 2), unknown → NaN.

    Layout per `flow_IO.py:52-113`: 4-byte tag 202021.25, int32 width, int32
    height, then interleaved little-endian float32 (u, v) in row order.
    """
    with open(filepath, "rb") as f:
        data = f.read()
    if len(data) < 12:
        raise IOError(f"read flo file({filepath}): file too short")
    tag = struct.unpack("<f", data[0:4])[0]
    if tag != FLO_TAG_FLOAT:
        raise IOError(f"read flo file({filepath}): wrong tag (big-endian file?)")
    width = struct.unpack("<i", data[4:8])[0]
    height = struct.unpack("<i", data[8:12])[0]
    if not (1 <= width <= 99999):
        raise IOError(f"read flo file({filepath}): illegal width {width}")
    if not (1 <= height <= 99999):
        raise IOError(f"read flo file({filepath}): illegal height {height}")
    expected = height * width * 2 * 4
    if len(data) - 12 < expected:
        raise IOError(f"read flo file({filepath}): file is too short")
    if len(data) - 12 > expected:
        raise IOError(f"read flo file({filepath}): file is too long")
    flow = np.frombuffer(data, dtype="<f4", offset=12).reshape(height, width, 2)
    flow = flow.astype(np.float32).copy()
    flow[np.abs(flow) > FLO_UNKNOWN_FLOW_THRESH] = np.nan
    return flow


def write_flo(flow: np.ndarray, filepath: str) -> None:
    """Write float32 (H, W, 2) to .flo; NaN → 1e10 (`flow_IO.py:116-159`)."""
    height, width, bands = flow.shape
    if bands != 2:
        raise IOError(f"write flo file {filepath}: expected (H, W, 2), got {flow.shape}")
    data = np.ascontiguousarray(flow, dtype="<f4").copy()
    data[np.isnan(data)] = FLO_UNKNOWN_FLOW
    with open(filepath, "wb") as f:
        f.write(FLO_TAG_STRING)
        f.write(struct.pack("<i", width))
        f.write(struct.pack("<i", height))
        f.write(data.tobytes())


# ---------------------------------------------------------------------------
# KITTI 16-bit png
# ---------------------------------------------------------------------------

def read_kitti_png(filepath: str) -> np.ndarray:
    """Read a KITTI flow png → float32 (H, W, 2), invalid → NaN.

    Encoding per `flow_IO.py:162-182`: 16-bit RGB png where
    channel0=u*64+2^15, channel1=v*64+2^15, channel2=valid.
    """
    import cv2

    raw = cv2.imread(filepath, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise IOError(f"read kitti png({filepath}): could not read file")
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR → RGB
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2.0**15) / 64.0
    flow[valid == 0] = np.nan
    return flow


def read_kitti_png_with_valid(filepath: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a KITTI flow png → (flow (H,W,2) float32 with invalid=0, valid (H,W)).

    This is the dataloader-facing variant matching `frame_utils.py:138-143`
    (readFlowKITTI), which keeps invalid flow at its decoded value and returns
    the valid mask separately.
    """
    import cv2

    raw = cv2.imread(filepath, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise IOError(f"read kitti png({filepath}): could not read file")
    raw = raw[:, :, ::-1].astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2.0**15) / 64.0
    return flow, valid


def write_kitti_png(flow: np.ndarray, filepath: str) -> None:
    """Write float32 (H, W, 2) as KITTI 16-bit png; NaN → invalid (`flow_IO.py:185-200`)."""
    import cv2

    uv = 64.0 * flow + 2.0**15
    valid = np.ones(flow.shape[:2] + (1,), dtype=np.float64)
    nan_mask = np.isnan(flow[:, :, 0]) | np.isnan(flow[:, :, 1])
    valid[nan_mask] = 0
    uv = np.nan_to_num(uv)
    out = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(filepath, out[:, :, ::-1])


# ---------------------------------------------------------------------------
# .pfm
# ---------------------------------------------------------------------------

def read_pfm(filepath: str) -> np.ndarray:
    """Read a PFM file (`frame_utils.py:69-104`)."""
    with open(filepath, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise IOError(f"read pfm({filepath}): not a PFM file")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim_match:
            raise IOError(f"read pfm({filepath}): malformed header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape))


# ---------------------------------------------------------------------------
# Generic readers
# ---------------------------------------------------------------------------

def read_npy(filepath: str) -> np.ndarray:
    return np.load(filepath)


def write_npy(arr: np.ndarray, filepath: str) -> None:
    np.save(filepath, arr)


def read_flow(filepath: str) -> np.ndarray:
    """Dispatch by extension: .flo | .png (KITTI) | .npy (`flow_IO.py:11-25`)."""
    if filepath.endswith(".flo"):
        return read_flo(filepath)
    if filepath.endswith(".png"):
        return read_kitti_png(filepath)
    if filepath.endswith(".npy"):
        return read_npy(filepath)
    raise ValueError(f"read_flow: unknown file format for {filepath}")


def write_flow(flow: np.ndarray, filepath: str) -> None:
    """Dispatch by extension (`flow_IO.py:28-49`)."""
    if not filepath:
        raise ValueError("write_flow: empty filepath")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise IOError(f"write_flow {filepath}: expected (H, W, 2), got {flow.shape}")
    if filepath.endswith(".flo"):
        return write_flo(flow, filepath)
    if filepath.endswith(".png"):
        return write_kitti_png(flow, filepath)
    if filepath.endswith(".npy"):
        return write_npy(flow, filepath)
    raise ValueError(f"write_flow: unknown file format for {filepath}")


def read_image(filepath: str) -> np.ndarray:
    """Read an image file → uint8 (H, W, 3). Grayscale is tiled to 3 channels
    (matches `datasets.py:80-86`)."""
    from PIL import Image

    img = np.asarray(Image.open(filepath)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    else:
        img = img[..., :3]
    return img


def read_gen(filepath: str):
    """Generic reader by extension, mirroring `frame_utils.py:159-173`."""
    ext = os.path.splitext(filepath)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        from PIL import Image

        return Image.open(filepath)
    if ext in (".bin", ".raw", ".npy", ".npz"):
        return np.load(filepath)
    if ext == ".flo":
        return np.nan_to_num(read_flo(filepath)).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(filepath).astype(np.float32)
        if flow.ndim == 2:
            return flow
        return flow[:, :, :-1]
    return []
