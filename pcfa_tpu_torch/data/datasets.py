"""Dataset indexers for MPI Sintel and KITTI 2015 (numpy, channels-last).

The port's own copy of `pcfa_tpu/data/datasets.py`: plain indexable
objects returning numpy arrays, consumed by the batching loader in
`data/loader.py`.

Sample layout (vs reference NCHW tensors): images float32 (H, W, 3) in
[0, 255]; flow float32 (H, W, 2); valid float32 (H, W) (1.0 where GT valid).
When a dataset has no GT, flow is zeros and valid is all-zero
(`datasets.py:104-110`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob

import numpy as np

from pcfa_tpu_torch.io import read_image
from pcfa_tpu_torch.io.flow_io import read_flo, read_kitti_png_with_valid


@dataclass
class FlowSample:
    image1: np.ndarray
    image2: np.ndarray
    flow: np.ndarray
    valid: np.ndarray
    meta: tuple


class _FileFlowDataset:
    """Shared image-pair/GT loading (`datasets.py:64-131`)."""

    def __init__(self, sparse: bool = False, has_gt: bool = False):
        self.sparse = sparse
        self.has_gt = has_gt
        self.image_list: list[list[str]] = []
        self.flow_list: list[str] = []
        self.extra_info: list = []
        # KITTI-style fixed output dims (`datasets.py:115-128,185-187`)
        self.enforce_dimensions: tuple[int, int] | None = None

    def has_groundtruth(self) -> bool:
        return self.has_gt

    def __len__(self) -> int:
        return len(self.image_list)

    def _load_images(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        img1 = read_image(self.image_list[index][0]).astype(np.uint8)
        img2 = read_image(self.image_list[index][1]).astype(np.uint8)
        if img1.ndim == 2:  # grayscale → 3-channel (`datasets.py:81-83`)
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1, img2 = img1[..., :3], img2[..., :3]
        return img1.astype(np.float32), img2.astype(np.float32)

    def __getitem__(self, index: int):
        index = index % len(self.image_list)
        img1, img2 = self._load_images(index)

        if self.has_gt:
            if self.sparse:
                flow, valid = read_kitti_png_with_valid(self.flow_list[index])
            else:
                flow = read_flo(self.flow_list[index])
                # .flo unknown pixels read as nan; the reference keeps raw
                # values and masks |uv| >= 1000 (`datasets.py:102`)
                valid = (
                    (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
                )
            flow = np.nan_to_num(flow.astype(np.float32))
            valid = valid.astype(np.float32)
        else:
            flow = np.zeros(img1.shape[:2] + (2,), np.float32)
            valid = np.zeros(img1.shape[:2], np.float32)

        if self.enforce_dimensions is not None:
            H, W = self.enforce_dimensions
            dy, dx = H - img1.shape[0], W - img1.shape[1]

            def zpad(a):
                widths = ((0, dy), (0, dx)) + ((0, 0),) * (a.ndim - 2)
                return np.pad(a, widths)

            img1, img2, flow, valid = map(zpad, (img1, img2, flow, valid))

        return img1, img2, flow, valid


class MpiSintel(_FileFlowDataset):
    """`<root>/<split>/<dstype>/<scene>/*.png` consecutive pairs with
    `flow/<scene>/*.flo` GT (`datasets.py:146-164`)."""

    def __init__(self, split="training", root="", dstype="clean", has_gt=False):
        super().__init__(sparse=False, has_gt=has_gt)
        flow_root = os.path.join(root, split, "flow")
        image_root = os.path.join(root, split, dstype)
        if not os.path.isdir(image_root):
            raise FileNotFoundError(
                f"No MPI Sintel data found at dataset root '{root}'. Set "
                "PCFA_SINTEL_ROOT or pcfa_paths.json."
            )
        for scene in sorted(os.listdir(image_root)):
            image_list = sorted(glob(os.path.join(image_root, scene, "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list.append([image_list[i], image_list[i + 1]])
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list += sorted(
                    glob(os.path.join(flow_root, scene, "*.flo"))
                )


class KITTI(_FileFlowDataset):
    """`image_2/*_10.png` + `*_11.png` pairs, `flow_occ/*_10.png` sparse GT,
    all frames zero-padded to 375×1242 (`datasets.py:167-190`)."""

    def __init__(self, split="training", root="", has_gt=False):
        super().__init__(sparse=True, has_gt=has_gt)
        root = os.path.join(root, split)
        images1 = sorted(glob(os.path.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(os.path.join(root, "image_2/*_11.png")))
        if not images1:
            raise FileNotFoundError(
                f"No KITTI data found at dataset root '{root}'. Set "
                "PCFA_KITTI15_ROOT or pcfa_paths.json."
            )
        for img1, img2 in zip(images1, images2):
            self.extra_info.append([os.path.basename(img1)])
            self.image_list.append([img1, img2])
        if has_gt:
            self.flow_list = sorted(glob(os.path.join(root, "flow_occ/*_10.png")))
        self.enforce_dimensions = (375, 1242)
