"""$DATASETS-rooted path indexers for standard optical-flow benchmarks.

The port's own copy of `pcfa_tpu/data/flow_datasets.py`.

Rebuild of `flow_library/flow_datasets.py:46-333`: list image/GT-flow file
paths for middlebury / kitti12 / kitti15 / mpi_sintel as
`{sequence: {"images": [...], "flows": [...]}}` dictionaries, rooted at the
`$DATASETS` environment variable, with train/test splits, a completeness
checker, and ground-truth auto-discovery from a flow-file path.
"""

from __future__ import annotations

import os
import re

SUPPORTED_DATASETS = ["middlebury", "kitti12", "kitti15", "mpi_sintel"]

SINTEL_TRAIN_SEQUENCES = [
    "alley_1", "alley_2", "ambush_2", "ambush_4", "ambush_5", "ambush_6",
    "ambush_7", "bamboo_1", "bamboo_2", "bandage_1", "bandage_2", "cave_2",
    "cave_4", "market_2", "market_5", "market_6", "mountain_1", "shaman_2",
    "shaman_3", "sleeping_1", "sleeping_2", "temple_2", "temple_3",
]
SINTEL_TRAIN_FRAME_COUNTS = [
    50, 50, 21, 33, 50, 20, 50, 50, 50, 50, 50, 50, 50, 50, 50, 40, 50, 50,
    50, 50, 50, 50, 50,
]
SINTEL_TEST_SEQUENCES = [
    "ambush_1", "ambush_3", "bamboo_3", "cave_3", "market_1", "market_4",
    "mountain_2", "PERTURBED_market_3", "PERTURBED_shaman_1", "temple_1",
    "tiger", "wall",
]
SINTEL_TEST_IMG_COUNTS = [23, 41, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50]

MIDDLEBURY_SEQUENCES = [
    "Dimetrodon", "Grove2", "Grove3", "Hydrangea", "RubberWhale", "Urban2",
    "Urban3", "Venus",
]


def _dataset_root(name: str) -> str:
    base = os.getenv("DATASETS")
    if base is None:
        raise ValueError("DATASET environment variable not set")
    return os.path.join(base, name)


def getTrainDataset(dataset_name, sintel_imagetype=None,
                    kitti_flowtype="flow_occ"):
    """Training split with GT flow paths (`flow_datasets.py:46-175`)."""
    if dataset_name not in SUPPORTED_DATASETS:
        raise ValueError(
            f"Dataset {dataset_name} currently not supported. Please choose "
            "one of: " + ", ".join(SUPPORTED_DATASETS)
        )
    if kitti_flowtype not in ("flow_noc", "flow_occ"):
        raise ValueError("kitti_flowtype must be flow_noc or flow_occ!")
    if dataset_name == "mpi_sintel" and sintel_imagetype not in ("final", "clean"):
        raise ValueError("sintel_imagetype must be final or clean!")

    root = _dataset_root(dataset_name)
    if not os.path.exists(root):
        raise IOError("Dataset basepath does not exist:", root)

    result: dict = {}

    if dataset_name == "middlebury":
        base = os.path.join(root, "training")
        for seq in MIDDLEBURY_SEQUENCES:
            result[seq] = {
                "images": [os.path.join(base, seq, f"frame{f:02d}.png")
                           for f in (10, 11)],
                "flows": [os.path.join(base, seq, "flow10.flo")],
            }
    elif dataset_name in ("kitti12", "kitti15"):
        img_dir = "image_0" if dataset_name == "kitti12" else "image_2"
        n = 194 if dataset_name == "kitti12" else 200
        ibase = os.path.join(root, "training", img_dir)
        fbase = os.path.join(root, "training", kitti_flowtype)
        for i in range(n):
            seq = f"{i:06d}"
            result[seq] = {
                "images": [os.path.join(ibase, f"{seq}_{f}.png")
                           for f in (10, 11)],
                "flows": [os.path.join(fbase, f"{seq}_10.png")],
            }
    else:  # mpi_sintel
        ibase = os.path.join(root, "training", sintel_imagetype)
        fbase = os.path.join(root, "training", "flow")
        for seq, count in zip(SINTEL_TRAIN_SEQUENCES,
                              SINTEL_TRAIN_FRAME_COUNTS):
            result[seq] = {
                "images": [os.path.join(ibase, seq, f"frame_{f:04d}.png")
                           for f in range(1, count + 1)],
                "flows": [os.path.join(fbase, seq, f"frame_{f:04d}.flo")
                          for f in range(1, count)],
            }

    for key in ("images", "flows"):
        path = result[next(iter(result))][key][0]
        if not os.path.exists(os.path.dirname(path)):
            raise IOError("path does not exist:", os.path.dirname(path))
    return result


def getSintelTrain(sintel_imagetype):
    return getTrainDataset("mpi_sintel", sintel_imagetype=sintel_imagetype)


def getSintelTrainClean():
    return getTrainDataset("mpi_sintel", sintel_imagetype="clean")


def getSintelTrainFinal():
    return getTrainDataset("mpi_sintel", sintel_imagetype="final")


def getKITTI15Train(kitti_flowtype="flow_occ"):
    return getTrainDataset("kitti15", kitti_flowtype=kitti_flowtype)


def getKITTI12Train(kitti_flowtype="flow_occ"):
    return getTrainDataset("kitti12", kitti_flowtype=kitti_flowtype)


def getSintelTest(sintel_imagetype):
    """Test split, images only (`flow_datasets.py:201-232`)."""
    if sintel_imagetype not in ("clean", "final"):
        raise ValueError("sintel_imagetype must be clean or final!")
    base = os.path.join(_dataset_root("mpi_sintel"), "test", sintel_imagetype)
    if not os.path.exists(base):
        raise IOError("Path does not exist:", base)
    result = {}
    for seq, count in zip(SINTEL_TEST_SEQUENCES, SINTEL_TEST_IMG_COUNTS):
        result[seq] = {
            "images": [os.path.join(base, seq, f"frame_{f:04d}.png")
                       for f in range(1, count + 1)],
            "flows": [],
        }
    return result


def getSintelTestClean():
    return getSintelTest("clean")


def getSintelTestFinal():
    return getSintelTest("final")


def _kitti_test(name: str, img_dir: str, n: int):
    base = os.path.join(_dataset_root(name), "testing", img_dir)
    if not os.path.exists(base):
        raise IOError("Path does not exist:", base)
    return {
        f"{i:06d}": {
            "images": [os.path.join(base, f"{i:06d}_{f}.png") for f in (10, 11)],
            "flows": [],
        }
        for i in range(n)
    }


def getKITTI15Test():
    return _kitti_test("kitti15", "image_2", 200)


def getKITTI12Test():
    return _kitti_test("kitti12", "image_0", 195)


def testDatasetCompleteness(dataset) -> list[str]:
    """Report files missing on disk (`flow_datasets.py:259-271`)."""
    missing = []
    for content in dataset.values():
        for kind in ("flows", "images"):
            for p in content[kind]:
                if not os.path.exists(p):
                    print(f"{kind[:-1].capitalize()} file does not exist", p)
                    missing.append(p)
    return missing


def findGroundtruth(filepath: str) -> str | None:
    """GT auto-discovery from a file path (`flow_datasets.py:272-303`)."""
    for seq in SINTEL_TRAIN_SEQUENCES:
        if seq in filepath:
            m = re.search(r"frame_(\d\d\d\d)", filepath)
            if m:
                frame = int(m.group(1))
                return getSintelTrainClean()[seq]["flows"][frame - 1]
            return None
    lowered = filepath.lower()
    for tag, getter in (("kitti15", getKITTI15Train),
                        ("kitti12", getKITTI12Train)):
        if any(t in lowered for t in (tag, tag[:5] + "_" + tag[5:],
                                      tag[:5] + "-" + tag[5:])):
            m = re.search(r"(\d\d\d\d\d\d)_10", filepath)
            if m:
                return getter()[m.group(1)]["flows"][0]
    return None
