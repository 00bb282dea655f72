"""The port's host side against `pcfa_tpu`'s on the CPU: flow-file IO in
both directions, error measures, color plots, synthetic samples, the
Sintel and KITTI file datasets, the loader, `process_shard`, the tracker
and its artifacts (the PNG writer's pixels decoded by PIL against the JAX
package's PNGs), the profiling hooks and custom targets. Inputs are
seeded with numpy; results are equal bit for bit unless a case says
otherwise.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from pcfa_tpu import config as jconfig
from pcfa_tpu.attack import targets as jtargets
from pcfa_tpu.data import datasets as jdatasets
from pcfa_tpu.data import flow_datasets as jflow_datasets
from pcfa_tpu.data import loader as jloader
from pcfa_tpu.data import synthetic as jsynthetic
from pcfa_tpu.io import flow_io as jio
from pcfa_tpu.metrics import flow_errors as jerr
from pcfa_tpu.parallel import multihost as jmultihost
from pcfa_tpu.utils import tracking as jtracking
from pcfa_tpu.viz import flow_plot as jplot
from pcfa_tpu.viz import quickvis as jquickvis
from pcfa_tpu_torch import config
from pcfa_tpu_torch.attack import targets
from pcfa_tpu_torch.data import datasets, flow_datasets, loader, synthetic
from pcfa_tpu_torch.io import flow_io
from pcfa_tpu_torch.metrics import flow_errors as err
from pcfa_tpu_torch.parallel import multihost
from pcfa_tpu_torch.utils import profiling, tracking
from pcfa_tpu_torch.viz import flow_plot, quickvis


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while this module runs: the suite runs a
    pytest worker per core, and torch's default of a thread per core makes
    the workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flow(rng, h=9, w=13, nan=True):
    f = (rng.standard_normal((h, w, 2)) * 5).astype(np.float32)
    if nan:
        f[1, 2, :] = np.nan
        f[4, 5, 1] = np.nan
    return f


def _png_pixels(p):
    return np.asarray(Image.open(p))


# ------------------------------------------------------------------ IO ---

@pytest.mark.parametrize("ext", [".flo", ".png", ".npy"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flow_io_round_trips_across_packages(tmp_path, rng, ext, writer):
    """A flow file written by one package reads the same in both, NaN
    (unknown / KITTI-invalid) pixels included."""
    flow = _flow(rng)
    if ext == ".png":
        flow = np.round(flow * 64) / 64    # KITTI stores 1/64 px
    path = str(tmp_path / f"f{ext}")
    (jio if writer == "jax" else flow_io).write_flow(flow, path)
    got, want = flow_io.read_flow(path), jio.read_flow(path)
    np.testing.assert_array_equal(got, want)
    unknown = np.isnan(flow)
    if ext == ".png":       # KITTI marks a whole pixel invalid
        unknown = unknown.any(-1, keepdims=True).repeat(2, -1)
    np.testing.assert_array_equal(np.isnan(got), unknown)
    np.testing.assert_array_equal(got[~unknown], flow[~unknown])
    if ext != ".png":       # `read_gen` opens a .png as an image
        np.testing.assert_array_equal(flow_io.read_gen(path),
                                      jio.read_gen(path))


def test_kitti_png_valid_mask_and_pfm_match_jax(tmp_path, rng):
    flow = np.round(_flow(rng) * 64) / 64
    path = str(tmp_path / "k.png")
    flow_io.write_kitti_png(flow, path)
    (f1, v1), (f2, v2) = (m.read_kitti_png_with_valid(path)
                          for m in (flow_io, jio))
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(v1 == 0, np.isnan(flow).any(-1))
    # a little-endian colour PFM, rows stored bottom-up
    data = rng.standard_normal((4, 5, 3)).astype("<f4")
    pfm = tmp_path / "x.pfm"
    pfm.write_bytes(b"PF\n5 4\n-1.0\n" + np.flipud(data).tobytes())
    np.testing.assert_array_equal(flow_io.read_pfm(str(pfm)), data)
    np.testing.assert_array_equal(flow_io.read_gen(str(pfm)),
                                  jio.read_gen(str(pfm)))
    with pytest.raises(ValueError):
        flow_io.read_flow(str(tmp_path / "x.txt"))


# ------------------------------------------------------------- metrics ---

def test_error_measures_match_jax(rng):
    flow, gt = _flow(rng, 20, 30), _flow(rng, 20, 30)
    gt[0, :4] = 0.0
    flow[0, :4] = 40.0      # bad pixels under both rules
    for name in ("compute_AAE", "compute_AEE", "compute_BP", "compute_Fl"):
        assert getattr(err, name)(flow, gt) == getattr(jerr, name)(flow, gt)
    np.testing.assert_array_equal(err.compute_EE(flow, gt),
                                  jerr.compute_EE(flow, gt))
    assert err.get_all_error_measures(flow, gt) == \
        jerr.get_all_error_measures(flow, gt)
    area = rng.random((20, 30)) > 0.5
    assert err.get_all_error_measures_area(flow, gt, area) == \
        jerr.get_all_error_measures_area(flow, gt, area)


# ---------------------------------------------------------------- viz ---

@pytest.mark.parametrize("plot", ["light", "light_fixed", "dark", "log",
                                  "loglog", "error", "error_fl"])
def test_color_plots_match_jax(rng, plot):
    flow, gt = _flow(rng, 16, 24), _flow(rng, 16, 24)

    def call(mod):
        if plot == "light":
            return mod.colorplot_light(flow, return_max=True)
        if plot == "light_fixed":
            return mod.colorplot_light(flow, auto_scale=False, max_scale=3.0)
        if plot == "dark":
            return mod.colorplot_dark(flow)
        if plot in ("log", "loglog"):
            return mod.colorplot_dark(flow, transform=plot)
        if plot == "error":
            return mod.errorplot(flow, gt)
        return mod.errorplot_Fl(flow, gt)

    got, want = call(flow_plot), call(jplot)
    if plot == "light":
        assert got[1] == want[1]
        got, want = got[0], want[0]
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(flow_plot.middlebury_colorwheel(),
                                  jplot.middlebury_colorwheel())


# ---------------------------------------------------------------- data ---

@pytest.mark.parametrize("has_gt", [True, False])
def test_synthetic_samples_match_jax(has_gt):
    kw = dict(num_samples=3, size=(24, 40), max_shift=5, seed=11,
              has_gt=has_gt)
    a, b = synthetic.SyntheticDataset(**kw), jsynthetic.SyntheticDataset(**kw)
    assert len(a) == len(b) and a.has_groundtruth() == b.has_groundtruth()
    for i in range(3):
        for x, y in zip(a[i], b[i]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(IndexError):
        a[3]


def _save_rgb(path, arr):
    Image.fromarray(arr.astype(np.uint8)).save(path)


def _sintel_tree(root, rng):
    scene = root / "training" / "clean" / "alley_9"
    fdir = root / "training" / "flow" / "alley_9"
    scene.mkdir(parents=True)
    fdir.mkdir(parents=True)
    for i in range(1, 4):
        _save_rgb(scene / f"frame_{i:04d}.png",
                  rng.integers(0, 255, (20, 30, 3)))
    for i in range(1, 3):
        f = (rng.standard_normal((20, 30, 2)) * 3).astype(np.float32)
        f[0, 0] = np.nan
        f[1, 1, 0] = 2000.0       # |uv| ≥ 1000 is invalid
        jio.write_flo(f, str(fdir / f"frame_{i:04d}.flo"))


def _kitti_tree(root, rng):
    img = root / "training" / "image_2"
    occ = root / "training" / "flow_occ"
    img.mkdir(parents=True)
    occ.mkdir(parents=True)
    for n in ("000000", "000001"):
        # one frame grayscale: tiled to 3 channels
        shape = (370, 1224) if n == "000001" else (370, 1224, 3)
        for k in ("10", "11"):
            Image.fromarray(rng.integers(0, 255, shape).astype(np.uint8)
                            ).save(img / f"{n}_{k}.png")
        f = rng.uniform(-10, 10, (370, 1224, 2)).astype(np.float32)
        f[7:, :] = np.nan
        jio.write_kitti_png(f, str(occ / f"{n}_10.png"))


@pytest.mark.parametrize("name", ["sintel", "kitti"])
def test_file_datasets_match_jax(tmp_path, rng, name):
    if name == "sintel":
        _sintel_tree(tmp_path, rng)
        kw = dict(split="training", root=str(tmp_path), dstype="clean",
                  has_gt=True)
        a, b = datasets.MpiSintel(**kw), jdatasets.MpiSintel(**kw)
    else:
        _kitti_tree(tmp_path, rng)
        kw = dict(split="training", root=str(tmp_path), has_gt=True)
        a, b = datasets.KITTI(**kw), jdatasets.KITTI(**kw)
    assert len(a) == len(b) == 2
    assert a.extra_info == b.extra_info
    for i in range(2):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)
    if name == "kitti":
        assert a[0][0].shape == (375, 1242, 3) and not a[0][3][7:].any()
    cls = datasets.MpiSintel if name == "sintel" else datasets.KITTI
    with pytest.raises(FileNotFoundError):
        cls(split="training", root=str(tmp_path / "nowhere"))


def test_flow_dataset_getters_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASETS", str(tmp_path))
    for d in ("kitti15/training/image_2", "kitti15/training/flow_occ",
              "kitti15/testing/image_2"):
        (tmp_path / d).mkdir(parents=True)
    assert flow_datasets.getKITTI15Train() == jflow_datasets.getKITTI15Train()
    assert flow_datasets.getKITTI15Test() == jflow_datasets.getKITTI15Test()
    p = "/x/kitti15/training/image_2/000007_10.png"
    assert flow_datasets.findGroundtruth(p) == \
        jflow_datasets.findGroundtruth(p)
    with pytest.raises(ValueError):
        flow_datasets.getTrainDataset("nope")


@pytest.mark.parametrize("batch_size,shuffle,small_run",
                         [(2, True, False), (3, False, True)])
def test_loader_batches_and_order_match_jax(monkeypatch, batch_size,
                                            shuffle, small_run):
    """The Synthetic factory's batches, ragged tail included, and the
    shuffled order over two epochs, against the JAX loader."""
    monkeypatch.setenv("PCFA_SYNTHETIC_COUNT", "5")
    monkeypatch.setenv("PCFA_SYNTHETIC_SIZE", "16x24")
    kw = dict(mode="training", dataset="Synthetic", shuffle=shuffle,
              batch_size=batch_size, small_run=small_run)
    (a, ga), (b, gb) = (loader.prepare_dataloader(**kw),
                        jloader.prepare_dataloader(**kw, process_shard=True))
    assert ga == gb and len(a) == len(b)
    for _ in range(2):
        got, want = list(a), list(b)
        assert len(got) == len(want) == len(a)
        for x, y in zip(got, want):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    for factory in (loader, jloader):
        with pytest.raises(ValueError):
            factory.prepare_dataloader(dataset="Middlebury")


def test_loader_worker_error_raises_and_abandoned_epoch_ends():
    """A failure while decoding a batch raises in the consumer (it does
    not end the epoch quietly); an epoch abandoned after one batch stops
    its prefetch thread."""

    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise OSError("unreadable frame")
            z = np.zeros((2, 2, 3), np.float32)
            return z, z, z[..., :2], z[..., 0]

    before = threading.active_count()
    dl = loader.DataLoader(Broken(), batch_size=2)
    with pytest.raises(OSError, match="unreadable"):
        list(dl)
    first = next(iter(dl))
    assert first[0].shape == (2, 2, 2, 3)
    assert threading.active_count() == before


@pytest.mark.parametrize("rank", [0, 2])
def test_loader_keeps_its_process_shard(monkeypatch, rank):
    """Under a process group of three, each process's loader yields its
    contiguous slice of the dataset, the slice `process_shard` gives."""
    monkeypatch.setenv("PCFA_SYNTHETIC_COUNT", "7")
    monkeypatch.setenv("PCFA_SYNTHETIC_SIZE", "8x12")
    monkeypatch.setattr(multihost, "process_index_and_count",
                        lambda: (rank, 3))
    dl, _ = loader.prepare_dataloader(dataset="Synthetic")
    want = jmultihost.process_shard(7, rank, 3)
    ds = synthetic.SyntheticDataset(num_samples=7, size=(8, 12))
    got = [b[0][0] for b in dl]
    assert len(got) == len(want)
    for x, i in zip(got, want):
        np.testing.assert_array_equal(x, ds[i][0])


@pytest.mark.parametrize("n,count", [(10, 3), (2, 4), (7, 1)])
def test_process_shard_matches_jax(n, count):
    shards = [multihost.process_shard(n, p, count) for p in range(count)]
    assert shards == [jmultihost.process_shard(n, p, count)
                      for p in range(count)]
    assert sum(shards, []) == list(range(n))
    assert multihost.process_shard(n) == list(range(n))   # one process


def test_paths_and_splits_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pcfa_paths.json").write_text(
        json.dumps({"sintel_mpi": "/data/sintel", "kitti15": "/data/k"}))
    monkeypatch.setenv("PCFA_KITTI15_ROOT", "/env/kitti")
    for name in ("sintel_mpi", "kitti15"):
        assert config.paths(name) == jconfig.paths(name)
    assert config.paths("kitti15") == "/env/kitti"
    assert config.SPLITS == jconfig.SPLITS
    assert config.splits("kitti_eval") == jconfig.splits("kitti_eval")


# ---------------------------------------------------- tracker, artifacts ---

@pytest.mark.parametrize("joint,universal,stage",
                         [(False, False, "train"), (True, True, "eval")])
def test_tracker_matches_jax(tmp_path, joint, universal, stage):
    runs = []
    for mod, sub in ((tracking, "port"), (jtracking, "jax")):
        t = mod.Tracker(str(tmp_path / sub), "RAFT", "PCFA", joint,
                        universal, stage=stage, use_mlflow=False)
        with t:
            t.log_params(model="RAFT", optimizer_mu=-1, steps=3)
            t.log_metrics(4, ("aee_pred-tgt", np.float32(1.25)),
                          ("skipped", None), ("steps", 2))
            t.log_metric("l2", np.float64(0.1), 7)
            avgs = t.log_averages(4, ("aee_avg", 3.0), ("none", None))
        runs.append((t, avgs))
    (a, avg_a), (b, avg_b) = runs
    assert a.experiment_name == b.experiment_name
    assert a.folder_name.split("_", 1)[1] == b.folder_name.split("_", 1)[1]
    assert os.path.relpath(a.folder_path, tmp_path / "port").split(
        os.sep)[0] == a.experiment_name
    assert avg_a == avg_b
    for f in ("params.json", "metrics.jsonl"):
        assert open(os.path.join(a.folder_path, f)).read() == \
            open(os.path.join(b.folder_path, f)).read()


def test_save_tensor_bytes_match_jax(tmp_path, rng):
    """NCHW `.npy` artifacts, from numpy arrays and from tensors (bf16 is
    cast to float32), byte for byte as the JAX package writes them."""
    for k, arr in enumerate((rng.random((1, 6, 8, 3)).astype(np.float32),
                             rng.random((6, 8, 2)).astype(np.float32),
                             rng.random((5,)))):
        (tmp_path / "p").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        for src in (arr, torch.from_numpy(arr)):
            p = tracking.save_tensor(src, f"t{k}", 3, str(tmp_path / "p"))
            q = jtracking.save_tensor(arr, f"t{k}", 3, str(tmp_path / "j"))
            assert os.path.basename(p) == os.path.basename(q) == \
                f"00003_t{k}.npy"
            assert open(p, "rb").read() == open(q, "rb").read()
    bf = torch.tensor([[0.5, 1.5]], dtype=torch.bfloat16)
    p = tracking.save_tensor(bf, "bf", 0, str(tmp_path))
    assert np.load(p).dtype == np.float32


@pytest.mark.parametrize("what", ["image", "image_normalized", "delta",
                                  "flow_auto", "flow_scaled", "gray",
                                  "quickvis_flow"])
def test_png_pixels_match_jax(tmp_path, rng, what):
    """The port's `save_image`, `save_flow` and quick views write the same
    PNG files, byte for byte, as the JAX package's."""
    img = rng.random((1, 10, 14, 3)).astype(np.float32)
    flow = _flow(rng, 10, 14)
    out = []
    for mod, sub in ((tracking, "port"), (jtracking, "jax")):
        d = tmp_path / sub
        d.mkdir()
        vis = quickvis if mod is tracking else jquickvis
        if what == "image":
            p = mod.save_image(img, 2, str(d), image_name="image1")
        elif what == "image_normalized":
            p = mod.save_image(img[0] - 0.5, 2, str(d), normalize_max=0.3)
        elif what == "delta":
            p = mod.save_image(img * 255.0, 2, str(d), unit_input=False)
        elif what == "flow_auto":
            p = mod.save_flow(flow[None], 2, str(d))
        elif what == "flow_scaled":
            p = mod.save_flow(flow, 2, str(d), auto_scale=False,
                              max_scale=2.0)
        elif what == "gray":
            p = str(d / "q.png")
            vis.quickvis_tensor((img[0, ..., :1] * 255).repeat(3, -1), p)
        else:
            p = str(d / "f.png")
            vis.quickvis_flow(flow[None], p, auto_scale=False, max_scale=3.0)
        out.append(p)
    a, b = _png_pixels(out[0]), _png_pixels(out[1])
    assert os.path.basename(out[0]) == os.path.basename(out[1])
    assert a.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert open(out[0], "rb").read() == open(out[1], "rb").read()


def test_quickvis_flow_batches_match_jax(tmp_path, rng):
    flow = np.stack([_flow(rng, 8, 10), _flow(rng, 8, 10)])
    quickvis.quickvisualization_flow(flow, str(tmp_path / "p" / "f.png"))
    jquickvis.quickvisualization_flow(flow, str(tmp_path / "j" / "f.png"))
    for name in ("f.png", "f.png_1.png"):
        np.testing.assert_array_equal(_png_pixels(tmp_path / "p" / name),
                                      _png_pixels(tmp_path / "j" / name))
    assert tracking.max_flow_length(None, torch.from_numpy(flow)) == \
        jtracking.max_flow_length(None, flow)


def test_profiling_hooks(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(3).sum()
    assert json.loads((tmp_path / "trace.json").read_text())
    timer = profiling.StepTimer()
    with timer.step():
        torch.ones(2)
    assert timer.fenced(torch.add, torch.ones(1), 1).item() == 2.0
    assert timer.summary()["steps"] == 2
    x = torch.tensor([-1.0], requires_grad=True)
    with profiling.debug_nans(), pytest.raises(RuntimeError, match="nan"):
        torch.sqrt(x).sum().backward()


# ------------------------------------------------------------- targets ---

@pytest.mark.parametrize("fmt", ["flo", "npy_chw", "npy_nchw"])
def test_custom_target_matches_jax(tmp_path, rng, fmt):
    """`make_target_fn("custom", path)` reads the file once and fits it
    (crop or reflect-pad) to the prediction, as the JAX package does."""
    tgt = _flow(rng, 7, 9, nan=False)
    path = str(tmp_path / f"t.{fmt[:3]}")
    if fmt == "flo":
        jio.write_flo(tgt, path)
    elif fmt == "npy_chw":
        np.save(path, tgt.transpose(2, 0, 1))
    else:
        np.save(path, tgt.transpose(2, 0, 1)[None])
    np.testing.assert_array_equal(targets.load_custom_target(path),
                                  jtargets.load_custom_target(path))
    for hw in ((5, 12), (10, 4)):
        flow = rng.standard_normal((2, *hw, 2)).astype(np.float32)
        got = targets.make_target_fn("custom", path)(torch.from_numpy(flow))
        want = jtargets.make_target_fn("custom", path)(jnp.asarray(flow))
        assert got.shape == flow.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((3, 4, 5), np.float32))
    with pytest.raises(ValueError):
        targets.load_custom_target(bad)
