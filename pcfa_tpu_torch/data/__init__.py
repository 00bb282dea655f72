"""Data layer (`pcfa_tpu/data`): dataset indexers, synthetic data and the
input pipeline, numpy on the host; the CLIs move each batch to the card."""

from pcfa_tpu_torch.data.synthetic import SyntheticDataset
from pcfa_tpu_torch.data.datasets import KITTI, FlowSample, MpiSintel
from pcfa_tpu_torch.data.loader import DataLoader, prepare_dataloader
