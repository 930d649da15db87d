"""The flagship's training setup on bench.py's scene (8 views at 96x96,
batch 8192), or another geometry: what chip_smoke.py trains, and what the
benchmarks and tests take their train inputs from."""
from __future__ import annotations


def train_config(**kw):
    """The flagship's train configuration on bench.py's scene (batch 8192,
    the 30-epoch cosine, the CSR layout, so that readings stay comparable
    across revisions); `kw` changes the geometry, the layout or the flags
    (`use_exposure`, `optimize_ext`)."""
    from ngp_pl_torch.config import TrainConfig

    return TrainConfig(**{"dataset_name": "synthetic", "batch_size": 8192,
                          "num_epochs": 30, "train_layout": "csr", **kw})


def train_system(tcfg=None, dev="cuda", img_size=96, n_train=8):
    """A seeded NeRFSystem of the flagship model (or of `tcfg`) on bench.py's
    scene (8 views at 96x96)."""
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    tcfg = tcfg or train_config()
    return NeRFSystem(
        tcfg, device=dev,
        train_dataset=SyntheticDataset(split="train", img_size=img_size,
                                       n_train=n_train, device=dev),
        test_dataset=SyntheticDataset(split="test", img_size=img_size,
                                      n_test=1, device=dev))
