"""Dataset registry of the port (counterpart of
ngp_pl_tpu/datasets/__init__.py; reference datasets/__init__.py): the five
disk formats and the procedural synthetic scene.  Every class takes
(root_dir, split, downsample, device, **kwargs)."""
from ngp_pl_torch.datasets.colmap import ColmapDataset
from ngp_pl_torch.datasets.nerf import NeRFDataset
from ngp_pl_torch.datasets.nerfpp import NeRFPPDataset
from ngp_pl_torch.datasets.nsvf import NSVFDataset
from ngp_pl_torch.datasets.rtmv import RTMVDataset
from ngp_pl_torch.datasets.synthetic import SyntheticDataset

dataset_dict = {
    "nerf": NeRFDataset,
    "nsvf": NSVFDataset,
    "colmap": ColmapDataset,
    "nerfpp": NeRFPPDataset,
    "rtmv": RTMVDataset,
    "synthetic": SyntheticDataset,
}
