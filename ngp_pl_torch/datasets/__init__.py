"""Dataset registry of the port (reference datasets/__init__.py).  The render
slice covers the procedural synthetic scene; the disk loaders are a later
slice."""
from ngp_pl_torch.datasets.synthetic import SyntheticDataset

dataset_dict = {"synthetic": SyntheticDataset}
