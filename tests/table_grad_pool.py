"""A small train pool for the table-gradient tests: the (x, g, w1) that the
port's own train step hands `hash_encode_bwd` on the CPU (grid 32, L=4,
T=2^12, 128 rays, pool x32), through a sparse occupancy grid (3% of cells,
numpy seeded).  A ray's samples sit in consecutive slots and fall in few
cells of the coarse levels; about half the slots are unused, with zero
gradient rows.  Imports no JAX, so the card-only tests can use it."""
import dataclasses

import numpy as np
import torch

from ngp_pl_torch.benchmarking import table_grad_inputs as tgi
from ngp_pl_torch.benchmarking.train_setup import train_system
from ngp_pl_torch.config import TrainConfig
from ngp_pl_torch.ops.ray_march import occupancy_windows

G = 32


@dataclasses.dataclass(frozen=True)
class SmallTrainConfig(TrainConfig):
    """The CPU tests' model: grid 32 (L and T are set per call)."""

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


def train_pool(F: int, seed: int = 0):
    """(x, g, w1, spec) of one train step of a seeded system with F
    features per level; the step runs mid-interval, so it marches the
    sparse grid set here rather than refreshing it."""
    tcfg = SmallTrainConfig(batch_size=128, n_levels=4, n_features=F,
                            log2_hashmap_size=12, num_epochs=1)
    system = train_system(tcfg, dev="cpu", img_size=24, n_train=2)
    occ = (np.random.default_rng(seed).random((1, G, G, G)) < 0.03)
    system.grid_state.occ_grid = torch.from_numpy(occ.astype(np.uint8))
    system.grid_state.win_rows = occupancy_windows(
        system.grid_state.occ_grid)
    system._host_step = 1
    x, g, w1 = tgi.capture(system)
    return x, g, w1, system.ngp.spec
