"""Inputs of the encode kernels: the table gradient (K2+K5 at F=4, K4 at
F=2) and the encode forward (K1 at F=4, K3 at F=2).

Two kinds, both timed by chip_smoke.py and `kernel_ab`:
- random points: `random_input`, uniform points with N(0, 1e-3) gradient
  rows, the table gradient's input since it was ported, and `random_x`, the
  uniform points the encode forward has been timed on;
- `capture`: the (x, g, w1) that `hash_encode_bwd` receives in one train
  step of a `NeRFSystem`: the CSR pool's positions in [0, 1]^3, a ray's
  samples in consecutive slots, and their h1 gradients, with zero rows on
  the unused slots and past early termination.  The same x went through
  the encode forward of that step.  `fitted_train_input` takes it after a
  fit, as the train path sees it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ngp_pl_torch.benchmarking.train_setup import train_system

RANDOM_N = 262144


def random_input(n: int = RANDOM_N, seed: int = 3,
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n, 3) uniform in [0, 1)^3 and g (n, 64) N(0, 1e-3), drawn on the
    CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=gen)
    g = torch.randn((n, 64), generator=gen) * 1e-3
    return x.to(device), g.to(device)


def random_x(n: int = RANDOM_N, seed: int = 1, device="cuda") -> torch.Tensor:
    """x (n, 3) uniform in [0, 1)^3, drawn on the CPU from `seed`: the
    encode forward's random input."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3), generator=gen).to(device)


def capture(system) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Copies of the (x, g, w1) that `hash_encode_bwd` receives in the next
    `system.step()`, which runs as usual (a grid refresh first at an
    interval boundary)."""
    from ngp_pl_torch.ops import hash_encoding as he

    seen = []
    real = he.hash_encode_bwd

    def spy(x, g, w1, spec):
        if not seen:
            seen.append((x.clone(), g.clone(), w1.clone()))
        return real(x, g, w1, spec)

    he.hash_encode_bwd = spy
    try:
        system.step()
    finally:
        he.hash_encode_bwd = real
    if not seen:
        raise RuntimeError("the train step did not reach hash_encode_bwd")
    return seen[0]


def fitted_system(tcfg=None, steps: int = 512):
    """A seeded system on the card after `NeRFSystem.fit` of `steps`
    steps."""
    system = train_system(tcfg)
    system.fit(max_steps=steps, log_every=steps, quiet=True)
    return system


def fitted_train_input(tcfg=None, steps: int = 512):
    """`capture` after `fitted_system`: (x, g, w1, spec)."""
    system = fitted_system(tcfg, steps)
    x, g, w1 = capture(system)
    return x, g, w1, system.ngp.spec
