"""On the card only: the CSR compositor's segment prefix
(`segment_excl_cumsum`) and the compositor through it, on a pool whose
optical depths sum to ~1.8e5, as a trained field's batch does, against the
same functions on the CPU.

The global prefix is accumulated in float64 on either device and rounded
once to float32, so a local depth (the difference of two prefixes) misses
the exact one by at most two float32 ulps of the total, and the card
agrees with the CPU to that.  CUDA's float32 cumsum, what the compositor
used before, misses by several ulps more; each test shows that it fails
the same limit on the same pool.

    python -m pytest -m cuda --noconftest tests/test_torch_prefix_cuda.py
"""
import numpy as np
import pytest
import torch

from ngp_pl_torch.ops import volume_render as vr

P = 1 << 20                # pool slots
N_RAYS = 40_000            # segments of 1-48 slots; the tail is unused


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _pool(seed=0):
    """(x, offsets, ray_idx, valid): depths U(0, 0.35) in the used slots
    (sum ~1.8e5), 0 in the unused tail, numpy seeded."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 49, N_RAYS)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    used = int(lens.sum())
    assert used < P
    ray_idx = np.full(P, N_RAYS, np.int64)
    ray_idx[:used] = np.repeat(np.arange(N_RAYS), lens)
    valid = np.arange(P) < used
    x = np.where(valid, rng.uniform(0.0, 0.35, P), 0.0).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(offsets),
            torch.from_numpy(ray_idx), torch.from_numpy(valid))


def _exact(x, offsets, ray_idx):
    """Local exclusive depths in float64 from the float32 depths."""
    c = np.cumsum(x.numpy().astype(np.float64))
    excl = c - x.numpy()
    base = excl[np.clip(offsets.numpy(), 0, P - 1)]
    return excl - base[np.clip(ray_idx.numpy(), 0, len(base) - 1)]


def _f32_scan(x, offsets, ray_idx):
    """`segment_excl_cumsum` with the prefix accumulated in float32."""
    c = torch.cumsum(x, dim=0)
    excl = c - x
    seg_base = excl.index_select(0, torch.clamp(offsets, 0, x.shape[0] - 1))
    ridx = torch.clamp(ray_idx, 0, offsets.shape[0] - 1)
    return torch.clamp(excl - seg_base.index_select(0, ridx), 0.0,
                       vr._EXCL_MAX)


def _tol(x):
    """Two float32 ulps of the pool's total depth."""
    return 2.0 * float(np.spacing(np.float32(x.double().sum())))


@pytest.mark.cuda
def test_segment_prefix_on_the_card_matches_the_cpu():
    """Local depths on the card within two ulps of the total of the CPU's
    and of the exact ones; the float32 scan on the card misses by more."""
    _card()
    x, offsets, ray_idx, valid = _pool()
    assert 1.5e5 < float(x.double().sum()) < 2.1e5
    tol = _tol(x)
    cpu = vr.segment_excl_cumsum(x, offsets, ray_idx)
    card = vr.segment_excl_cumsum(x.cuda(), offsets.cuda(),
                                  ray_idx.cuda()).cpu()
    exact = _exact(x, offsets, ray_idx)
    v = valid.numpy()
    assert float((card - cpu).abs().max()) <= tol
    assert np.abs(card.numpy() - exact)[v].max() <= tol
    assert np.abs(cpu.numpy() - exact)[v].max() <= tol
    f32 = _f32_scan(x.cuda(), offsets.cuda(), ray_idx.cuda()).cpu()
    assert float((f32 - cpu).abs().max()) > tol


def _composite(x, offsets, ray_idx, valid, dev):
    """`composite_train` on `dev` over the pool with deltas 1/128 (sigma
    128 x the depths), colours and positions numpy seeded."""
    rng = np.random.default_rng(1)
    rgbs = torch.from_numpy(rng.random((P, 3)).astype(np.float32))
    ts = torch.from_numpy(rng.random(P).astype(np.float32))
    deltas = torch.full((P,), 1.0 / 128.0)
    args = [t.to(dev) for t in (x * 128.0, rgbs, deltas, ts, ray_idx, valid,
                                offsets)]
    return {k: v.cpu() for k, v in vr.composite_train(
        *args, n_rays=N_RAYS).items()}


@pytest.mark.cuda
def test_compositor_on_the_card_matches_the_cpu(monkeypatch):
    """`composite_train` on the card: the weights, and per ray opacity,
    depth and colour, within 1e-5 of their max of the CPU's, where both
    keep the same samples (a sample whose transmittance lies within an
    exp ulp of the threshold may be kept on one side only: at most 1e-5
    of them); through the float32 scan the card's weights miss by more."""
    _card()
    x, offsets, ray_idx, valid = pool = _pool()
    cpu = _composite(*pool, "cpu")
    card = _composite(*pool, "cuda")
    same = (card["ws"] > 0) == (cpu["ws"] > 0)
    assert float((~same).float().mean()) <= 1e-5
    rays = torch.ones(N_RAYS + 1, dtype=torch.bool)
    rays[ray_idx[~same]] = False
    rays = rays[:-1]
    assert float(rays.float().mean()) > 0.99

    def err(a, b, m):
        return float((a[m] - b[m]).abs().max() / b.abs().max())

    assert err(card["ws"], cpu["ws"], same) <= 1e-5
    for k in ("opacity", "depth", "rgb"):
        assert err(card[k], cpu[k], rays) <= 1e-5, k
    assert torch.equal(card["vr_samples"][rays], cpu["vr_samples"][rays])
    monkeypatch.setattr(vr, "segment_excl_cumsum", _f32_scan)
    f32 = _composite(*pool, "cuda")
    assert err(f32["ws"], cpu["ws"], same) > 1e-5
