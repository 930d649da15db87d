"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to run on the CPU unless asked to, and
(on a card only) its CUDA kernels build and agree with their plain
versions."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ngp_pl_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_port_sources_import_no_jax():
    """Every import statement, also those inside functions."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "ngp_pl_tpu"), (path, n)


def test_port_imports_with_jax_blocked():
    """Import every module of the port and chip_smoke.py in a process where
    importing jax or ngp_pl_tpu fails."""
    code = (
        "import sys, importlib, importlib.util\n"
        "for m in ('jax', 'jaxlib', 'ngp_pl_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k.startswith(('jax', 'ngp_pl_tpu')) and sys.modules[k]"
        " is not None for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    from ngp_pl_torch.config import NGPConfig, TrainConfig
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.device import resolve_device
    from ngp_pl_torch.eval import evaluate
    from ngp_pl_torch.models.ngp import NGP
    from ngp_pl_torch.train import main as train_main
    from ngp_pl_torch.training.system import NeRFSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = NGPConfig(n_levels=2, n_features_per_level=4, log2_hashmap_size=8)
    small = ["--n_levels", "4", "--log2_hashmap_size", "12", "--batch_size",
             "256", "--downsample", "0.1875", "--num_epochs", "1",
             "--iters_per_epoch", "16", "--max_images", "1"]
    for call in (lambda: evaluate(TrainConfig()), lambda: NGP(cfg),
                 lambda: SyntheticDataset(), lambda: resolve_device(),
                 lambda: NeRFSystem(TrainConfig()),
                 lambda: train_main(small)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    NGP(cfg, device="cpu")
    system, scores = train_main(small + ["--device", "cpu"])
    assert system.optimizer.count == 16
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    assert (tmp_path / "ckpts" / "synthetic" / "exp"
            / "epoch=1_slim.npz").exists()


def test_chip_smoke_fails_without_cuda():
    """No result and a non-zero exit without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: K1, K3 and K7 build, launch, count and agree with their
    plain versions (tolerances as chip_smoke.py states them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    resolve_device("cuda")
    g = torch.Generator().manual_seed(0)
    spec = he.make_grid_spec(4, 4, 10, 4, 2.0)
    table = he.table_f16(he.init_hash_table(spec, g) * 1e4).cuda()
    w1 = torch.randn((16, 64), generator=g).cuda()
    x = torch.rand((1000, 3), generator=g).cuda()
    n0 = he.hash_encode_fwd_cuda.launches
    h_k = he.hash_encode_fwd(x, table, w1, spec)
    assert he.hash_encode_fwd_cuda.launches == n0 + 1
    h_p = he.hash_encode_fwd_plain(x, table, w1, spec)
    assert float((h_k - h_p).abs().max()) <= 1e-5 * float(h_p.abs().max())

    spec2 = he.make_grid_spec(4, 2, 10, 4, 2.0)            # K3: f32 rows
    table2 = (he.init_hash_table(spec2, g) * 1e4).cuda()
    w1_2 = torch.randn((8, 64), generator=g).cuda()
    n0 = he.hash_encode_fwd_f2_cuda.launches
    feats = torch.empty((1000, 8), device="cuda")
    h_k = he.hash_encode_fwd(x, table2, w1_2, spec2, feats)
    assert he.hash_encode_fwd_f2_cuda.launches == n0 + 1
    feats_p = torch.empty((1000, 8), device="cuda")
    h_p = he.hash_encode_fwd_plain(x, table2, w1_2, spec2, feats_p)
    assert float((h_k - h_p).abs().max()) <= 1e-5 * float(h_p.abs().max())
    assert (float((feats - feats_p).abs().max())
            <= 1e-5 * float(feats_p.abs().max()))

    h1 = torch.randn((1000, 64), generator=g).cuda()
    sh = torch.randn((1000, 16), generator=g).cuda() * 0.3
    ws = [torch.randn(s, generator=g).cuda() * 0.2
          for s in ((64, 16), (32, 64), (64, 64), (64, 3))]
    n0 = ft.field_tail_cuda.launches
    s_k, r_k = ft.field_tail(h1, sh, *ws)
    assert ft.field_tail_cuda.launches == n0 + 1
    s_p, r_p = ft.field_tail_plain(h1, sh, *ws)
    np.testing.assert_allclose(s_k.cpu().numpy(), s_p.cpu().numpy(),
                               rtol=1e-5)
    assert float((r_k - r_p).abs().max()) <= 4e-3


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """On the card: the table-gradient kernels (K2+K5, K4), K8 and K6
    build, launch, count and agree with their plain versions (tolerances
    as chip_smoke.py states them).  The table gradients are held against
    the plain version run on the CPU: at 1,000 rows cuBLAS sums the plain
    version's d_wr = bf16(g) bf16(w1)^T in another order than the kernel
    and the CPU (both sequential over the 64 inputs), which rounds single
    products to the other bf16 neighbour (6.8e-5 of max at either F,
    against 6.6e-8 for the kernel against the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he
    from ngp_pl_torch.ops import scatter_rows as sr

    resolve_device("cuda")
    g = torch.Generator().manual_seed(1)
    spec = he.make_grid_spec(4, 4, 12, 4, 2.0)
    x = torch.rand((1000, 3), generator=g).cuda()
    gr = torch.randn((1000, 64), generator=g).cuda()
    w1 = (torch.randn((16, 64), generator=g) * 0.3).cuda()
    n0 = he.hash_encode_bwd_cuda.launches
    d_k = he.hash_encode_bwd(x, gr, w1, spec).cpu()
    assert he.hash_encode_bwd_cuda.launches == n0 + 1
    d_p = he.hash_encode_bwd_plain(x.cpu(), gr.cpu(), w1.cpu(), spec)
    assert float((d_k - d_p).abs().max()) <= 1e-5 * float(d_p.abs().max())

    spec2 = he.make_grid_spec(4, 2, 12, 4, 2.0)            # K4
    w1_2 = (torch.randn((8, 64), generator=g) * 0.3).cuda()
    n0 = he.hash_encode_bwd_f2_cuda.launches
    d_k = he.hash_encode_bwd(x, gr, w1_2, spec2).cpu()
    assert he.hash_encode_bwd_f2_cuda.launches == n0 + 1
    assert d_k.shape == (spec2.total_rows, 64)
    d_p = he.hash_encode_bwd_plain(x.cpu(), gr.cpu(), w1_2.cpu(), spec2)
    assert float((d_k - d_p).abs().max()) <= 1e-5 * float(d_p.abs().max())

    h1 = (torch.randn((1000, 64), generator=g) * 2.0).cuda()
    sh = (torch.randn((1000, 16), generator=g) * 0.3).cuda()
    g_sigma = (torch.randn((1000,), generator=g) * 1e-2).cuda()
    g_rgb = torch.randn((1000, 3), generator=g).cuda()
    ws = [(torch.randn(s, generator=g) * 0.3).cuda()
          for s in ((64, 16), (32, 64), (64, 64), (64, 3))]
    n0 = ft.field_tail_bwd_cuda.launches
    got = ft.field_tail_bwd(h1, sh, g_sigma, g_rgb, *ws)
    assert ft.field_tail_bwd_cuda.launches == n0 + 1
    for a, b in zip(got, ft.field_tail_bwd_plain(h1, sh, g_sigma, g_rgb,
                                                 *ws)):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())

    idx = (torch.arange(1000, device="cuda") * 7) % 37
    n0 = sr.scatter_rows_cuda.launches
    out = sr.scatter_rows(h1, idx, 37)
    assert sr.scatter_rows_cuda.launches == n0 + 1
    ref = sr.scatter_rows_plain(h1, idx, 37)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_encode_ablation_variants_match_plain_on_card():
    """On the card: each K9 variant builds, launches, counts and agrees with
    its plain version within 1e-5 of max |h1| and of max |ft2| (N=1,024,
    bn=512; f32 U(-2, 2) bits for the variants that read the rows as f32,
    the bench's random rows for the others)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device
    from ngp_pl_torch.ops import encode_ablations as ea

    resolve_device("cuda")
    rng = np.random.default_rng(3)
    L, n, bn = 8, 1024, 512
    for variant in ea.VARIANTS:
        if variant in ("no_decode", "stream"):
            rows = rng.uniform(-2, 2, (L, n, 64)).astype(np.float32).view(
                np.int32)
        else:
            rows = rng.integers(0, 2 ** 31, (L, n, 64)).astype(np.int32)
        rows = torch.from_numpy(rows).cuda()
        if variant == "full_il":
            rows = ea.interleave(rows, bn)
        meta_T = torch.from_numpy(
            rng.random((L, 4, n)).astype(np.float32)).cuda()
        w1big = torch.from_numpy(
            rng.random((L, 128, 64)).astype(np.float32)).cuda()
        n0 = ea.CUDA[variant].launches
        got = ea.encode_ablation(variant, rows, meta_T, w1big, bn)
        assert ea.CUDA[variant].launches == n0 + 1
        for a, b in zip(got, ea.encode_ablation_plain(variant, rows, meta_T,
                                                      w1big)):
            assert bool(torch.isfinite(a).all())
            assert (float((a - b).abs().max())
                    <= 1e-5 * float(b.abs().max()))
