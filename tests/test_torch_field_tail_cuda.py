"""On the card only: K7 and K8, the field tail's tensor-core kernels,
against their plain versions at ragged sample counts, at inputs that
saturate the TruncExp clamps, and K8's weight gradients bit for bit from
one call to the next.  As in chip_smoke.py, each kernel is held against
both plain versions, with f32 sums and with float64 sums (`acc`), at the
limits it states: K7 4e-3 absolute on rgb and log sigma against both; K8
1e-2 of each output's largest magnitude against f32 sums and 1e-3 against
float64 sums.  The plain versions run on the CPU, whose sums do not
depend on the size.

    python -m pytest -m cuda --noconftest tests/test_torch_field_tail_cuda.py
"""
import numpy as np
import pytest
import torch

from ngp_pl_torch.benchmarking.field_tail_gates import k7_error

K7_TOL = 4e-3
K8_TOL = 1e-3
K8_F32_TOL = 1e-2
# K7 against the f32 plain version where that version's own sums flip a
# bf16 activation past K7_TOL: it misses its float64 twin by 6.73e-3 on the
# inputs of test_k7_sides_with_float64_sums_where_f32_sums_flip, and the
# wrong variants of ngp_pl_torch/benchmarking/field_tail_gates.py read
# 1.88e-2 (an f16-rounded r2) and more there (CPU).
K7_FLIP_TOL = 1e-2
SIZES = (1, 15, 16, 17, 127, 129, 1000, 65537)


def _inputs(P, seed, scale, he=True):
    """h1, sh, g_sigma, g_rgb and the four weights, numpy seeded.  The
    weights are He-uniform, as the model initialises them
    (ngp_pl_torch/models/ngp.py), or with `he=False` N(0, 0.3), large
    enough that one activation's bf16 flip moves rgb past 4e-3.  Rows 0
    and 1 of h1 push h[0] = relu(h1) W2[:, 0] far above and far below 0
    (`scale` times the usual magnitude), past the TruncExp clamps."""
    from ngp_pl_torch.ops.sh import sh_encode

    rng = np.random.default_rng(seed)
    h1 = rng.normal(0, 2, (P, 64)).astype(np.float32)
    shapes = ((64, 16), (32, 64), (64, 64), (64, 3))
    ws = [(rng.uniform(-1, 1, s) * np.sqrt(6.0 / s[0]) if he
           else rng.normal(0, 0.3, s)).astype(np.float32) for s in shapes]
    sign = np.sign(ws[0][:, 0])
    h1[0] = np.abs(h1[0]) * scale * sign
    if P > 1:
        h1[1] = np.abs(h1[1]) * scale * -sign
    d = rng.normal(size=(P, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sh = sh_encode(torch.from_numpy((d + 1.0) * 0.5))
    ws = [torch.from_numpy(w) for w in ws]
    g_sigma = torch.from_numpy(rng.normal(0, 1e-2, P).astype(np.float32))
    g_rgb = torch.from_numpy(rng.normal(0, 1, (P, 3)).astype(np.float32))
    return torch.from_numpy(h1), sh, g_sigma, g_rgb, ws


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", SIZES)
def test_k7_matches_plain_at_ragged_sizes(P):
    _card()
    from ngp_pl_torch.ops import field_tail as ft

    h1, sh, _, _, ws = _inputs(P, P, 100.0)
    n0 = ft.field_tail_cuda.launches
    s_k, r_k = ft.field_tail(h1.cuda(), sh.cuda(), *(w.cuda() for w in ws))
    assert ft.field_tail_cuda.launches == n0 + 1
    got = (s_k.cpu(), r_k.cpu())
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for acc in (torch.float32, torch.float64):
        ref = ft.field_tail_plain(h1, sh, *ws, acc=acc)
        assert k7_error(got, ref) <= K7_TOL, acc
    # the clamp binds on both sides
    assert float(ref[0][0]) == pytest.approx(np.exp(30.0), rel=1e-6)
    if P > 1:
        assert float(ref[0][1]) == pytest.approx(np.exp(-30.0), rel=1e-6)


@pytest.mark.cuda
def test_k7_sides_with_float64_sums_where_f32_sums_flip(record_property):
    """At N(0, 0.3) weights the f32 plain version's own sums flip a bf16
    activation: it misses its float64 twin by 6.73e-3 (CPU), past K7_TOL.
    K7 is held to K7_TOL against float64 sums there, and to K7_FLIP_TOL
    against the f32 plain version; both readings go to the JUnit report
    (`--junitxml`; on the H100, 3.06e-3 and 6.73e-3)."""
    _card()
    from ngp_pl_torch.ops import field_tail as ft

    h1, sh, _, _, ws = _inputs(65537, 65537, 100.0, he=False)
    ref32 = ft.field_tail_plain(h1, sh, *ws)
    ref64 = ft.field_tail_plain(h1, sh, *ws, acc=torch.float64)
    assert k7_error(ref32, ref64) > K7_TOL     # the flip is there
    s_k, r_k = ft.field_tail(h1.cuda(), sh.cuda(), *(w.cuda() for w in ws))
    got = (s_k.cpu(), r_k.cpu())
    record_property("vs_float64_sums", k7_error(got, ref64))
    record_property("vs_f32_plain", k7_error(got, ref32))
    assert k7_error(got, ref64) <= K7_TOL
    assert k7_error(got, ref32) <= K7_FLIP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("P", SIZES)
def test_k8_matches_plain_at_ragged_sizes(P):
    _card()
    from ngp_pl_torch.ops import field_tail as ft

    h1, sh, g_sigma, g_rgb, ws = _inputs(P, 100 + P, 20.0)
    args = (h1, sh, g_sigma, g_rgb, *ws)
    n0 = ft.field_tail_bwd_cuda.launches
    got = ft.field_tail_bwd(*(t.cuda() for t in args))
    assert ft.field_tail_bwd_cuda.launches == n0 + 1
    got = [t.cpu() for t in got]
    for acc, tol in ((torch.float32, K8_F32_TOL), (torch.float64, K8_TOL)):
        ref = ft.field_tail_bwd_plain(*args, acc=acc)
        for name, a, b in zip(("dh1", "dW2", "dWr1", "dWr2", "dWr3"), got,
                              ref):
            assert a.shape == b.shape, name
            assert bool(torch.isfinite(a).all()), name
            assert (float((a - b).abs().max())
                    <= tol * float(b.abs().max())), (name, acc)


@pytest.mark.cuda
def test_k8_weight_gradients_are_bit_identical_across_calls():
    _card()
    from ngp_pl_torch.ops import field_tail as ft

    h1, sh, g_sigma, g_rgb, ws = _inputs(393216, 7, 20.0)
    args = [t.cuda() for t in (h1, sh, g_sigma, g_rgb, *ws)]
    first = ft.field_tail_bwd(*args)
    second = ft.field_tail_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
