"""On a host with two cards or more: every hand kernel's wrapper refuses
tensors that lie on a card other than the current one.  The kernels launch
through ctypes into the calling thread's current CUDA context, whatever
device their tensors are on, so a launch on such tensors would run in the
wrong context; one process per GPU (ngp_pl_torch.parallel) sets its card
first and never meets this.  Each wrapper is given well-formed tensors on
cuda:1 while cuda:0 is current and must raise before it launches.

    python -m pytest -m cuda --noconftest tests/test_torch_device_check_cuda.py
"""
import pytest
import torch

N = 256


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices and nvcc")
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")
    torch.cuda.set_device(0)


def _calls(dev):
    """(name, wrapper, the call) of every hand kernel on `dev`."""
    from ngp_pl_torch.config import NGPConfig
    from ngp_pl_torch.models.ngp import grid_spec_for
    from ngp_pl_torch.ops import encode_ablations as ea
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he
    from ngp_pl_torch.ops import scatter_rows as sr

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=g).to(dtype).to(dev)

    out = []
    for F, fwd, bwd, dt in ((4, he.hash_encode_fwd_cuda,
                             he.hash_encode_bwd_cuda, torch.float16),
                            (2, he.hash_encode_fwd_f2_cuda,
                             he.hash_encode_bwd_f2_cuda, torch.float32)):
        spec = grid_spec_for(NGPConfig(n_levels=4, n_features_per_level=F,
                                       log2_hashmap_size=12))
        x, w1 = rnd(N, 3), rnd(4 * F, 64)
        table = rnd(spec.total_rows, 32 * F, dtype=dt)
        out.append((f"encode F={F}", fwd,
                    lambda fwd=fwd, x=x, t=table, w1=w1, s=spec:
                    fwd(x, t, w1, s)))
        out.append((f"table gradient F={F}", bwd,
                    lambda bwd=bwd, x=x, w1=w1, s=spec:
                    bwd(x, rnd(N, 64), w1, s)))
    tail = (rnd(N, ft.H_HID), rnd(N, ft.H_SH), rnd(ft.H_HID, ft.H_GEO),
            rnd(ft.H_SH + ft.H_GEO, ft.H_HID), rnd(ft.H_HID, ft.H_HID),
            rnd(ft.H_HID, 3))
    out.append(("field tail", ft.field_tail_cuda,
                lambda: ft.field_tail_cuda(*tail)))
    out.append(("field tail backward", ft.field_tail_bwd_cuda,
                lambda: ft.field_tail_bwd_cuda(*tail[:2], rnd(N), rnd(N, 3),
                                               *tail[2:])))
    out.append(("scatter rows", sr.scatter_rows_cuda,
                lambda: sr.scatter_rows_cuda(
                    rnd(N, 8), torch.zeros(N, dtype=torch.int64,
                                           device=dev), 4)))
    rows = torch.zeros((1, 128, 64), dtype=torch.int32, device=dev)
    meta_T, w1big = rnd(1, 4, 128), rnd(1, 128, 64)
    for v in ea.VARIANTS:
        r = ea.interleave(rows, 128) if v == "full_il" else rows
        out.append((f"K9/{v}", ea.CUDA[v],
                    lambda v=v, r=r: ea.CUDA[v](r, meta_T, w1big, 128)))
    out.append(("K9 w1 pack", None, lambda: ea.pack_w1_cuda(w1big)))
    return out


@pytest.mark.cuda
def test_every_wrapper_refuses_tensors_off_the_current_device():
    _two_cards()
    calls = _calls(torch.device("cuda", 1))
    for name, wrapper, call in calls:
        before = None if wrapper is None else wrapper.launches
        with pytest.raises(ValueError, match="current CUDA device"):
            call()
        assert wrapper is None or wrapper.launches == before, name
    # the same calls on the current card launch
    torch.cuda.set_device(1)
    for name, wrapper, call in calls:
        call()
    torch.cuda.synchronize()
