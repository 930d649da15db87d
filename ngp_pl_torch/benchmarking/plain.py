"""The hand kernels' plain PyTorch versions in place of their wrappers, for
the checks and probes that hold a path with the kernels against the same
path without them on the same device."""
from __future__ import annotations

import contextlib

ALL = ("K1", "K3", "K7", "K2+K5", "K4", "K8")


@contextlib.contextmanager
def plain_versions(*keys):
    """Within the block the named kernels' wrappers (`ALL`: every kernel
    of a train step) run their plain PyTorch versions on the tensors they
    are given instead of launching, and count nothing."""
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    swaps = {"K1": (he, "hash_encode_fwd_cuda", he.hash_encode_fwd_plain),
             "K3": (he, "hash_encode_fwd_f2_cuda", he.hash_encode_fwd_plain),
             "K7": (ft, "field_tail_cuda", ft.field_tail_plain),
             "K2+K5": (he, "hash_encode_bwd_cuda", he.hash_encode_bwd_plain),
             "K4": (he, "hash_encode_bwd_f2_cuda", he.hash_encode_bwd_plain),
             "K8": (ft, "field_tail_bwd_cuda", ft.field_tail_bwd_plain)}
    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in (swaps[k] for k in keys)]
    try:
        for k in keys:
            mod, attr, plain = swaps[k]
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
