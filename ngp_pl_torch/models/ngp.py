"""The NGP radiance field as an nn.Module (counterpart of
ngp_pl_tpu/models/ngp.py, reference models/networks.py:13-153).

Parameters keep the JAX package's names and layouts, so one set of weights
runs in both: `hash_table` (rows, W), `sigma_mlp` [(L*F, 64), (64, 16)],
`rgb_mlp` [(32, 64), (64, 64), (64, 3)] and, for the HDR head
(`rgb_act="None"`), `tonemapper` 3 x [(1, 64), (64, 1)]; the MLPs are
bias-free.

Which kernels run, by mode (as in the JAX package, `NGP.__init__`:
the fused tail needs the Sigmoid head and no position gradient):
- Sigmoid head, `need_x_grad=False` (the flagship): the encode is K1 (F=4)
  or K3 (F=2), differentiated by K2+K5 or K4; `forward` adds the fused
  field tail, K7 forward and K8 backward.
- HDR head (`--use_exposure`): the same encode kernels; the tail is
  `mlp_apply`, the counterpart of the XLA `_mlp_apply`, in PyTorch ops:
  the second sigma layer, the rgb MLP to log-radiance and the three
  1 -> 64 -> 1 tonemappers of log-radiance + log-exposure.
- `need_x_grad=True` (`--optimize_ext`): no hand kernel.  The encode is
  `hash_encode_mlp_xgrad`, the counterpart of the XLA `_encode_mlp_cv`,
  for every query (train, grid refresh, test renders), and the tail is
  `mlp_apply` with the SH differentiable, so gradients reach positions
  and directions.

`density` (the occupancy grid's query) is the encode and the second sigma
layer; `forward_rays` is `forward` over a strided (N, S) block of samples,
with the SH and the log-exposure once per ray.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ngp_pl_torch import parallel
from ngp_pl_torch.config import NGPConfig
from ngp_pl_torch.device import resolve_device
from ngp_pl_torch.ops.field_tail import (
    field_tail,
    field_tail_fn,
    field_tail_supported,
)
from ngp_pl_torch.ops.hash_encoding import (
    HashGridSpec,
    _bf,
    encode_table,
    hash_encode_fwd,
    hash_encode_mlp,
    hash_encode_mlp_xgrad,
    init_hash_table,
    make_grid_spec,
)
from ngp_pl_torch.ops.sh import sh_encode
from ngp_pl_torch.ops.trunc_exp import trunc_exp


def grid_spec_for(cfg: NGPConfig) -> HashGridSpec:
    return make_grid_spec(
        n_levels=cfg.n_levels,
        n_features=cfg.n_features_per_level,
        log2_hashmap_size=cfg.log2_hashmap_size,
        base_resolution=cfg.base_resolution,
        per_level_scale=cfg.per_level_scale,
    )


def _mlp_init(sizes, generator) -> List[torch.Tensor]:
    """He-uniform init for a bias-free ReLU MLP given layer sizes."""
    ws = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = (6.0 / fan_in) ** 0.5
        ws.append(torch.rand((fan_in, fan_out), generator=generator)
                  * (2 * bound) - bound)
    return ws


class _MLP(torch.autograd.Function):
    """The bias-free ReLU MLP of `mlp_apply` and its backward as XLA
    compiles the JAX package's `_mlp_apply` under jit: the cotangent of the
    output is rounded to bf16 (the dot's bf16 result type), and so are each
    weight's gradient and each hidden layer's input cotangent (before the
    ReLU's mask); the input's gradient is an f32 sum of bf16 products (the
    widening convert folds into the dot).  In a process group a weight's
    gradient is the ranks' mean before it is rounded, as the one-rank
    step rounds the whole batch's sum."""

    @staticmethod
    def forward(ctx, x, *ws):
        wbs = [_bf(w) for w in ws]
        acts = [_bf(x)]
        for i, wb in enumerate(wbs):
            z = acts[-1] @ wb
            if i < len(wbs) - 1:
                acts.append(_bf(torch.relu(z)))
        ctx.save_for_backward(*acts, *wbs)
        return z

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n = len(saved) // 2
        acts, wbs = saved[:n], saved[n:]
        ct = _bf(g)
        dws = [None] * n
        for i in reversed(range(n)):
            # in a process group: the global sum, then its rounding
            dws[i] = _bf(parallel.mean_partial(acts[i].T @ ct))
            d_in = ct @ wbs[i].T
            if i > 0:            # acts[i] > 0 exactly where its z was
                ct = torch.where(acts[i] > 0, _bf(d_in), 0.0)
        return (d_in, *dws)


def mlp_apply(ws, x: torch.Tensor, out_act=None) -> torch.Tensor:
    """Bias-free ReLU MLP as the JAX package's jitted `_mlp_apply`
    (ngp_pl_tpu/models/ngp.py:44-53) computes it: bf16 input and weights,
    f32 sums, every hidden layer's output rounded to bf16, the last layer's
    output kept in f32 (under jit XLA folds `astype(float32)` of the bf16
    product into the product), then `out_act`; the backward is `_MLP`'s."""
    h = _MLP.apply(x, *ws)
    return h if out_act is None else out_act(h)


def init_ngp_params(cfg: NGPConfig, generator: torch.Generator) -> Dict:
    """Seeded parameters in the JAX package's nested layout (CPU tensors).
    torch.Generator and jax.random draw different numbers from one seed;
    parity tests carry JAX's parameters over with `load_params`."""
    spec = grid_spec_for(cfg)
    sh_dim = cfg.sh_degree ** 2
    params = {
        "hash_table": init_hash_table(spec, generator),
        "sigma_mlp": _mlp_init(
            [spec.out_dim] + [cfg.sigma_hidden] * cfg.sigma_layers
            + [cfg.geo_features], generator),
        "rgb_mlp": _mlp_init(
            [sh_dim + cfg.geo_features] + [cfg.rgb_hidden] * cfg.rgb_layers
            + [3], generator),
    }
    if cfg.rgb_act == "None":
        # per-channel HDR tonemappers 1 -> 64 -> 1 (networks.py:79-92)
        params["tonemapper"] = [_mlp_init([1, 64, 1], generator)
                                for _ in range(3)]
    return params


class NGP(nn.Module):
    def __init__(self, cfg: NGPConfig, seed: int = 0, device="cuda",
                 need_x_grad: bool = False):
        super().__init__()
        if cfg.rgb_act not in ("Sigmoid", "None"):
            raise NotImplementedError(
                f"rgb_act {cfg.rgb_act!r}: the heads are 'Sigmoid' and the "
                "HDR head 'None', as in the JAX package")
        dev = resolve_device(device)
        self.cfg = cfg
        self.spec = grid_spec_for(cfg)
        self.need_x_grad = need_x_grad
        # the fused tail (K7/K8): the reference geometry, no gradient to
        # positions or directions (ngp_pl_tpu/models/ngp.py:113-115)
        self.use_fused = field_tail_supported(cfg) and not need_x_grad
        p = init_ngp_params(cfg, torch.Generator().manual_seed(seed))
        self.hash_table = nn.Parameter(p["hash_table"].to(dev))
        self.sigma_mlp = nn.ParameterList(
            [nn.Parameter(w.to(dev)) for w in p["sigma_mlp"]])
        self.rgb_mlp = nn.ParameterList(
            [nn.Parameter(w.to(dev)) for w in p["rgb_mlp"]])
        self.tonemapper = nn.ModuleList(
            [nn.ParameterList([nn.Parameter(w.to(dev)) for w in ws])
             for ws in p.get("tonemapper", [])])
        self._enc_table = None
        self._enc_table_key = None

    # --- parameters in the JAX layout ---------------------------------
    def _slots(self):
        """(name, index, parameter): index None for the table, i for
        `name[i]`, (i, j) for `tonemapper[i][j]`."""
        yield "hash_table", None, self.hash_table
        for name in ("sigma_mlp", "rgb_mlp"):
            for i, w in enumerate(getattr(self, name)):
                yield name, i, w
        for i, ws in enumerate(self.tonemapper):
            for j, w in enumerate(ws):
                yield "tonemapper", (i, j), w

    @staticmethod
    def _leaf(params: Dict, name, i):
        if i is None:
            return params[name]
        if isinstance(i, tuple):
            return params[name][i[0]][i[1]]
        return params[name][i]

    @torch.no_grad()
    def load_params(self, params: Dict) -> None:
        """Copy a nested {'hash_table', 'sigma_mlp': [...], 'rgb_mlp': [...]
        (, 'tonemapper': [[...], ...])} of arrays or tensors into the
        module; shapes must match."""
        for name, i, w in self._slots():
            src = self._leaf(params, name, i)
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src, dtype=np.float32))
            if tuple(src.shape) != tuple(w.shape):
                where = "" if i is None else list(np.atleast_1d(i))
                raise ValueError(
                    f"parameter {name}{where} has shape "
                    f"{tuple(src.shape)}, the model expects {tuple(w.shape)}"
                    " (check --n_levels/--n_features/--log2_hashmap_size)")
            w.copy_(src.to(w.device, torch.float32))

    def params_numpy(self) -> Dict:
        out: Dict = {"sigma_mlp": [], "rgb_mlp": []}
        if len(self.tonemapper):
            out["tonemapper"] = [[] for _ in self.tonemapper]
        for name, i, w in self._slots():
            a = w.detach().cpu().numpy()
            if i is None:
                out[name] = a
            elif isinstance(i, tuple):
                out[name][i[0]].append(a)
            else:
                out[name].append(a)
        return out

    # --- field queries --------------------------------------------------
    def encode_table(self) -> torch.Tensor:
        """The table the encode reads (`encode_table`): at F=4 (K1) the f16
        copy, at F=2 (K3) the f32 table itself, detached.  It is rebuilt
        only when the table changed: an in-place update (load_params, an
        optimizer step) bumps the parameter's version counter, a move to
        another device its storage."""
        key = (self.hash_table.data_ptr(), self.hash_table._version)
        if key != self._enc_table_key:
            self._enc_table = encode_table(self.hash_table.detach(),
                                           self.spec)
            self._enc_table_key = key
        return self._enc_table

    def _xn(self, x: torch.Tensor) -> torch.Tensor:
        return ((x + self.cfg.scale) / (2.0 * self.cfg.scale)).contiguous()

    def _h1(self, x: torch.Tensor) -> torch.Tensor:
        """The first layer's pre-activation of world positions x (N, 3):
        the x-grad encode under `need_x_grad`; else K1/K3, differentiable
        (K2+K5/K4 backward) when autograd records."""
        if self.need_x_grad:
            return hash_encode_mlp_xgrad(self._xn(x), self.hash_table,
                                         self.sigma_mlp[0], self.spec)
        if torch.is_grad_enabled() and self.hash_table.requires_grad:
            return hash_encode_mlp(self._xn(x), self.hash_table,
                                   self.sigma_mlp[0], self.encode_table(),
                                   self.spec)
        return hash_encode_fwd(self._xn(x), self.encode_table(),
                               self.sigma_mlp[0].detach(), self.spec)

    def density(self, x: torch.Tensor, return_feat: bool = False):
        """x: (N, 3) world positions in [-scale, scale]^3 -> sigma (N,)
        (and the geometry features h (N, 16) with `return_feat`)."""
        h = mlp_apply(self.sigma_mlp[1:], torch.relu(self._h1(x)))
        sigma = trunc_exp(h[:, 0])
        return (sigma, h) if return_feat else sigma

    def _sh(self, d: torch.Tensor) -> torch.Tensor:
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return sh_encode((dn + 1.0) * 0.5, self.cfg.sh_degree)

    def forward(self, x: torch.Tensor, d: torch.Tensor,
                exposure: Optional[torch.Tensor] = None,
                output_radiance: bool = False):
        """(sigma (N,), rgb (N, 3)) from positions and view directions;
        the HDR head takes a per-sample `exposure` (N, 1) (None: unit
        exposure) or gives the radiance with `output_radiance`."""
        log_exp = torch.log(exposure) if exposure is not None else None
        return self._field(x, self._sh(d), log_exp, output_radiance)

    def forward_rays(self, xyz: torch.Tensor, rays_d: torch.Tensor,
                     exposure: Optional[torch.Tensor] = None):
        """Strided-layout field (ngp_pl_tpu/models/ngp.py:194-259): xyz
        (N, S, 3) positions of S samples on each of N rays with directions
        rays_d (N, 3) and exposures (N, 1) -> (sigma (N, S), rgb
        (N, S, 3)).  The direction and exposure are constant along a ray,
        so its SH and log-exposure are computed once per ray and broadcast
        to the N*S rows."""
        N, S = xyz.shape[0], xyz.shape[1]
        sh = self._sh(rays_d)[:, None, :].expand(N, S, -1)
        log_exp = None
        if exposure is not None:
            log_exp = torch.log(exposure)[:, None, :].expand(
                N, S, 1).reshape(N * S, 1)
        sigma, rgb = self._field(xyz.reshape(N * S, 3),
                                 sh.reshape(N * S, -1), log_exp)
        return sigma.reshape(N, S), rgb.reshape(N, S, 3)

    def _field(self, x: torch.Tensor, sh: torch.Tensor, log_exp=None,
               output_radiance: bool = False):
        """Encode + tail of positions x (P, 3) with their SH (P, 16) (see
        the module note for the kernels of each mode)."""
        if self.use_fused:
            ws = (self.sigma_mlp[1], self.rgb_mlp[0], self.rgb_mlp[1],
                  self.rgb_mlp[2])
            if torch.is_grad_enabled() and self.hash_table.requires_grad:
                return field_tail_fn(self._h1(x), sh.detach(), *ws)
            return field_tail(self._h1(x), sh, *(w.detach() for w in ws))
        sigma, h = self.density(x, return_feat=True)
        feats = torch.cat([sh, h], dim=-1)
        if self.cfg.rgb_act == "Sigmoid":
            return sigma, mlp_apply(self.rgb_mlp, feats, torch.sigmoid)
        log_rad = mlp_apply(self.rgb_mlp, feats)       # HDR: log-radiance
        if output_radiance:
            return sigma, trunc_exp(log_rad)
        chans = []
        for i, ws in enumerate(self.tonemapper):
            inp = log_rad[:, i:i + 1]
            if log_exp is not None:
                inp = inp + log_exp
            chans.append(mlp_apply(ws, inp, torch.sigmoid))
        return sigma, torch.cat(chans, dim=-1)
