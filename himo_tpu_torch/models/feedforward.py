"""Feed-forward scene-flow networks: FastFlow3D / DeFlow(++) / SeFlow++
(port of ``himo_tpu/models/feedforward.py``).

Public layouts follow the JAX reference: clouds (B, N, 3), pillar images
(B, H, W, C). The backbone runs NCHW internally because PyTorch's
convolutions do. What the port keeps of flax's semantics, each one a
place where a plain PyTorch layer would compute something else:

- 'SAME' padding of a stride-2 3x3 conv on an even size pads (0, 1), not
  (1, 1) (:func:`_conv_same`);
- flax's GroupNorm on the un-batched (H, W, C) image it sees under ``vmap``
  treats H as a batch axis: statistics are per (frame, row, group), over W
  and the group's channels, in float32 with epsilon 1e-6 and
  ``var = E[x^2] - E[x]^2`` (:class:`GroupNorm`);
- with ``dtype="bfloat16"`` the parameters stay float32 and each layer
  casts its inputs and parameters to bf16; the output Dense layers compute
  in float32, and the flow is float32. No ``torch.autocast``: it would push
  the fp32 one-hot matmuls of the instance and refine heads into bf16.

The pillar max-pool (``ops/voxelize.scatter_max``) and the refine head's
nearest-neighbour passes (``ops/nn``) run hand-written CUDA kernels on the
GPU. With ``pooling='mean_sorted'`` each sweep's points are sorted by
pillar id, pooled by a mean from one sorted sum (``ops/mxu_scatter``, K10),
the decoder's pillar features gathered at sweep 0's sorted ids (K11), and
the outputs taken back to input order (``ops/nn.take_rows``). The
``soft_gate=True, with_aux=True`` forward of training (refine head off)
differentiates end to end: the pooling's and the pillar gather's
gradients follow the reference's custom VJPs, on the kernels. Inference
runs under ``torch.inference_mode()`` (as :func:`frame` and the registry
estimator do).

:func:`make_model` and the registry's estimators build the network on the
GPU unless given ``device="cpu"``, and raise when CUDA is absent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from himo_tpu_torch.core.compensation import flow_to_comp_dis, refine_points
from himo_tpu_torch.models.registry import register_estimator
from himo_tpu_torch.ops.components import (
    component_slots,
    connected_components_grid,
    pool_by_slot,
)
from himo_tpu_torch.ops.mxu_scatter import gather_rows_sorted, scatter_sum_sorted
from himo_tpu_torch.ops.nn import take_rows
from himo_tpu_torch.ops.refine import RefineConfig, refine_flow
from himo_tpu_torch.ops.voxelize import (
    PillarConfig,
    _stable_sort,
    _take_rows_at,
    gather_pillars,
    scatter_max_multi,
    voxelize_pillars,
)


@dataclasses.dataclass(frozen=True)
class FlowNetConfig:
    """Same fields and defaults as the JAX ``FlowNetConfig``."""

    pillar: PillarConfig = PillarConfig()
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: Tuple[int, ...] = (64, 128, 256)
    decoder: str = "deflow"  # 'linear' (FastFlow3D) | 'deflow' (GRU)
    gru_iters: int = 4
    num_frames: int = 2
    dtype: str = "float32"  # 'bfloat16' for inference speed
    # The host cluster translation prior (models/nsfp.cluster_prior_flow):
    # ``prior_feat`` feeds it to the PFN as 3 extra channels of sweep 0;
    # ``prior_residual`` adds it to the gated flow (the prior bypasses the
    # gate); ``prior_trust`` emits it verbatim where it is non-zero.
    prior_feat: bool = False
    prior_residual: bool = False
    prior_trust: bool = False
    pooling: str = "max"  # 'max' | 'mean_sorted' (sorted-stream mean, K10/K11)
    instance_head: bool = False
    instance_stride: int = 2  # coarse CC cell = stride x pillar voxel
    instance_reach: int = 2  # Chebyshev connect radius in coarse cells
    instance_iters: int = 24  # label diameter = iters * reach cells
    instance_slots: int = 128  # per-frame component budget
    instance_min_pts: float = 5.0  # min pooling mass to trust a mean
    corr_volume: bool = False
    corr_radii: Tuple[int, int] = (4, 3)
    refine_head: bool = False
    refine: RefineConfig = RefineConfig()
    gate_head: bool = False


def _torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and float32 parameters cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _same_pads(size: int, stride: int, kernel: int = 3) -> Tuple[int, int]:
    """(low, high) padding of XLA's 'SAME' for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_same(
    conv: nn.Conv2d, x: torch.Tensor, stride: int, dtype: torch.dtype
) -> torch.Tensor:
    """'SAME' conv on NCHW ``x`` in ``dtype`` at the conv's kernel size (a
    1x1 kernel pads nothing). A 3x3 kernel at stride 2 on an even size pads
    (0, 1) — bottom/right only — which ``padding=1`` would get wrong."""
    kh, kw = conv.kernel_size
    (ty, by), (lx, rx) = (
        _same_pads(x.shape[-2], stride, kh),
        _same_pads(x.shape[-1], stride, kw),
    )
    w, b = conv.weight.to(dtype), conv.bias.to(dtype)
    x = x.to(dtype)
    if ty == by and lx == rx:
        return F.conv2d(x, w, b, stride=stride, padding=(ty, lx))
    return F.conv2d(F.pad(x, (lx, rx, ty, by)), w, b, stride=stride)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon=1e-6)`` as applied to an
    un-batched (H, W, C) image, on NCHW input: statistics per (frame, row,
    group) over W and the group's channels, computed in float32 with
    ``var = max(E[x^2] - E[x]^2, 0)``; the result is cast back to ``dtype``."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        xg = x.reshape(b, g, c // g, h, w)
        xf = xg.to(torch.float32)
        mean = xf.mean(dim=(2, 4), keepdim=True)
        mean2 = (xf * xf).mean(dim=(2, 4), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, g, c // g, 1, 1)
        y = (xg - mean) * mul + self.bias.reshape(1, g, c // g, 1, 1)
        return y.reshape(b, c, h, w).to(dtype)


class PointFeatureNet(nn.Module):
    """Per-point embedding before pillar pooling (PFN-lite): xyz, offset to
    the pillar center, radial distance (and ``extra_dim`` conditioning
    channels, zeros when ``extra`` is None) -> two Dense + relu."""

    def __init__(self, dim: int, dtype: torch.dtype, extra_dim: int = 0):
        super().__init__()
        self.dtype = dtype
        self.extra_dim = extra_dim
        self.dense0 = nn.Linear(7 + extra_dim, dim)
        self.dense1 = nn.Linear(dim, dim)

    def forward(self, points: torch.Tensor, offsets: torch.Tensor,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        xy = points[..., :2]
        r = torch.sqrt((xy * xy).sum(dim=-1, keepdim=True))
        cols = [points[..., :3], offsets, r]
        if self.extra_dim:
            if extra is None:
                extra = torch.zeros((*points.shape[:-1], self.extra_dim),
                                    dtype=self.dtype, device=points.device)
            cols.append(extra.to(r.dtype))
        x = torch.cat(cols, dim=-1).to(self.dtype)
        x = F.relu(_linear(self.dense0, x, self.dtype))
        return F.relu(_linear(self.dense1, x, self.dtype))


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, dtype: torch.dtype, stride: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.conv0 = nn.Conv2d(in_ch, channels, 3)
        self.norm0 = GroupNorm(8, channels)
        self.conv1 = nn.Conv2d(channels, channels, 3)
        self.norm1 = GroupNorm(8, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_same(self.conv0, x, self.stride, self.dtype)
        x = F.relu(self.norm0(x, self.dtype))
        x = _conv_same(self.conv1, x, 1, self.dtype)
        return F.relu(self.norm1(x, self.dtype))


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour upsample of (..., H, W) to (..., h, w). (The JAX
    helper takes channels-last (..., H, W, C); here the spatial axes are
    last, as in NCHW.) Integer factors repeat; other ratios sample at pixel
    centers, like ``jax.image.resize(..., 'nearest')``."""
    xh, xw = x.shape[-2], x.shape[-1]
    if h % xh == 0 and w % xw == 0:
        fy, fx = h // xh, w // xw
        if fy == fx == 1:
            return x
        x = x[..., :, None, :, None].expand(*x.shape[:-2], xh, fy, xw, fx)
        return x.reshape(*x.shape[:-4], h, w)
    lead = x.shape[:-2]
    out = F.interpolate(
        x.reshape(-1, 1, xh, xw).float(), size=(h, w), mode="nearest-exact"
    )
    return out.reshape(*lead, h, w).to(x.dtype)


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H/s, W/s) mean pool."""
    if stride == 1:
        return x
    b, c, h, w = x.shape
    return x.reshape(b, c, h // stride, stride, w // stride, stride).mean(dim=(3, 5))


def _bev_correlation(f0: torch.Tensor, f1: torch.Tensor, radius: int) -> torch.Tensor:
    """Local cost volume between two (B, C, H, W) BEV feature images ->
    (B, (2r+1)^2, H, W): ``corr[:, k] = <f0(y, x), f1(y+dy, x+dx)> / C`` with
    ``k = dy * win + dx`` over the Chebyshev window. ``f1`` is zero-padded,
    so offsets past the border read 0 (no wrap-around)."""
    _, c, h, w = f0.shape
    win = 2 * radius + 1
    f1p = F.pad(f1, (radius, radius, radius, radius))
    cols = []
    for k in range(win * win):
        dy, dx = divmod(k, win)
        shifted = f1p[:, :, dy : dy + h, dx : dx + w]
        cols.append((f0 * shifted).sum(dim=1) / c)
    return torch.stack(cols, dim=1)


class UNet(nn.Module):
    """Pseudo-image backbone with skip connections, on NCHW.

    ``extra_channels`` maps an encoder level to the channel count of the
    feature image concatenated after that level's ConvBlock (the correlation
    volumes). ``aux_channels`` appends un-activated channels to the final
    conv; forward then returns ``(features, aux)``."""

    def __init__(
        self,
        in_channels: int,
        depths: Sequence[int],
        out_channels: int,
        dtype: torch.dtype,
        aux_channels: int = 0,
        extra_channels: Optional[dict] = None,
    ):
        super().__init__()
        extra_channels = extra_channels or {}
        self.dtype = dtype
        self.out_channels = out_channels
        self.aux_channels = aux_channels
        down, skip_ch, ch_in = [], [], in_channels
        for li, ch in enumerate(depths):
            down.append(ConvBlock(ch_in, ch, dtype, stride=2))
            ch_in = ch + extra_channels.get(li, 0)
            skip_ch.append(ch_in)
        up = []
        for i, (ch, sc) in enumerate(zip(reversed(depths), reversed(skip_ch))):
            up.append(ConvBlock(ch_in if i == 0 else ch_in + sc, ch, dtype))
            ch_in = ch
        self.down = nn.ModuleList(down)
        self.up = nn.ModuleList(up)
        self.head = nn.Conv2d(ch_in, out_channels + aux_channels, 3)

    def forward(self, x: torch.Tensor, extra: Optional[dict] = None):
        skips = []
        for li, block in enumerate(self.down):
            x = block(x)
            if extra is not None and li in extra:
                x = torch.cat([x, extra[li].to(x.dtype)], dim=1)
            skips.append(x)
        for i, (block, skip) in enumerate(zip(self.up, reversed(skips))):
            if i > 0:
                x = _upsample_nearest(x, skip.shape[-2], skip.shape[-1])
                x = torch.cat([x, skip], dim=1)
            x = block(x)
        x = _upsample_nearest(x, x.shape[-2] * 2, x.shape[-1] * 2)
        x = _conv_same(self.head, x, 1, self.dtype)
        if self.aux_channels:
            return F.relu(x[:, : self.out_channels]), x[:, self.out_channels :]
        return F.relu(x)


class DeFlowGRUDecoder(nn.Module):
    """Iterative voxel-to-point refinement (DeFlow-style GRU).

    The GRU is flax's ``GRUCell`` in ``nn.GRUCell``'s parameter layout:
    ``r = sigmoid(W_ir x + b_ir + W_hr h)``, ``z = sigmoid(W_iz x + b_iz +
    W_hz h)``, ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``,
    ``h' = (1 - z) n + z h`` — ``bias_hh`` is (0, 0, b_hn): its first two
    thirds are held at 0 in the forward, so they get no gradient and flax's
    parameter set is what trains. With ``gate=True`` the head emits (flow
    xyz, gate logit)."""

    def __init__(
        self, pillar_dim: int, point_dim: int, hidden: int, iters: int,
        dtype: torch.dtype, gate: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.iters = iters
        self.gate = gate
        self.pillar_in = nn.Linear(pillar_dim, hidden)
        self.point_in = nn.Linear(point_dim, hidden)
        self.gru = nn.GRUCell(hidden, hidden)
        self.hidden = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 4 if gate else 3)

    def forward(self, pillar_feat: torch.Tensor, point_feat: torch.Tensor):
        dt = self.dtype
        h = _linear(self.pillar_in, pillar_feat, dt)
        inp = _linear(self.point_in, point_feat, dt)
        gi = F.linear(inp, self.gru.weight_ih.to(dt), self.gru.bias_ih.to(dt))
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        b_hn = self.gru.bias_hh[2 * self.gru.hidden_size :]
        b_hh = torch.cat([torch.zeros_like(b_hn), torch.zeros_like(b_hn), b_hn])
        w_hh, b_hh = self.gru.weight_hh.to(dt), b_hh.to(dt)
        for _ in range(self.iters):
            h_r, h_z, h_n = F.linear(h, w_hh, b_hh).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
        x = F.relu(_linear(self.hidden, h, dt))
        out = _linear(self.out, x, torch.float32)
        return (out[..., :3], out[..., 3]) if self.gate else out


class LinearDecoder(nn.Module):
    """FastFlow3D-style MLP decoder."""

    def __init__(
        self, pillar_dim: int, point_dim: int, hidden: int,
        dtype: torch.dtype, gate: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.gate = gate
        self.dense0 = nn.Linear(pillar_dim + point_dim, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 4 if gate else 3)

    def forward(self, pillar_feat: torch.Tensor, point_feat: torch.Tensor):
        x = torch.cat([pillar_feat, point_feat.to(pillar_feat.dtype)], dim=-1)
        x = F.relu(_linear(self.dense0, x, self.dtype))
        x = F.relu(_linear(self.dense1, x, self.dtype))
        out = _linear(self.out, x, torch.float32)
        return (out[..., :3], out[..., 3]) if self.gate else out


def _corr_extra_channels(cfg: FlowNetConfig) -> dict:
    if not cfg.corr_volume:
        return {}
    fine = (2 * cfg.corr_radii[0] + 1) ** 2
    coarse = (2 * cfg.corr_radii[1] + 1) ** 2
    last = len(cfg.depths) - 1
    return {0: fine + coarse} if last == 0 else {0: fine, last: coarse}


class SceneFlowNet(nn.Module):
    """Full network: pillars -> UNet -> per-point flow for sweep 0."""

    def __init__(self, config: FlowNetConfig):
        super().__init__()
        cfg = config
        if cfg.instance_head and not cfg.gate_head:
            raise ValueError("instance_head requires gate_head")
        self.config = cfg
        dtype = _torch_dtype(cfg.dtype)
        self.dtype = dtype
        hidden = cfg.base_channels * 2
        self.pfn = PointFeatureNet(cfg.point_feat_dim, dtype,
                                   extra_dim=3 if cfg.prior_feat else 0)
        self.unet = UNet(
            cfg.num_frames * cfg.point_feat_dim, cfg.depths, hidden, dtype,
            aux_channels=1 if cfg.instance_head else 0,
            extra_channels=_corr_extra_channels(cfg),
        )
        if cfg.decoder == "deflow":
            self.decoder = DeFlowGRUDecoder(
                hidden, cfg.point_feat_dim, hidden, cfg.gru_iters, dtype,
                gate=cfg.gate_head,
            )
        else:
            self.decoder = LinearDecoder(
                hidden, cfg.point_feat_dim, hidden, dtype, gate=cfg.gate_head
            )

    def _pool_sorted(self, pc: torch.Tensor, grid, extra=None):
        """``pooling='mean_sorted'`` for one sweep: the points reordered by
        a stable sort of their pillar ids, the PFN on them (points out of
        range zeroed), and the per-pillar mean from one sorted sum (K10) of
        the fp32 features with a count column, divided in fp32 and then cast
        to the model dtype. Returns the (B, H, W, C) image, the sorted point
        features and ``(order, sorted ids)``."""
        h, w = self.config.pillar.grid_shape
        spids, order = _stable_sort(grid.pillar_ids)
        in_s = torch.gather(grid.in_range, 1, order.long())
        f = self.pfn(_take_rows_at(pc[..., :3], order),
                     _take_rows_at(grid.centers_offset, order),
                     None if extra is None else _take_rows_at(extra, order))
        f = torch.where(in_s[..., None], f, torch.zeros_like(f))
        aug = torch.cat([f.to(torch.float32), in_s.to(torch.float32)[..., None]], dim=-1)
        out = scatter_sum_sorted(spids, aug, num_rows=h * w,
                                 mxu_bf16=self.dtype == torch.bfloat16)
        img = out[..., :-1] / torch.clamp(out[..., -1:], min=1.0)
        return img.reshape(-1, h, w, img.shape[-1]).to(self.dtype), f, (order, spids)

    def forward(
        self, sweeps, valids, prior=None, with_gate: bool = False,
        soft_gate: bool = False, with_aux: bool = False,
        refine: Optional[bool] = None, dts=None,
    ):
        """
        Args:
            sweeps: tuple of (B, N_i, 3) clouds — (pc0_comp, pc1[, pc_hist]);
                flow is predicted for sweeps[0].
            valids: matching (B, N_i) validity masks.
            prior: optional (B, N_0, 3) translation prior for sweep 0
                (``prior_feat``: zeros when absent; ``prior_residual`` and
                ``prior_trust`` compose it after the gate).
            with_gate: also return the gate LOGITS; requires ``gate_head``.
            soft_gate: multiply flow by sigmoid(gate) instead of the hard cut.
            with_aux: return ``(flow, aux)`` with ``gate_logit``,
                ``dyn_logit`` (B, H, W) and ``slot`` (B, N, -1 = none).
            refine: run the per-slot refinement (``refine_head``);
                defaults to ``not soft_gate``.
            dts: optional ``(dt0, dt1)`` per-point sweep times (B, N_i).
        """
        cfg = self.config
        dtype = self.dtype
        h, w = cfg.pillar.grid_shape

        sorted_mode = cfg.pooling == "mean_sorted"
        grids, feats, images = [], [], []
        sweep0 = None  # (order, sorted pillar ids) of sweep 0, for the decoder
        for idx, (pc, valid) in enumerate(zip(sweeps, valids)):
            grid = voxelize_pillars(pc, valid, cfg.pillar)
            extra = None
            if cfg.prior_feat and idx == 0 and prior is not None:
                extra = prior.to(dtype)
            if sorted_mode:
                img, f, sort = self._pool_sorted(pc, grid, extra)
                images.append(img)
                if idx == 0:
                    sweep0 = sort
            else:
                f = self.pfn(pc, grid.centers_offset, extra)
                f = torch.where(grid.in_range[..., None], f, torch.zeros_like(f))
            grids.append(grid)
            feats.append(f)
        if not sorted_mode:
            images = scatter_max_multi(feats, grids)

        # (B, H, W, C) per sweep -> NCHW for the backbone.
        images = [im.permute(0, 3, 1, 2) for im in images]
        x = torch.cat(images, dim=1).to(dtype)
        extra = None
        if cfg.corr_volume:
            f0, f1 = images[0].to(dtype), images[1].to(dtype)
            last = len(cfg.depths) - 1
            fine = _bev_correlation(
                _avg_pool(f0, 2), _avg_pool(f1, 2), cfg.corr_radii[0]
            )
            coarse = _bev_correlation(
                _avg_pool(f0, 2 ** (last + 1)),
                _avg_pool(f1, 2 ** (last + 1)),
                cfg.corr_radii[1],
            )
            if last == 0:
                extra = {0: torch.cat([fine, coarse], dim=1)}
            else:
                extra = {0: fine, last: coarse}

        slot_img = None
        dyn_logit = None
        if cfg.instance_head:
            out_img, dyn_raw = self.unet(x, extra)
            dyn_logit = dyn_raw[:, 0].to(torch.float32)  # (B, H, W)
            s = cfg.instance_stride
            occ = F.max_pool2d(dyn_logit[:, None], s, stride=s)[:, 0] > 0.0
            labels = connected_components_grid(
                occ, iters=cfg.instance_iters, reach=cfg.instance_reach
            )
            slot_enc, _ = component_slots(labels, cfg.instance_slots)
            # slot+1 encoding (0 = none) survives the zero-masked gather;
            # values <= instance_slots stay exact even through bf16.
            slot_img = _upsample_nearest(slot_enc.to(torch.float32), h, w)
        else:
            out_img = self.unet(x, extra)

        if sorted_mode:
            # fp32 (B, H*W, C) rows (+ the slot channel) gathered at sweep
            # 0's sorted ids: ids past the grid read 0, where the reference
            # reads the 8 zero rows it appends.
            flat = out_img.permute(0, 2, 3, 1).reshape(out_img.shape[0], h * w, -1)
            flat = flat.to(torch.float32)
            if slot_img is not None:
                flat = torch.cat([flat, slot_img.reshape(-1, h * w, 1)], dim=-1)
            gathered = gather_rows_sorted(sweep0[1], flat, num_rows=h * w,
                                          mxu_bf16=dtype == torch.bfloat16)
        else:
            img = out_img
            if slot_img is not None:
                img = torch.cat([out_img, slot_img[:, None].to(out_img.dtype)], dim=1)
            gathered = gather_pillars(img.permute(0, 2, 3, 1), grids[0])
        slot_pt = None
        if slot_img is not None:
            pillar_feat = gathered[..., :-1].to(dtype)
            slot_pt = gathered[..., -1].to(torch.float32)
        else:
            pillar_feat = gathered.to(dtype)

        out = self.decoder(pillar_feat, feats[0])
        gate_logit = None
        if cfg.gate_head:
            flow, gate_logit = out
        else:
            flow = out
        flow = flow.to(torch.float32)
        if sorted_mode:
            # Back to input point order with one row take at the inverse
            # permutation (the reference's argsort of the order), whose
            # backward is the K3 sum.
            order = sweep0[0].long()
            inv = torch.empty_like(order).scatter_(
                1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
            cols = [flow] + [t[..., None] for t in (gate_logit, slot_pt) if t is not None]
            cols = take_rows(torch.cat(cols, dim=-1), inv)
            flow = cols[..., :3]
            if gate_logit is not None:
                gate_logit = cols[..., 3]
            if slot_pt is not None:
                slot_pt = cols[..., -1]

        slot = None
        gate_w = None
        if cfg.instance_head:
            slot = torch.round(slot_pt).to(torch.int32) - 1  # -1 = none
            slot = torch.where(grids[0].in_range, slot, torch.full_like(slot, -1))
            gate_w = (
                torch.sigmoid(gate_logit)
                if soft_gate
                else (gate_logit > 0.0).to(torch.float32)
            )
            pooled, ok = pool_by_slot(
                flow, gate_w, slot, cfg.instance_slots, cfg.instance_min_pts
            )
            flow = torch.where(ok[..., None], pooled, flow)
        if cfg.gate_head:
            if soft_gate:
                flow = flow * torch.sigmoid(gate_logit)[..., None]
            else:
                flow = torch.where(
                    (gate_logit > 0.0)[..., None], flow, torch.zeros_like(flow)
                )
        covered = None
        if cfg.prior_residual and prior is not None:
            p32 = prior.to(torch.float32)
            covered = (p32.abs() > 1e-6).any(dim=-1, keepdim=True)
            if cfg.prior_trust:
                # flow = prior where covered, gated residual elsewhere.
                flow = torch.where(covered, p32, flow)
            else:
                flow = flow + p32  # flow = prior + gated residual
        if (
            cfg.instance_head
            and cfg.refine_head
            and (refine if refine is not None else not soft_gate)
        ):
            # Confident slots emit the refined translation, overriding the
            # pooled mean, the gate and the prior; covered points count as
            # open gates.
            w0 = gate_w
            if covered is not None:
                w0 = torch.maximum(w0, covered[..., 0].to(torch.float32))
            flow = refine_flow(
                flow, sweeps[0][..., :3].to(torch.float32), slot, valids[0],
                w0, sweeps[1][..., :3].to(torch.float32), valids[1],
                dyn_logit, grids[1].pillar_ids, grids[1].in_range,
                cfg.instance_slots, cfg.refine,
                dt0=None if dts is None else dts[0],
                dt1=None if dts is None else dts[1],
            )
        flow = torch.where(valids[0][..., None], flow, torch.zeros_like(flow))
        if with_aux:
            aux = {}
            if gate_logit is not None:
                aux["gate_logit"] = gate_logit.to(torch.float32)
            if dyn_logit is not None:
                aux["dyn_logit"] = dyn_logit
            if slot is not None:
                aux["slot"] = slot
            return flow, aux
        if with_gate:
            if gate_logit is None:
                raise ValueError("with_gate=True requires config.gate_head")
            return flow, gate_logit.to(torch.float32)
        return flow


_PRESETS = {
    "fastflow3d": dict(decoder="linear", num_frames=2),
    "deflow": dict(decoder="deflow", num_frames=2),
    "deflowpp": dict(decoder="deflow", num_frames=3),
    "seflowpp": dict(
        decoder="deflow", num_frames=3, gate_head=True, instance_head=True,
        corr_volume=True, refine_head=True,
    ),
    "seflowpp_noprior": dict(
        decoder="deflow", num_frames=3, gate_head=True, corr_volume=True,
    ),
    # The offline / labelling hybrid: the host cluster prior enters as 3
    # PFN channels, as the residual base, and is emitted verbatim on
    # covered points; slots the refine head verifies emit the measured
    # translation instead.
    "seflowpp_trust": dict(
        decoder="deflow", num_frames=3, gate_head=True,
        prior_feat=True, prior_residual=True, prior_trust=True,
        corr_volume=True, instance_head=True, refine_head=True,
    ),
    "seflow": dict(decoder="deflow", num_frames=2, gate_head=True),
    # The prior-conditioned net's older name: feature channels only.
    "seflowpp_prior": dict(decoder="deflow", num_frames=3, prior_feat=True),
}


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device``, or the GPU when it is None; raises when the GPU is asked
    for and CUDA is absent (nothing falls back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run on the CPU"
        )
    return torch.device("cuda")


def make_model(
    name: str, device: torch.device | str | None = None, **overrides
) -> Tuple[SceneFlowNet, FlowNetConfig]:
    """Build a preset network on ``device`` (default: the GPU; see
    :func:`resolve_device`); overrides may be dataclass values OR dotted
    keys into nested configs (``pillar.voxel_size=(0.4, 0.4)``). Parameters
    hold PyTorch's default init until :func:`init_params` or
    ``load_state_dict``."""
    from himo_tpu_torch.utils.config import apply_overrides

    if name not in _PRESETS:
        raise KeyError(f"unknown feed-forward model {name!r}")
    config = FlowNetConfig(**_PRESETS[name])
    if overrides:
        config = apply_overrides(config, overrides)
    model = SceneFlowNet(config)
    return model.to(resolve_device(device)), config


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, scaled to
    variance 1/fan_in (0.8796... is the std of the unit truncated normal)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(t.shape, dtype=torch.float32)
    nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    with torch.no_grad():
        t.copy_(tmp)


def init_params(model: SceneFlowNet, generator: torch.Generator) -> dict:
    """Draw flax's initialisation from ``generator`` (a CPU generator; values
    are copied to the model's device): lecun-normal Dense/Conv/GRU-input
    kernels, orthogonal GRU recurrent kernels (one block per gate), zero
    biases, GroupNorm scale 1 and bias 0. Returns the state dict."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Conv2d):
            fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
            _lecun_normal_(module.weight, fan_in, generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, GroupNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.GRUCell):
            hid = module.hidden_size
            _lecun_normal_(module.weight_ih, module.input_size, generator)
            blocks = []
            for _ in range(3):
                blk = torch.empty(hid, hid, dtype=torch.float32)
                nn.init.orthogonal_(blk, generator=generator)
                blocks.append(blk)
            with torch.no_grad():
                module.weight_hh.copy_(torch.cat(blocks, dim=0))
            nn.init.zeros_(module.bias_ih)
            nn.init.zeros_(module.bias_hh)
    return model.state_dict()


@torch.inference_mode()
def frame(
    model: SceneFlowNet,
    pc0: torch.Tensor,
    pc1: torch.Tensor,
    pc_hist: torch.Tensor,
    valid: torch.Tensor,
    dt0: torch.Tensor,
    prior: Optional[torch.Tensor] = None,
):
    """The de-skew path the JAX bench times, over a batch of frames: flow
    for (B, N, 3) ``pc0`` (with ``pc1`` and the history sweep sharing
    ``valid``, and the prior presets' (B, N, 3) ``prior``), ``dts = (dt0,
    dt0)`` for the refine head's de-smear, then ``comp_dis = flow * dt0 /
    0.1`` and ``refined = pc0 + comp_dis``. Returns ``(flow, comp_dis,
    refined)``."""
    flow = model((pc0, pc1, pc_hist), (valid, valid, valid), prior, dts=(dt0, dt0))
    comp_dis = flow_to_comp_dis(flow, dt0)
    return flow, comp_dis, refine_points(pc0, comp_dis)


def frame_priors(pc0, pc1, valid0, valid1, dt0=None, dt1=None, trackers=None,
                 scene_id=None, pose1=None) -> torch.Tensor:
    """The host cluster prior of each frame of a batch ((B, N, >=3) clouds,
    (B, N) masks), stacked into a (B, N0, 3) float32 tensor on ``pc0``'s
    device: ``models/nsfp.cluster_prior_flow`` at its keyword defaults, as
    the reference's estimator calls it. With ``scene_id`` and ``pose1``
    ((B, 4, 4)) the frames feed ``trackers[scene_id]`` in order."""
    from himo_tpu_torch.models.icp_flow import ClusterTracker
    from himo_tpu_torch.models.nsfp import cluster_prior_flow

    tracker = None
    if trackers is not None and scene_id is not None and pose1 is not None:
        tracker = trackers.setdefault(scene_id, ClusterTracker())
    return torch.stack([
        cluster_prior_flow(
            pc0[b], pc1[b], valid0[b], valid1[b],
            dt0=None if dt0 is None else dt0[b],
            dt1=None if dt1 is None else dt1[b],
            tracker=tracker, pose1=None if tracker is None else pose1[b],
        )
        for b in range(pc0.shape[0])
    ])


def load_params(checkpoint, device: torch.device | str | None = None) -> dict:
    """A network's state dict from ``checkpoint``: a checkpoint directory
    the trainer writes (``training/checkpoints``: a step's directory or a
    manager's, which resolves to its latest step; its ``params``), or a
    ``torch.save`` file of the state dict itself. Tensors land on
    ``device`` (default: the CPU)."""
    from pathlib import Path

    location = "cpu" if device is None else device
    if Path(checkpoint).is_dir():
        from himo_tpu_torch.training.checkpoints import load_checkpoint

        return load_checkpoint(checkpoint, map_location=location)["params"]
    return torch.load(checkpoint, map_location=location, weights_only=True)


def _feedforward_estimator(name: str):
    """Registry adapter: the estimator closes over a model whose weights come
    from ``params=`` (a state dict) or ``checkpoint=`` (:func:`load_params`:
    a trainer checkpoint directory or a state-dict file), on ``device``
    (default: the GPU)."""

    def factory(
        checkpoint: Optional[str] = None, params: Optional[dict] = None,
        device: torch.device | str | None = None, **overrides,
    ):
        if params is None and checkpoint is None:
            raise ValueError(
                f"feed-forward estimator {name!r} needs checkpoint= or params="
            )
        model, config = make_model(name, device=device, **overrides)
        if params is None:
            params = load_params(checkpoint, next(model.parameters()).device)
        model.load_state_dict(params)
        model.eval()
        trackers = {}  # per-scene velocity continuity for the prior channel

        @torch.inference_mode()
        def estimate(pc0, pc1, valid0, valid1, key=None, history=None,
                     dt0=None, dt1=None, scene_id=None, pose1=None):
            """Flow for ``pc0``: clouds (N, >=3) or batched (B, N, >=3),
            masks to match. Returns ``(flow, 0)`` like the JAX estimator.
            The prior presets compute each frame's host cluster prior
            (``models/nsfp.cluster_prior_flow``); with ``scene_id`` and
            ``pose1`` (per frame: (4, 4), or (B, 4, 4) batched) the
            frames, in order, share that scene's ``ClusterTracker``."""
            single = pc0.dim() == 2
            if single:
                pc0, pc1, valid0, valid1 = (
                    t[None] for t in (pc0, pc1, valid0, valid1)
                )
                if history is not None:
                    history = (history[0][None], history[1][None])
                if dt0 is not None:
                    dt0 = dt0[None]
                if dt1 is not None:
                    dt1 = dt1[None]
                if pose1 is not None:
                    pose1 = pose1[None]
            prior = None
            if config.prior_feat:
                prior = frame_priors(pc0, pc1, valid0, valid1, dt0, dt1,
                                     trackers, scene_id, pose1)
            sweeps = [pc0[..., :3], pc1[..., :3]]
            valids = [valid0, valid1]
            if config.num_frames >= 3:
                if history is None:
                    sweeps.append(torch.zeros_like(pc0[..., :3]))
                    valids.append(torch.zeros_like(valid0))
                else:
                    sweeps.append(history[0][..., :3])
                    valids.append(history[1])
            dts = None
            if config.refine_head and dt0 is not None and dt1 is not None:
                dts = (dt0, dt1)
            flow = model(tuple(sweeps), tuple(valids), prior, dts=dts)
            if single:
                flow = flow[0]
            return flow, torch.zeros((), device=flow.device)

        estimate.num_frames = config.num_frames
        estimate.trackers = trackers
        return estimate

    return factory


for _name in _PRESETS:
    register_estimator(_name)(_feedforward_estimator(_name))
