"""Plain PyTorch reference of the ``seflowpp`` network and its de-skew.

A frozen, self-contained copy of the arithmetic of the program's
feed-forward network (pillar encoder, max pooling, BEV correlation, UNet,
dynamic image, connected components and slots, gate, GRU decoder, slot
pooling, the refine head's trimmed ICP and null test) with no kernel, no
route choice and no fused sweep: every pooling is ``scatter_reduce``, every
nearest-neighbour search ``torch.cdist`` in blocks. It runs in the
precision the configuration states (a bf16 backbone, float32 heads; TF32
off), and imports nothing of the program. Parameter names follow the
program's state dict, so the benchmark can hand both the same weights.

``fp8_backbone=True`` rounds every backbone layer's operands to
float8 e4m3 before the product: the control, one precision below the
configuration's bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SENTINEL = 1.0e6  # coordinates of invalid rows in a nearest-neighbour search
NN_PAIRS = 1 << 28  # (query, reference) pairs per block of a search


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    num_query: int = 4096
    num_ref: int = 8192
    taus: Tuple[float, ...] = (2.0, 1.2, 0.8, 0.5, 0.4, 0.35, 0.3, 0.3)
    accel_iters: Tuple[int, ...] = (3, 6)
    min_inliers: float = 6.0
    cap: float = 1.0
    accept: float = 0.35
    null_margin: float = 1.15
    null_abs: float = 0.03
    snap_delta: float = 0.04
    dilate_cells: int = 24
    dilate_pool: int = 4


@dataclasses.dataclass(frozen=True)
class NetConfig:
    x_range: Tuple[float, float] = (-51.2, 51.2)
    y_range: Tuple[float, float] = (-51.2, 51.2)
    z_range: Tuple[float, float] = (-3.0, 3.0)
    voxel_size: Tuple[float, float] = (0.2, 0.2)
    point_feat_dim: int = 32
    base_channels: int = 32
    depths: Tuple[int, ...] = (64, 128, 256)
    gru_iters: int = 4
    num_frames: int = 3
    dtype: str = "bfloat16"
    instance_stride: int = 2
    instance_reach: int = 2
    instance_iters: int = 24
    instance_slots: int = 128
    instance_min_pts: float = 5.0
    corr_radii: Tuple[int, int] = (4, 3)
    refine: RefineConfig = RefineConfig()

    @property
    def grid_shape(self) -> Tuple[int, int]:
        h = round((self.y_range[1] - self.y_range[0]) / self.voxel_size[1])
        w = round((self.x_range[1] - self.x_range[0]) / self.voxel_size[0])
        return h, w


def net_config(model: dict) -> NetConfig:
    """A :class:`NetConfig` from a configuration file's ``model`` object
    (the program's ``FlowNetConfig`` keys; ``pillar`` and ``refine`` nested)."""
    flat = {}
    for key, value in model.items():
        if key == "pillar":
            flat.update({k: tuple(v) for k, v in value.items()})
        elif key == "refine":
            flat["refine"] = RefineConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in value.items()})
        elif key in {f.name for f in dataclasses.fields(NetConfig)}:
            flat[key] = tuple(value) if isinstance(value, list) else value
    return NetConfig(**flat)


# ------------------------------------------------------------ precision


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (saturating at its largest finite
    value) and back to its own dtype; the gradient passes straight
    through the rounding."""
    big = torch.finfo(torch.float8_e4m3fn).max
    with torch.no_grad():
        rounded = torch.clamp(x.float(), -big, big).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Precision:
    """The backbone's dtype, and whether its operands are rounded to fp8."""

    def __init__(self, dtype: torch.dtype, fp8: bool = False):
        self.dtype, self.fp8 = dtype, fp8

    def operands(self, *xs):
        xs = tuple(x.to(self.dtype) for x in xs)
        return tuple(_fp8(x) for x in xs) if self.fp8 else xs


def _linear(layer: nn.Linear, x, prec: Precision, dtype=None):
    """``x W^T + b`` with inputs and parameters cast to the layer's dtype;
    ``dtype=float32`` for the output layers, which stay exact."""
    if dtype is not None:
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    xx, w = prec.operands(x, layer.weight)
    return F.linear(xx, w, layer.bias.to(prec.dtype))


def _same_pads(size: int, stride: int, kernel: int = 3):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x, stride: int, prec: Precision):
    """XLA-style 'SAME' convolution: a 3x3 kernel at stride 2 on an even
    size pads (0, 1)."""
    kh, kw = conv.kernel_size
    (ty, by), (lx, rx) = _same_pads(x.shape[-2], stride, kh), _same_pads(x.shape[-1], stride, kw)
    xx, w = prec.operands(x, conv.weight)
    b = conv.bias.to(prec.dtype)
    if ty == by and lx == rx:
        return F.conv2d(xx, w, b, stride=stride, padding=(ty, lx))
    return F.conv2d(F.pad(xx, (lx, rx, ty, by)), w, b, stride=stride)


class GroupNorm(nn.Module):
    """Group norm with statistics per (frame, row, group) over W and the
    group's channels, in float32, ``var = max(E[x^2] - E[x]^2, 0)``, eps 1e-6."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, dtype):
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
    def __init__(self, dim: int):
        super().__init__()
        self.dense0 = nn.Linear(7, dim)
        self.dense1 = nn.Linear(dim, dim)

    def forward(self, points, offsets, prec: Precision):
        xy = points[..., :2]
        r = torch.sqrt((xy * xy).sum(dim=-1, keepdim=True))
        x = torch.cat([points[..., :3], offsets, r], dim=-1).to(prec.dtype)
        x = F.relu(_linear(self.dense0, x, prec))
        return F.relu(_linear(self.dense1, x, prec))


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv0 = nn.Conv2d(in_ch, channels, 3)
        self.norm0 = GroupNorm(8, channels)
        self.conv1 = nn.Conv2d(channels, channels, 3)
        self.norm1 = GroupNorm(8, channels)

    def forward(self, x, prec: Precision):
        x = F.relu(self.norm0(_conv_same(self.conv0, x, self.stride, prec), prec.dtype))
        return F.relu(self.norm1(_conv_same(self.conv1, x, 1, prec), prec.dtype))


def _upsample_nearest(x, h: int, w: int):
    xh, xw = x.shape[-2], x.shape[-1]
    fy, fx = h // xh, w // xw
    if fy == fx == 1:
        return x
    x = x[..., :, None, :, None].expand(*x.shape[:-2], xh, fy, xw, fx)
    return x.reshape(*x.shape[:-4], h, w)


def _avg_pool(x, stride: int):
    if stride == 1:
        return x
    b, c, h, w = x.shape
    return x.reshape(b, c, h // stride, stride, w // stride, stride).mean(dim=(3, 5))


def _bev_correlation(f0, f1, radius: int):
    """(B, (2r+1)^2, H, W) local cost volume, ``<f0(y,x), f1(y+dy,x+dx)> / C``,
    f1 zero-padded."""
    _, c, h, w = f0.shape
    win = 2 * radius + 1
    f1p = F.pad(f1, (radius, radius, radius, radius))
    cols = []
    for k in range(win * win):
        dy, dx = divmod(k, win)
        cols.append((f0 * f1p[:, :, dy:dy + h, dx:dx + w]).sum(dim=1) / c)
    return torch.stack(cols, dim=1)


class UNet(nn.Module):
    def __init__(self, in_channels, depths, out_channels, extra_channels):
        super().__init__()
        self.out_channels = out_channels
        down, skip_ch, ch_in = [], [], in_channels
        for li, ch in enumerate(depths):
            down.append(ConvBlock(ch_in, ch, stride=2))
            ch_in = ch + extra_channels.get(li, 0)
            skip_ch.append(ch_in)
        up = []
        for i, (ch, sc) in enumerate(zip(reversed(depths), reversed(skip_ch))):
            up.append(ConvBlock(ch_in if i == 0 else ch_in + sc, ch))
            ch_in = ch
        self.down = nn.ModuleList(down)
        self.up = nn.ModuleList(up)
        self.head = nn.Conv2d(ch_in, out_channels + 1, 3)

    def forward(self, x, extra, prec: Precision):
        skips = []
        for li, block in enumerate(self.down):
            x = block(x, prec)
            if li in extra:
                x = torch.cat([x, extra[li].to(x.dtype)], dim=1)
            skips.append(x)
        for i, (block, skip) in enumerate(zip(self.up, reversed(skips))):
            if i > 0:
                x = torch.cat([_upsample_nearest(x, skip.shape[-2], skip.shape[-1]), skip], dim=1)
            x = block(x, prec)
        x = _upsample_nearest(x, x.shape[-2] * 2, x.shape[-1] * 2)
        x = _conv_same(self.head, x, 1, prec)
        return F.relu(x[:, :self.out_channels]), x[:, self.out_channels:]


class GRUDecoder(nn.Module):
    """DeFlow's GRU refinement in ``nn.GRUCell``'s layout with the first two
    thirds of ``bias_hh`` held at 0; the head emits (flow xyz, gate logit)."""

    def __init__(self, pillar_dim, point_dim, hidden, iters):
        super().__init__()
        self.iters = iters
        self.pillar_in = nn.Linear(pillar_dim, hidden)
        self.point_in = nn.Linear(point_dim, hidden)
        self.gru = nn.GRUCell(hidden, hidden)
        self.hidden = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 4)

    def forward(self, pillar_feat, point_feat, prec: Precision):
        h = _linear(self.pillar_in, pillar_feat, prec)
        inp = _linear(self.point_in, point_feat, prec)
        xx, w_ih = prec.operands(inp, self.gru.weight_ih)
        gi = F.linear(xx, w_ih, self.gru.bias_ih.to(prec.dtype))
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        b_hn = self.gru.bias_hh[2 * self.gru.hidden_size:]
        b_hh = torch.cat([torch.zeros_like(b_hn), torch.zeros_like(b_hn), b_hn]).to(prec.dtype)
        for _ in range(self.iters):
            hh, w_hh = prec.operands(h, self.gru.weight_hh)
            h_r, h_z, h_n = F.linear(hh, w_hh, b_hh).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
        x = F.relu(_linear(self.hidden, h, prec))
        out = _linear(self.out, x, prec, dtype=torch.float32)
        return out[..., :3], out[..., 3]


# ------------------------------------------------------------ pillars


def voxelize(points, valid, cfg: NetConfig):
    """(pillar ids (B, N) int64 with ``H*W`` as trash, in-range mask,
    (B, N, 3) offsets from the pillar centre)."""
    h, w = cfg.grid_shape
    xyz = points[..., :3]
    vx, vy = cfg.voxel_size
    ix = torch.floor((xyz[..., 0] - cfg.x_range[0]) / vx).to(torch.int32)
    iy = torch.floor((xyz[..., 1] - cfg.y_range[0]) / vy).to(torch.int32)
    keep = ((ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            & (xyz[..., 2] >= cfg.z_range[0]) & (xyz[..., 2] <= cfg.z_range[1]) & valid)
    flat = torch.where(keep, iy * w + ix, torch.full_like(ix, h * w)).to(torch.int64)
    cx = (ix.to(torch.float32) + 0.5) * vx + cfg.x_range[0]
    cy = (iy.to(torch.float32) + 0.5) * vy + cfg.y_range[0]
    cz = torch.full_like(cx, 0.5 * (cfg.z_range[0] + cfg.z_range[1]))
    return flat, keep, xyz - torch.stack([cx, cy, cz], dim=-1)


class _PillarMax(torch.autograd.Function):
    """(B, rows, C) per-pillar max of (B, N, C) float32 features; empty
    pillars read 0. Its gradient gives every point whose feature equals
    its pillar's max the whole cotangent of that (pillar, channel)."""

    @staticmethod
    def forward(ctx, feats, pids, rows: int):
        b, n, c = feats.shape
        out = torch.full((b, rows + 1, c), float("-inf"), dtype=torch.float32,
                         device=feats.device)
        out.scatter_reduce_(1, pids[..., None].expand(-1, -1, c), feats, "amax")
        out = out[:, :rows]
        out = torch.where(out == float("-inf"), torch.zeros_like(out), out) + 0.0
        ctx.save_for_backward(feats, pids, out)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, pids, out = ctx.saved_tensors
        rows = out.shape[1]
        at = torch.clamp(pids, max=rows - 1)[..., None].expand(-1, -1, feats.shape[-1])
        win = (feats == torch.gather(out, 1, at)) & (pids < rows)[..., None]
        return torch.where(win, torch.gather(g, 1, at), torch.zeros_like(feats)), None, None


def pillar_max(feats, pids, rows: int):
    return _PillarMax.apply(feats.to(torch.float32), pids, rows)


class _TakeRows(torch.autograd.Function):
    """Rows of a (B, R, C) table at (B, N) ids clamped to R - 1; the
    gradient is added up in float32 and cast back to the table's dtype."""

    @staticmethod
    def forward(ctx, table, ids):
        ids = torch.clamp(ids, max=table.shape[1] - 1)
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[1], table.dtype
        return _take(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        b, n, c = g.shape
        out = torch.zeros((b, ctx.rows, c), dtype=torch.float32, device=g.device)
        out.scatter_add_(1, ids[..., None].expand(-1, -1, c), g.to(torch.float32))
        return out.to(ctx.dtype), None


# ------------------------------------------------------------ components


def _window_min(x, reach: int):
    win = 2 * reach + 1
    x = -F.max_pool2d(-x[:, None], (win, 1), stride=1, padding=(reach, 0))
    x = -F.max_pool2d(-x, (1, win), stride=1, padding=(0, reach))
    return x[:, 0]


def connected_components(occ, iters: int, reach: int):
    """(B, H, W) int64 component root (the least flat index), ``H*W`` on empty cells."""
    _, h, w = occ.shape
    cells = torch.arange(h * w, device=occ.device, dtype=torch.float32).reshape(h, w)
    empty = torch.full_like(cells, float(h * w))
    lab = torch.where(occ, cells, empty)
    for _ in range(iters):
        lab = torch.where(occ, _window_min(lab, reach), empty)
    return lab.to(torch.int64)


def component_slots(labels, max_slots: int):
    """(B, H, W) ``slot + 1`` of each cell's component (0: none or over budget)."""
    b, h, w = labels.shape
    flat = labels.reshape(b, h * w)
    occ = flat < h * w
    root = occ & (flat == torch.arange(h * w, device=labels.device))
    rank = torch.cumsum(root.to(torch.int64), dim=1) - 1
    slot_of_cell = torch.where(root & (rank < max_slots), rank + 1, torch.zeros_like(rank))
    enc = torch.where(occ, torch.gather(slot_of_cell, 1, torch.clamp(flat, max=h * w - 1)),
                      torch.zeros_like(flat))
    return enc.reshape(b, h, w)


def slot_onehot(slot, valid, max_slots: int):
    ids = torch.arange(max_slots, device=slot.device)
    return ((slot[..., None] == ids) & valid[..., None]).to(torch.float32)


def pool_by_slot(values, weights, slot, max_slots: int, min_weight: float):
    member = slot >= 0
    onehot = slot_onehot(torch.where(member, slot, torch.zeros_like(slot)), member, max_slots)
    w = weights.to(torch.float32)
    aug = torch.cat([values.to(torch.float32) * w[..., None], w[..., None]], dim=-1)
    sums = torch.bmm(onehot.transpose(1, 2), aug)
    counts = sums[..., -1]
    means = sums[..., :-1] / torch.clamp(counts, min=1e-6)[..., None]
    ok_slot = counts >= min_weight
    pooled = torch.bmm(onehot, torch.where(ok_slot[..., None], means, torch.zeros_like(means)))
    ok = member & (torch.bmm(onehot, ok_slot.to(torch.float32)[..., None])[..., 0] > 0.5)
    return pooled, ok


# ------------------------------------------------------------ nearest neighbours


def _fma_sq(dx, dy, dz):
    """``fma(dz, dz, fma(dy, dy, dx * dx))`` in float32, each fma rounded
    once (through float64, where the products are exact)."""
    s = (dy.double() * dy.double() + (dx * dx).double()).float()
    return (dz.double() * dz.double() + s.double()).float()


def nn_search(q, r, qvalid=None, rvalid=None):
    """Per query of (B, N, 3) against (B, M, 3): the squared distance to
    the nearest reference and its index (the lowest on ties). Invalid
    references sit at ``SENTINEL`` and lose; invalid queries read (0, 0)."""
    q = q[..., :3].to(torch.float32)
    r = r[..., :3].to(torch.float32)
    if qvalid is not None:
        q = torch.where(qvalid[..., None], q, torch.full_like(q, SENTINEL))
    if rvalid is not None:
        r = torch.where(rvalid[..., None], r, torch.full_like(r, SENTINEL))
    block = max(1, NN_PAIRS // (q.shape[0] * r.shape[1]))
    idx = torch.cat([
        torch.cdist(q[:, s:s + block], r, compute_mode="donot_use_mm_for_euclid_dist")
        .argmin(dim=-1) for s in range(0, q.shape[1], block)], dim=1)
    near = torch.gather(r, 1, idx[..., None].expand(-1, -1, 3))
    d = q - near
    d2 = _fma_sq(d[..., 0], d[..., 1], d[..., 2])
    if qvalid is not None:
        d2 = torch.where(qvalid, d2, torch.zeros_like(d2))
        idx = torch.where(qvalid, idx, torch.zeros_like(idx))
    return d2, idx


# ------------------------------------------------------------ refine head


def _take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1))


def select_topk(mask, k: int):
    order = torch.sort(torch.logical_not(mask).to(torch.uint8), dim=-1, stable=True).indices
    idx = order[:, :k]
    return idx, torch.gather(mask, 1, idx)


def dilated_dynamic_mask(dyn_logit, pillar_ids, in_range, reach_cells: int, pool: int):
    b, h, w = dyn_logit.shape
    occ = (dyn_logit > 0.0).to(torch.float32)
    coarse = occ.reshape(b, h // pool, pool, w // pool, pool).amax(dim=(2, 4))
    r = max(1, reach_cells // pool)
    win = 2 * r + 1
    coarse = F.max_pool2d(coarse[:, None], (win, 1), stride=1, padding=(r, 0))
    coarse = F.max_pool2d(coarse, (1, win), stride=1, padding=(0, r))[:, 0]
    pid = pillar_ids
    y = torch.clamp(pid // w, 0, h - 1) // pool
    x = torch.clamp(pid % w, 0, w - 1) // pool
    return (torch.gather(coarse.reshape(b, -1), 1, y * (w // pool) + x) > 0.0) & in_range


def _slot_mean(onehot, values, weights):
    aug = torch.cat([values * weights[..., None], weights[..., None]], dim=-1)
    sums = torch.bmm(onehot.transpose(1, 2), aug)
    mass = sums[..., -1]
    return sums[..., :-1] / torch.clamp(mass, min=1e-6)[..., None], mass


def refine_slot_translations(q, qslot, qvalid, seed, seed_ok, r, rvalid, max_slots,
                             cfg: RefineConfig, qdt, rdt, period: float = 0.1):
    onehot = slot_onehot(qslot, qvalid, max_slots)
    qf, rf = q.to(torch.float32), r.to(torch.float32)
    delta = seed.to(torch.float32)
    qdt, rdt = qdt.to(torch.float32), rdt.to(torch.float32)
    qslot_safe = torch.clamp(qslot, 0, max_slots - 1)
    qvalid_f = qvalid.to(torch.float32)

    d2r, nnq = nn_search(rf, qf + _take(delta, qslot_safe), rvalid, qvalid)
    rslot = torch.gather(qslot_safe, 1, nnq)
    claim_tau = 2.0 * cfg.taus[0]
    rclaimed = rvalid & (d2r < claim_tau * claim_tau)
    rslot = torch.where(rclaimed, rslot, torch.zeros_like(rslot))
    rdesmear_w = rclaimed.to(torch.float32)[..., None] * (rdt[..., None] / period)

    def coords(delta):
        qs = qf + _take(delta, qslot_safe) * (1.0 - qdt[..., None] / period)
        return qs, rf - _take(delta, rslot) * rdesmear_w

    def one_pass(delta):
        qs, rs = coords(delta)
        d2, nn_idx = nn_search(qs, rs, qvalid, rvalid)
        resid = _take(rs, nn_idx) - qs
        ddt = torch.gather(rdt, 1, nn_idx) - qdt
        same = (torch.gather(rslot, 1, nn_idx) == qslot_safe) & torch.gather(rclaimed, 1, nn_idx)
        return d2, resid, ddt, same

    prev_u = None
    for it, tau in enumerate(cfg.taus):
        d2, resid, ddt, same = one_pass(delta)
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
        w0 = (qvalid & same).to(torch.float32)
        m_s, _ = _slot_mean(onehot, torch.clamp(dist, max=cfg.cap)[..., None], w0)
        tau_s = torch.clamp(3.0 * m_s[..., 0], tau, cfg.taus[0])
        w = w0 * (dist < torch.gather(tau_s, 1, qslot_safe)).to(torch.float32)
        w = w * (dist + 0.05)
        z = 1.0 + ddt / period
        aug = torch.cat([resid * z[..., None], (z * z)[..., None], torch.ones_like(z)[..., None]],
                        dim=-1) * w[..., None]
        sums = torch.bmm(onehot.transpose(1, 2), aug)
        e = sums[..., 0:3] / torch.clamp(sums[..., 3], min=1e-6)[..., None]
        _, n_pairs = _slot_mean(onehot, resid, w0)
        ok = (n_pairs >= cfg.min_inliers) & seed_ok
        u = torch.where(ok[..., None], e, torch.zeros_like(e))
        delta = delta + u
        if prev_u is not None and it in cfg.accel_iters:
            dot = (u * prev_u).sum(dim=-1)
            nrm = (prev_u * prev_u).sum(dim=-1)
            alpha = torch.clamp(dot / torch.clamp(nrm, min=1e-8), 0.0, 0.9)
            boost = torch.clamp(u * (alpha / (1.0 - alpha))[..., None], -1.0, 1.0)
            delta = delta + boost
            u = u + boost
        prev_u = u

    qs_f, rs_f = coords(delta)
    d2_f, _ = nn_search(qs_f, rs_f, qvalid, rvalid)
    rcap = torch.clamp(torch.sqrt(torch.clamp(d2_f, min=0.0)), max=cfg.cap)
    md, mass_f = _slot_mean(onehot, rcap[..., None], qvalid_f)
    md = md[..., 0]
    d2_0, resid0, ddt0, same0 = one_pass(torch.zeros_like(delta))
    r0 = torch.clamp(torch.sqrt(torch.clamp(d2_0, min=0.0)), max=cfg.cap)
    m0 = _slot_mean(onehot, r0[..., None], qvalid_f)[0][..., 0]
    dist0 = torch.sqrt(torch.clamp(d2_0, min=0.0))
    w0n = (qvalid & same0).to(torch.float32) * (dist0 < cfg.taus[0]).to(torch.float32)
    z0 = 1.0 + ddt0 / period
    aug0 = torch.cat([resid0 * z0[..., None], (z0 * z0)[..., None]], dim=-1) * w0n[..., None]
    sums0 = torch.bmm(onehot.transpose(1, 2), aug0)
    e0 = sums0[..., 0:3] / torch.clamp(sums0[..., 3], min=1e-6)[..., None]
    null_fixed = _norm(e0) <= torch.clamp(0.5 * _norm(delta), min=cfg.snap_delta)

    conf = seed_ok & (mass_f >= cfg.min_inliers) & (md < cfg.accept)
    small = _norm(delta) < cfg.snap_delta
    null_wins = (m0 <= md * cfg.null_margin + cfg.null_abs) & null_fixed
    snapped = conf & (small | null_wins)
    return torch.where(snapped[..., None], torch.zeros_like(delta), delta), conf


def refine_flow(flow, p0, slot, valid0, weight0, p1, valid1, dyn_logit, pillar_ids1,
                in_range1, max_slots, cfg: RefineConfig, dt0, dt1):
    member = (slot >= 0) & valid0
    idx0, qvalid = select_topk(member, cfg.num_query)
    q = _take(p0, idx0)
    qslot = torch.clamp(torch.gather(slot, 1, idx0), 0, max_slots - 1)
    onehot = slot_onehot(qslot, qvalid, max_slots)
    seed, seed_mass = _slot_mean(onehot, _take(flow, idx0).to(torch.float32),
                                 torch.gather(weight0, 1, idx0))
    ref_mask = dilated_dynamic_mask(dyn_logit, pillar_ids1, in_range1, cfg.dilate_cells,
                                    cfg.dilate_pool) & valid1
    idx1, rvalid = select_topk(ref_mask, cfg.num_ref)
    delta, conf = refine_slot_translations(
        q, qslot, qvalid, seed, seed_mass >= cfg.min_inliers, _take(p1, idx1), rvalid,
        max_slots, cfg, torch.gather(dt0, 1, idx0), torch.gather(dt1, 1, idx1))
    safe = torch.clamp(slot, 0, max_slots - 1)
    use = member & torch.gather(conf, 1, safe)
    return torch.where(use[..., None], _take(delta, safe), flow)


# ------------------------------------------------------------ the network


def _corr_channels(cfg: NetConfig) -> dict:
    fine = (2 * cfg.corr_radii[0] + 1) ** 2
    coarse = (2 * cfg.corr_radii[1] + 1) ** 2
    last = len(cfg.depths) - 1
    return {0: fine + coarse} if last == 0 else {0: fine, last: coarse}


class SeFlowPP(nn.Module):
    """The ``seflowpp`` network in inference: three sweeps, the gate, the
    instance head with its slots, the GRU decoder and the refine head."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.config = cfg
        hidden = cfg.base_channels * 2
        self.pfn = PointFeatureNet(cfg.point_feat_dim)
        self.unet = UNet(cfg.num_frames * cfg.point_feat_dim, cfg.depths, hidden,
                         _corr_channels(cfg))
        self.decoder = GRUDecoder(hidden, cfg.point_feat_dim, hidden, cfg.gru_iters)

    def backbone(self, sweeps, valids, prec: Precision):
        """Pillars of every sweep, the UNet's features and the dynamic
        image's logits: ``(grids, point features, features, dyn_logit)``."""
        cfg = self.config
        dtype = prec.dtype
        h, w = cfg.grid_shape
        grids, feats, images = [], [], []
        for pc, valid in zip(sweeps, valids):
            pids, keep, offsets = voxelize(pc, valid, cfg)
            f = self.pfn(pc, offsets, prec)
            f = torch.where(keep[..., None], f, torch.zeros_like(f))
            img = pillar_max(f, pids, h * w).reshape(pc.shape[0], h, w, -1).to(f.dtype)
            grids.append((pids, keep))
            feats.append(f)
            images.append(img.permute(0, 3, 1, 2))
        x = torch.cat(images, dim=1).to(dtype)
        f0, f1 = images[0].to(dtype), images[1].to(dtype)
        last = len(cfg.depths) - 1
        fine = _bev_correlation(_avg_pool(f0, 2), _avg_pool(f1, 2), cfg.corr_radii[0])
        coarse = _bev_correlation(_avg_pool(f0, 2 ** (last + 1)), _avg_pool(f1, 2 ** (last + 1)),
                                  cfg.corr_radii[1])
        extra = {0: torch.cat([fine, coarse], dim=1)} if last == 0 else {0: fine, last: coarse}

        out_img, dyn_raw = self.unet(x, extra, prec)
        return grids, feats, out_img, dyn_raw[:, 0].to(torch.float32)

    def forward(self, sweeps, valids, dts=None, fp8_backbone: bool = False,
                train: bool = False):
        """The flow of sweep 0. ``train`` is the SSL step's forward: the
        soft gate (the flow times the gate's sigmoid, which also weighs the
        slot pooling), no refine head, and ``(flow, gate_logit,
        dyn_logit)`` returned."""
        cfg = self.config
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        prec = Precision(dtype, fp8_backbone)
        h, w = cfg.grid_shape
        grids, feats, out_img, dyn_logit = self.backbone(sweeps, valids, prec)
        s = cfg.instance_stride
        occ = F.max_pool2d(dyn_logit[:, None], s, stride=s)[:, 0] > 0.0
        labels = connected_components(occ, cfg.instance_iters, cfg.instance_reach)
        slot_enc = component_slots(labels, cfg.instance_slots)
        slot_img = _upsample_nearest(slot_enc.to(torch.float32), h, w)

        img = torch.cat([out_img, slot_img[:, None].to(out_img.dtype)], dim=1)
        flat = img.permute(0, 2, 3, 1).reshape(img.shape[0], h * w, -1)
        pids0, keep0 = grids[0]
        gathered = _TakeRows.apply(flat, pids0)
        gathered = torch.where(keep0[..., None], gathered, torch.zeros_like(gathered))
        pillar_feat = gathered[..., :-1].to(dtype)
        slot_pt = gathered[..., -1].to(torch.float32)

        flow, gate_logit = self.decoder(pillar_feat, feats[0], prec)
        flow = flow.to(torch.float32)
        slot = torch.round(slot_pt).to(torch.int64) - 1
        slot = torch.where(keep0, slot, torch.full_like(slot, -1))
        gate_w = torch.sigmoid(gate_logit) if train else (gate_logit > 0.0).to(torch.float32)
        pooled, ok = pool_by_slot(flow, gate_w, slot, cfg.instance_slots, cfg.instance_min_pts)
        flow = torch.where(ok[..., None], pooled, flow)
        if train:
            flow = flow * torch.sigmoid(gate_logit)[..., None]
            flow = torch.where(valids[0][..., None], flow, torch.zeros_like(flow))
            return flow, gate_logit.to(torch.float32), dyn_logit
        flow = torch.where((gate_logit > 0.0)[..., None], flow, torch.zeros_like(flow))
        pids1, keep1 = grids[1]
        flow = refine_flow(flow, sweeps[0][..., :3].to(torch.float32), slot, valids[0], gate_w,
                           sweeps[1][..., :3].to(torch.float32), valids[1], dyn_logit,
                           pids1, keep1, cfg.instance_slots, cfg.refine, dts[0], dts[1])
        return torch.where(valids[0][..., None], flow, torch.zeros_like(flow))


@torch.inference_mode()
def calibrate(model: SeFlowPP, pc0, pc1, pc_hist, valid, dynamic_share: float,
              gate_open_share: float) -> dict:
    """Shifts of the two logits' biases that open the dynamic image on
    ``dynamic_share`` of the pillars sweep 0 occupies and the gate on
    ``gate_open_share`` of its valid points, on these sweeps: random
    weights otherwise put either all or none of them on one side."""
    cfg = model.config
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    prec = Precision(dtype)
    grids, feats, out_img, dyn_logit = model.backbone((pc0, pc1, pc_hist), (valid,) * 3, prec)
    h, w = cfg.grid_shape
    pids0, keep0 = grids[0]
    occupied = torch.zeros(pc0.shape[0], h * w + 1, dtype=torch.bool, device=pc0.device)
    occupied.scatter_(1, pids0, True)
    occupied = occupied[:, :h * w].reshape(-1, h, w)
    flat = out_img.permute(0, 2, 3, 1).reshape(out_img.shape[0], h * w, -1)
    pillar_feat = _take(flat, torch.clamp(pids0, max=h * w - 1))
    pillar_feat = torch.where(keep0[..., None], pillar_feat, torch.zeros_like(pillar_feat))
    _, gate_logit = model.decoder(pillar_feat.to(dtype), feats[0], prec)
    return {"dyn": float(torch.quantile(dyn_logit[occupied].float(), 1.0 - dynamic_share)),
            "gate": float(torch.quantile(gate_logit[keep0].float(), 1.0 - gate_open_share))}


@torch.inference_mode()
def deskew(model: SeFlowPP, pc0, pc1, pc_hist, valid, dt0, fp8_backbone: bool = False):
    """``(flow, refined)`` of a batch: the flow of ``pc0`` from the three
    sweeps (all sharing ``valid``; ``dts = (dt0, dt0)``), and the de-skewed
    points ``pc0 + flow * dt0 / 0.1``."""
    flow = model((pc0, pc1, pc_hist), (valid, valid, valid), (dt0, dt0), fp8_backbone)
    return flow, pc0[..., :3] + flow * (dt0 / 0.1)[..., None]


def param_shapes(cfg: NetConfig) -> dict:
    """name -> shape of every parameter of the network (built on the meta device)."""
    with torch.device("meta"):
        model = SeFlowPP(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}

