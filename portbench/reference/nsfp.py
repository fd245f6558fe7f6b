"""Plain PyTorch reference of Neural Scene Flow Prior on one frame pair,
from a cold start.

X. Li, J. Kaesemodel Pontes, S. Lucey, "Neural Scene Flow Prior", NeurIPS
2021 (arXiv:2111.01253), in the form HiMo (arXiv:2503.00803) runs as its
optimisation baseline (``model=nsfp``). Per pair: a fresh coordinate MLP,
3 -> ``layers`` hidden layers of ``hidden`` with ReLU -> 3, Glorot-normal
weights and zero biases, maps each point of pc0 to its flow; Adam fits it
against the bidirectional chamfer of ``pc0 + flow`` and pc1, each squared
nearest-neighbour distance capped at ``max_dist``²; the flow then
de-skews pc0, ``pc0 + flow / 0.1 * dt0``.

Departures from the paper, all shared with the program:
- one MLP for the forward flow; the paper also fits a backward-flow MLP
  and a cycle-consistency term;
- a fixed number of Adam steps, where the paper stops early;
- the truncation caps each squared distance at ``max_dist``² (HiMo's
  truncated chamfer), and a point's distance counts only between valid
  points;
- the weights draw from a ``torch.Generator`` in the program's order, so
  both start from the same MLP.

Nearest neighbours come from an exhaustive search in blocks (candidates
by the matrix-product form, then exact differences); the squared distance
to the chosen neighbour is then worked out again, so the gradient flows
through it. Everything is float32 with TF32 off in both ``allow_tf32``
flags; with ``tf32=True`` the MLP's products (forward and backward) take
operands rounded to TF32's 10-bit mantissa, the precision below float32.
Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

NN_PAIRS = 1 << 28  # (query, reference) pairs per block of a search
CANDIDATES = 8  # nearest by the product form, then compared exactly
MASK_BIG = 1.0e14  # additive penalty on invalid references
SENSOR_DT = 0.1  # s per sweep
BETAS = (0.9, 0.999)
EPS = 1e-8


@contextlib.contextmanager
def float32():
    """Both ``allow_tf32`` flags off for the block, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def init_mlp(generator: torch.Generator, hidden: int = 128, layers: int = 8,
             device=None) -> list:
    """``[(W (in, out), b (out,)), ...]`` for 3 -> hidden x layers -> 3:
    each W a standard normal draw of ``generator`` (on its own device)
    times sqrt(2 / (in + out)), each b zero."""
    dims = [3] + [hidden] * layers + [3]
    device = generator.device if device is None else torch.device(device)
    params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator, device=generator.device)
        params.append(((w * math.sqrt(2.0 / (fan_in + fan_out))).to(device),
                       torch.zeros(fan_out, device=device)))
    return params


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits), to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with every product's operands rounded to TF32, the
    backward's too, as tensor cores in TF32 compute them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ _round_tf32(b).T, _round_tf32(a).T @ g


def mlp(params: list, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """(N, 3) points -> (N, 3) flow: ``x @ W + b``, ReLU between layers."""
    h = x
    for i, (w, b) in enumerate(params):
        h = (_TF32MatMul.apply(h, w) if tf32 else h @ w) + b
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def nearest(q: torch.Tensor, r: torch.Tensor, valid_r: torch.Tensor) -> torch.Tensor:
    """Per query of (N, 3) the index of the nearest valid reference of
    (M, 3), the lowest index on ties; searched in blocks of queries. The
    product form ``|q|^2 + |r|^2 - 2 q.r`` (a few 1e-4 m^2 off at 50 m
    coordinates) picks each query's ``CANDIDATES`` nearest, and their exact
    squared differences pick the nearest of those."""
    pen = torch.where(valid_r, 0.0, MASK_BIG).to(torch.float32)
    rn = (r * r).sum(dim=-1) + pen
    block = max(1, NN_PAIRS // r.shape[0])
    k = min(CANDIDATES, r.shape[0])
    idx = []
    with torch.no_grad():
        for s in range(0, q.shape[0], block):
            qb = q[s:s + block]
            rough = torch.addmm(rn[None, :], qb, r.T, alpha=-2.0) + (qb * qb).sum(-1, keepdim=True)
            cand = rough.topk(k, dim=1, largest=False).indices
            exact = _sq_to(qb[:, None, :], r, cand) + pen[cand]
            best = exact.min(dim=1, keepdim=True).values
            idx.append(torch.where(exact == best, cand, r.shape[0]).min(dim=1).values)
    return torch.cat(idx)


def _sq_to(q: torch.Tensor, r: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    d = q - r[idx]
    return (d * d).sum(dim=-1)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    total = torch.where(mask, values, torch.zeros_like(values)).sum()
    return total / torch.clamp(mask.to(values.dtype).sum(), min=1.0)


def chamfer(warped: torch.Tensor, pc1: torch.Tensor, valid0: torch.Tensor,
            valid1: torch.Tensor, max_dist: float = 2.0) -> torch.Tensor:
    """The truncated bidirectional chamfer: the mean over valid warped
    points of the squared distance to the nearest valid pc1 point, plus the
    mean over valid pc1 points of that to the nearest valid warped point,
    each distance capped at ``max_dist``²."""
    cap = max_dist * max_dist
    to1 = _sq_to(warped, pc1, nearest(warped.detach(), pc1, valid1))
    to0 = _sq_to(pc1, warped, nearest(pc1, warped.detach(), valid0))
    return (_masked_mean(torch.minimum(to1, torch.full_like(to1, cap)), valid0)
            + _masked_mean(torch.minimum(to0, torch.full_like(to0, cap)), valid1))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root), bias
    corrected, on a list of tensors."""

    def __init__(self, params: list, lr: float, m: list | None = None,
                 v: list | None = None, t: int = 0):
        """A fresh state, or one ``t`` updates on with moments ``m``, ``v``."""
        self.lr, self.t = lr, t
        self.m = [torch.zeros_like(p) for p in params] if m is None else list(m)
        self.v = [torch.zeros_like(p) for p in params] if v is None else list(v)

    def step(self, params: list, grads: list) -> list:
        self.t += 1
        b1, b2 = BETAS
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = b1 * self.m[i] + (1 - b1) * g
            self.v[i] = b2 * self.v[i] + (1 - b2) * g * g
            m_hat = self.m[i] / (1 - b1 ** self.t)
            v_hat = self.v[i] / (1 - b2 ** self.t)
            out.append(p - self.lr * m_hat / (torch.sqrt(v_hat) + EPS))
        return out


def optimise(pc0, pc1, valid0, valid1, generator: torch.Generator | None, *,
             iterations: int, hidden: int = 128, layers: int = 8, lr: float = 8e-3,
             max_dist: float = 2.0, tf32: bool = False, start: dict | None = None) -> dict:
    """Fit the flow of one pair ((N, 3) / (M, 3) clouds, (N,) / (M,) masks)
    for ``iterations`` Adam steps from ``init_mlp(generator)``, or, given
    ``start`` (``params``, ``exp_avg``, ``exp_avg_sq`` as flat lists in
    ``init_mlp``'s order, and ``step``, the updates made), on from that
    state. Returns the loss of each step (at its parameters before the
    update), the first and last parameters as flat lists, and the last
    flow, zero on invalid points."""
    with float32():
        p0 = pc0[:, :3].float()
        p1 = pc1[:, :3].float()
        if start is None:
            params = init_mlp(generator, hidden, layers, device=p0.device)
            flat = [t for pair in params for t in pair]
            adam = Adam(flat, lr)
        else:
            flat = [t.to(p0.device) for t in start["params"]]
            adam = Adam(flat, lr, [t.to(p0.device) for t in start["exp_avg"]],
                        [t.to(p0.device) for t in start["exp_avg_sq"]], int(start["step"]))
        first = [t.clone() for t in flat]
        losses = []

        def pairs(tensors):
            return list(zip(tensors[0::2], tensors[1::2]))

        for _ in range(iterations):
            leaves = [t.detach().requires_grad_(True) for t in flat]
            loss = chamfer(p0 + mlp(pairs(leaves), p0, tf32), p1, valid0, valid1, max_dist)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            flat = adam.step([t.detach() for t in leaves], grads)
        with torch.no_grad():
            flow = mlp(pairs(flat), p0, tf32)
        flow = torch.where(valid0[:, None], flow, torch.zeros_like(flow))
    return {"losses": losses, "first": first, "last": flat, "flow": flow}


def deskew(pc0: torch.Tensor, flow: torch.Tensor, dt0: torch.Tensor,
           sensor_dt: float = SENSOR_DT) -> torch.Tensor:
    """De-skewed points ``pc0 + flow / sensor_dt * dt0``."""
    return pc0[:, :3] + flow / sensor_dt * dt0[:, None]
