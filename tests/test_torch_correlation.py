"""The BEV correlation (``himo_tpu_torch.ops.correlation``): the wrapper's CPU
path against the plain form and JAX's, the backward's gather formula against
autograd, and on a card the kernels against the plain form.

JAX is imported only inside the test that compares with it, so this file
also runs on the GPU host, which has none:

    python -m pytest --noconftest -q tests/test_torch_correlation.py

The tests marked ``cuda`` need a card and skip without one. Tolerances:

- at the shapes where ``torch_order`` finds torch 2.11's reduction orders
  (the main path's among them), the bf16 and fp32 volumes and pooled images
  on the card equal the plain form's bit for bit (the kernels add and round
  in the order of PyTorch's own kernels for the plain form; the fp32 test
  allows 4 ulps and reads 0). Under another torch release these assertions
  skip with a message: its kernels may add in another order;
- elsewhere (pool 1, pools over 11, C = 64, padded C, wide radii) the
  kernels add in their own order: the pooled images within ``2^-7 |ref| +
  2^-14 A`` of torch's ``mean`` (``A``: the mean of the cell's absolute
  values; two fp32 sums of at most 256 terms differ by under 2^-15 A, and
  each rounds once to bf16, an ulp apart at most, 2^-7 of the value), and
  the volume of the kernel's pooled images within ``2^-6 |ref| + 2^-16 S``
  of the plain form's on the same pooled images (``S``: the same volume of
  the absolute values; the same rounded products summed in two fp32 orders
  differ by under 2 * 64 * 2^-24 S, and the two roundings to bf16 give 2
  ulps). fp32: ``2^-21 |ref|`` in place of the ulps;
- the backward on the card against float64 autograd of the plain form on
  the same pooled images: within ``2^-8 |ref| + 1e-5 M`` per element, where
  ``M`` is the same gradient of the absolute values. The kernel rounds its
  fp32 sum once to bf16 (half an ulp, 2^-9 relative; 2^-8 leaves a factor
  of 2), and its fp32 accumulation of at most 130 offsets' terms errs by at
  most 130 * 2^-24 M < 1e-5 M. fp32 images: ``1e-5 (|ref| + M)``.
"""

import numpy as np
import pytest
import torch

from himo_tpu_torch.ops import correlation as PC

MAIN_LEVELS = ((2, 4), (8, 3))  # the seflowpp preset at 512^2: 256^2 r = 4, 64^2 r = 3


def _images(shape, dtype=torch.float32, seed=0, device="cpu", kind="normal"):
    """Two (B, H, W, C) images; ``kind="wide"`` spreads the exponents over
    2^-20..2^20 with random signs, so that any other order of addition
    shows in the last bit."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        if kind == "wide":
            x = x.sign() * (1 + torch.rand(shape, generator=g, dtype=torch.float64)) * torch.exp2(
                torch.randint(-20, 21, shape, generator=g).to(torch.float64))
        out.append(x.to(dtype).to(device))
    return out


def _plain(img0, img1, levels):
    f0, f1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
    return [PC._bev_correlation(PC._avg_pool(f0, s), PC._avg_pool(f1, s), r) for s, r in levels]


# ------------------------------------------------------------------ CPU


CPU_CASES = {
    "pool2 r4 C32": ((2, 16, 24, 32), ((2, 4),), torch.float32),
    "pool8 r3 C16": ((1, 32, 40, 16), ((8, 3),), torch.float32),
    "pool2 r3 C12 odd pooled": ((2, 26, 18, 12), ((2, 3),), torch.float32),
    "pool1 odd H W": ((1, 7, 9, 8), ((1, 2),), torch.float32),
    "two levels bf16": ((2, 32, 32, 32), MAIN_LEVELS, torch.bfloat16),
    "one depth: pool 2 twice": ((1, 12, 20, 8), ((2, 4), (2, 3)), torch.float32),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_wrapper_on_cpu_is_the_plain_form(case):
    """On the CPU the wrapper is the plain form itself, bit for bit, also
    when the images need a gradient (no autograd node of its own)."""
    shape, levels, dtype = CPU_CASES[case]
    img0, img1 = _images(shape, dtype, seed=1)
    img0.requires_grad_(True)
    got = PC.bev_correlations(img0, img1, levels)
    for vol, ref, (s, r) in zip(got, _plain(img0, img1, levels), levels):
        assert vol.shape == (shape[0], (2 * r + 1) ** 2, shape[1] // s, shape[2] // s)
        assert vol.is_contiguous() and vol.dtype is dtype
        assert torch.equal(vol, ref)
        assert type(vol.grad_fn).__name__ == "StackBackward0"
    single = PC.bev_correlation(img0, img1, *levels[0])
    assert torch.equal(single, got[0])


@pytest.mark.parametrize("pool,radius,c,hw", [(2, 4, 32, (16, 24)), (8, 3, 16, (32, 40)),
                                              (2, 3, 12, (26, 18))])
def test_plain_form_matches_jax(pool, radius, c, hw):
    """The wrapper's CPU path against JAX's ``_bev_correlation`` of
    ``_avg_pool``, frame by frame, in fp32: C != 32, odd pooled sizes."""
    jnp = pytest.importorskip("jax.numpy")
    from himo_tpu.models import feedforward as JF

    img0, img1 = _images((2, *hw, c), seed=2)
    got = PC.bev_correlation(img0, img1, pool, radius)
    for b in range(2):
        ref = JF._bev_correlation(JF._avg_pool(jnp.asarray(img0[b].numpy()), pool),
                                  JF._avg_pool(jnp.asarray(img1[b].numpy()), pool), radius)
        np.testing.assert_allclose(got[b].permute(1, 2, 0).numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


def test_borders_read_zero():
    """With all-ones images, the offset (-r, -r) (k = 0) reads 1 inside and 0
    on the first r pooled rows and columns; the last offset on the last r."""
    ones = torch.ones(1, 20, 28, 8)
    vol = PC.bev_correlation(ones, ones, 2, 3)
    first, last = vol[0, 0], vol[0, -1]
    assert (first[:3] == 0).all() and (first[:, :3] == 0).all() and (first[3:, 3:] == 1).all()
    assert (last[-3:] == 0).all() and (last[:, -3:] == 0).all() and (last[:-3, :-3] == 1).all()


class _GatherCorrelation(torch.autograd.Function):
    """The plain forward with the gather formula as its backward, for
    ``gradcheck`` against finite differences of the plain forward."""

    @staticmethod
    def forward(ctx, img0, img1, levels):
        ctx.save_for_backward(img0, img1)
        ctx.levels = levels
        return tuple(_plain(img0, img1, levels))

    @staticmethod
    def backward(ctx, *grads):
        img0, img1 = ctx.saved_tensors
        d0, d1 = PC._bev_correlations_backward(grads, img0, img1, ctx.levels)
        return d0, d1, None


@pytest.mark.parametrize("levels", [((2, 2), (4, 1)), ((2, 2), (2, 1)), ((1, 1),)],
                         ids=["two pools", "one depth", "pool 1"])
def test_gather_backward_gradcheck(levels):
    """The backward's gather formula, both levels summed into one image
    gradient, against finite differences of the plain forward (float64)."""
    img0, img1 = _images((2, 8, 8, 3), torch.float64, seed=3)
    img0.requires_grad_(True)
    img1.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: _GatherCorrelation.apply(a, b, levels),
                                    (img0, img1), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("drop", [None, 0, 1])
def test_gather_backward_equals_autograd(drop):
    """The gather formula equals autograd of the plain forward in float64 at
    the model's two levels (odd pooled sizes), also with one level's
    cotangent absent."""
    levels = ((2, 4), (8, 3))
    img0, img1 = _images((2, 40, 56, 8), torch.float64, seed=4)
    img0.requires_grad_(True)
    img1.requires_grad_(True)
    outs = _plain(img0, img1, levels)
    g = torch.Generator().manual_seed(5)
    grads = [None if i == drop else torch.randn(o.shape, generator=g, dtype=torch.float64)
             for i, o in enumerate(outs)]
    live = [(o, gr) for o, gr in zip(outs, grads) if gr is not None]
    ref0, ref1 = torch.autograd.grad([o for o, _ in live], (img0, img1), [gr for _, gr in live])
    d0, d1 = PC._bev_correlations_backward(grads, img0.detach(), img1.detach(), levels)
    torch.testing.assert_close(d0, ref0, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(d1, ref1, rtol=1e-12, atol=1e-12)


def test_model_on_cpu_does_not_reach_the_kernels(monkeypatch):
    """The model's CPU path is the plain form: the autograd node and the
    kernel wrappers are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel path")

    monkeypatch.setattr(PC._BevCorrelation, "apply", refuse)
    for name in ("correlation_pool", "correlation_volume", "correlation_backward"):
        monkeypatch.setattr(PC, name, refuse)
    from himo_tpu_torch.models import feedforward as PF

    model, cfg = PF.make_model("seflowpp_noprior", device="cpu", depths=(16, 32),
                               **{"pillar.voxel_size": (0.4, 0.4),
                                  "pillar.x_range": (-6.4, 6.4), "pillar.y_range": (-6.4, 6.4)})
    assert cfg.corr_volume
    PF.init_params(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(6)
    sweeps = tuple(torch.rand(1, 200, 3, generator=g) * 12 - 6 for _ in range(cfg.num_frames))
    valids = (torch.ones(1, 200, dtype=torch.bool),) * cfg.num_frames
    flow = model(sweeps, valids, soft_gate=True)
    flow.sum().backward()
    assert torch.isfinite(flow).all()


def test_reduce_configuration():
    """The copy of torch 2.11's reduction configuration (``torch_order``):
    the pooling mean's lanes (one lane a cell element up to 32) and the
    channel sum kept in one thread below 64 channels (main path: 32 at
    256^2 and 64^2); elsewhere None, and the pooling takes its own lanes."""
    assert PC.TORCH_ORDERS == "2.11"
    assert PC._reduce_block(1 << 20, 32, 4) == (32, 4)
    assert PC.torch_order(8, 32, 512, 512, 2) == 4
    assert PC.torch_order(8, 32, 512, 512, 8) == 32
    assert PC.torch_order(1, 8, 300, 300, 3) == 8
    for c, h, w in ((32, 256, 256), (32, 64, 64), (56, 13, 9), (8, 1, 1)):
        assert PC.torch_order(8, c, 2 * h, 2 * w, 2) is not None
    assert PC.torch_order(8, 64, 512, 512, 2) is None  # the channel sum splits across warps
    assert PC.torch_order(1, 8, 16, 16, 16) is None  # few outputs: the cell splits over warps
    assert PC.torch_order(8, 32, 1536, 1536, 12) is None  # 5 cell elements a lane
    assert PC.torch_order(8, 32, 512, 512, 16) is None  # 8 cell elements a lane
    assert PC.torch_order(8, 32, 64, 64, 1) is None and PC.torch_order(8, 12, 64, 64, 2) is None
    assert PC._pool_lanes(8, 32, 512, 512, 16) == 32
    assert PC._pool_lanes(8, 32, 64, 64, 1) == 1
    assert PC._pool_lanes(1, 8, 16, 16, 16) == 32


@pytest.mark.parametrize("case", ["fp16", "fp64", "C72", "pool3 of 2x2x8", "radius15",
                                  "three levels", "shape mismatch"])
def test_kernel_checks_refuse(case):
    """What the kernels do not take, refused before any launch (the check
    runs on any device): more than 64 channels, pools that do not divide,
    a radius whose one-row tile overflows shared memory (fp32, C = 32)."""
    img = torch.zeros(1, 16, 16, 32)
    a, b, levels, error = {
        "fp16": (img.half(), img.half(), MAIN_LEVELS, TypeError),
        "fp64": (img.double(), img.double(), MAIN_LEVELS, TypeError),
        "C72": (torch.zeros(1, 16, 16, 72),) * 2 + (MAIN_LEVELS, ValueError),
        "pool3 of 2x2x8": (img, img, ((2, 1), (3, 1)), ValueError),
        "radius15": (img, img, ((2, 15),), ValueError),
        "three levels": (img, img, ((2, 1), (4, 1), (8, 1)), ValueError),
        "shape mismatch": (img, img[:, :8], MAIN_LEVELS, ValueError),
    }[case]
    with pytest.raises(error):
        PC._check_images(a, b, levels)
    PC._check_images(img, img, MAIN_LEVELS)


@pytest.mark.parametrize("case", ["C12", "C64", "pool1", "pool16", "radius9", "radius14"])
def test_kernel_checks_take(case):
    """What the plain form takes and the kernels take too, in their own
    order where torch's is not copied: any C up to 64 (padded to a multiple
    of 8), pool 1, pools over 11, radii whose tile fits."""
    img = torch.zeros(1, 32, 32, 32)
    a, levels = {
        "C12": (img[..., :12], MAIN_LEVELS),
        "C64": (torch.zeros(1, 32, 32, 64, dtype=torch.bfloat16), MAIN_LEVELS),
        "pool1": (img, ((1, 1),)),
        "pool16": (img, ((2, 4), (16, 3))),
        "radius9": (img, ((2, 9),)),
        "radius14": (img, ((2, 14),)),
    }[case]
    PC._check_images(a, a, levels)
    assert PC._tile_fits(14, 32, 4) and not PC._tile_fits(15, 32, 4)
    assert PC._padded(12) == 16 and PC._padded(64) == 64


# ------------------------------------------------------------------ card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _torch_orders(cuda_device):
    """Skip a bit-for-bit assertion under a torch release other than the
    one whose reduction orders the kernels copy."""
    if not torch.__version__.startswith(PC.TORCH_ORDERS + "."):
        pytest.skip(f"the kernels copy torch {PC.TORCH_ORDERS}'s reduction orders; torch "
                    f"{torch.__version__} may add the plain form in another order")
    return cuda_device


@pytest.fixture()
def torch_orders(cuda_device):
    return _torch_orders(cuda_device)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_bf16_forward_is_the_plain_form_bit_for_bit(torch_orders, kind):
    """The main path's shapes (B8, C32, 512^2 pooled to 256^2 r = 4 and to
    64^2 r = 3) in bf16: pooled images and volumes equal the plain form's on
    the card bit for bit, on normal values and on values whose exponents
    span 2^-20..2^20 (where any other order of addition shows)."""
    img0, img1 = _images((8, 512, 512, 32), torch.bfloat16, seed=11, device=torch_orders,
                         kind=kind)
    with torch.no_grad():
        got = PC.bev_correlations(img0, img1, MAIN_LEVELS)
        ref = _plain(img0, img1, MAIN_LEVELS)
        pooled = PC.correlation_pool(img0, img1, [s for s, _ in MAIN_LEVELS])
        for (p0, p1), (s, _) in zip(pooled, MAIN_LEVELS):
            assert torch.equal(p0.permute(0, 3, 1, 2), PC._avg_pool(img0.permute(0, 3, 1, 2), s))
            assert torch.equal(p1.permute(0, 3, 1, 2), PC._avg_pool(img1.permute(0, 3, 1, 2), s))
    for vol, r in zip(got, ref):
        assert vol.is_contiguous() and vol.shape == r.shape
        assert torch.equal(vol, r), int((vol != r).sum())


@pytest.mark.cuda
def test_fp32_forward_within_ulps(torch_orders):
    """fp32 images (``FlowNetConfig``'s default) at 512^2, both levels:
    within 4 ulps of the plain form on the card (the same order, so 0)."""
    img0, img1 = _images((2, 512, 512, 32), torch.float32, seed=12, device=torch_orders,
                         kind="wide")
    with torch.no_grad():
        got = PC.bev_correlations(img0, img1, MAIN_LEVELS)
        ref = _plain(img0, img1, MAIN_LEVELS)
    for vol, r in zip(got, ref):
        assert _ulps(vol, r) <= 4


SMALL_CASES = {
    "odd pooled 13x9 C16 r4": ((2, 26, 18, 16), ((2, 4),)),
    "C24 r8 pool4": ((1, 36, 100, 24), ((4, 8),)),
    "C56 r0 pool2 odd pooled": ((3, 10, 14, 56), ((2, 0),)),
    "one depth: pool 2 twice": ((2, 40, 72, 8), ((2, 4), (2, 3))),
    "256^2 grid: 128^2 and 32^2": ((2, 256, 256, 32), ((2, 4), (8, 3))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_forward_other_shapes_bit_for_bit(torch_orders, case, dtype):
    """Ragged tiles, other C, radii and pools, and the one-depth case where
    both levels pool by 2: equal to the plain form on the card."""
    shape, levels = SMALL_CASES[case]
    b, hh, ww, c = shape
    assert all(PC.torch_order(b, c, hh, ww, s) is not None for s, _ in levels)
    img0, img1 = _images(shape, dtype, seed=13, device=torch_orders, kind="wide")
    with torch.no_grad():
        got = PC.bev_correlations(img0, img1, levels)
        ref = _plain(img0, img1, levels)
    for vol, r in zip(got, ref):
        assert torch.equal(vol, r), int((vol != r).sum())


def _reference_grads(img0, img1, levels, grads, pooled=None):
    """float64 autograd of the plain form on the card's bf16/fp32 pooled
    images (the kernel's inputs: torch's ``mean``, or ``pooled`` where the
    kernels pool in their own order), spread by the mean's exact backward;
    and the same gradient of the absolute values (the bound's M)."""
    f0, f1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
    if pooled is None:
        pooled = [(PC._avg_pool(f0, s), PC._avg_pool(f1, s)) for s, _ in levels]
    else:
        pooled = [(p0.permute(0, 3, 1, 2), p1.permute(0, 3, 1, 2)) for p0, p1 in pooled]
    ref = [torch.zeros(f0.shape, dtype=torch.float64, device=f0.device) for _ in range(2)]
    mag = [torch.zeros_like(ref[0]) for _ in range(2)]
    for g, (s, r), (q0, q1) in zip(grads, levels, pooled):
        p0 = q0.double().requires_grad_(True)
        p1 = q1.double().requires_grad_(True)
        d = torch.autograd.grad(PC._bev_correlation(p0, p1, r), (p0, p1), g.double())
        a = PC._bev_correlation_backward(g.double().abs(), p0.detach().abs(),
                                         p1.detach().abs(), r)
        for i in range(2):
            ref[i] += PC._avg_pool_backward(d[i], s)
            mag[i] += PC._avg_pool_backward(a[i], s)
    return [t.permute(0, 2, 3, 1) for t in ref], [t.permute(0, 2, 3, 1) for t in mag]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (2, 512, 512, 32)),
                                         (torch.float32, (1, 256, 256, 16))], ids=["bf16", "fp32"])
def test_backward_matches_float64_autograd(cuda_device, dtype, shape):
    """Both image gradients through the autograd node, both levels, against
    float64 autograd of the plain form within the bound in the module
    docstring."""
    img0, img1 = _images(shape, dtype, seed=14, device=cuda_device)
    img0.requires_grad_(True)
    img1.requires_grad_(True)
    outs = PC.bev_correlations(img0, img1, MAIN_LEVELS)
    g = torch.Generator(device=cuda_device).manual_seed(15)
    grads = [torch.randn(o.shape, generator=g, device=cuda_device).to(dtype) for o in outs]
    d0, d1 = torch.autograd.grad(outs, (img0, img1), grads)
    ref, mag = _reference_grads(img0.detach(), img1.detach(), MAIN_LEVELS, grads)
    rel = 2.0**-8 if dtype is torch.bfloat16 else 1e-5
    for got, r, m in zip((d0, d1), ref, mag):
        assert got.dtype is dtype and got.shape == img0.shape
        err = (got.double() - r).abs()
        bound = rel * r.abs() + 1e-5 * m + 1e-30
        assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
def test_frame_strides_and_one_level(cuda_device):
    """Images that are frames of a larger tensor (as the fused pillar max
    leaves them in fp32) and a cotangent that is a channel slice of a larger
    one (as the UNet's ``cat`` gives it) give what contiguous copies give; a
    single level spreads its own gradient."""
    b, h, w, c = 2, 64, 96, 16
    big = torch.randn(b, 3 * h * w, c, device=cuda_device)
    img0 = big[:, : h * w].reshape(b, h, w, c)
    img1 = big[:, h * w : 2 * h * w].reshape(b, h, w, c)
    a0 = img0.contiguous().requires_grad_(True)
    a1 = img1.contiguous().requires_grad_(True)
    s0 = big.clone().requires_grad_(True)
    x0 = s0[:, : h * w].reshape(b, h, w, c)
    x1 = s0[:, h * w : 2 * h * w].reshape(b, h, w, c)
    assert x0.stride(0) == 3 * h * w * c
    got = PC.bev_correlation(x0, x1, 2, 3)
    want = PC.bev_correlation(a0, a1, 2, 3)
    assert torch.equal(got, want)
    wide = torch.randn(b, got.shape[1] + 5, *got.shape[2:], device=cuda_device)
    gslice = wide[:, 5:]
    assert not gslice.is_contiguous()
    (d_big,) = torch.autograd.grad(got, s0, gslice)
    d0, d1 = torch.autograd.grad(want, (a0, a1), gslice.contiguous())
    assert torch.equal(d_big[:, : h * w].reshape(b, h, w, c), d0)
    assert torch.equal(d_big[:, h * w : 2 * h * w].reshape(b, h, w, c), d1)
    assert (d_big[:, 2 * h * w :] == 0).all()
    ref, mag = _reference_grads(img0, img1, ((2, 3),), [gslice.contiguous()])
    for g_, r, m in zip((d0, d1), ref, mag):
        assert bool(((g_.double() - r).abs() <= 1e-5 * (r.abs() + m) + 1e-30).all())


@pytest.mark.cuda
def test_launch_counters_and_the_autograd_node(cuda_device):
    """One pooling launch and one volume launch a level each forward call,
    one backward launch a level with a cotangent; an image that needs a
    gradient goes through the autograd node, otherwise none is made."""
    img0, img1 = _images((2, 64, 64, 32), torch.bfloat16, seed=16, device=cuda_device)
    counts = lambda: (PC.correlation_pool.launches, PC.correlation_volume.launches,  # noqa: E731
                      PC.correlation_backward.launches)
    before = counts()
    outs = PC.bev_correlations(img0, img1, MAIN_LEVELS)
    assert counts() == (before[0] + 1, before[1] + 2, before[2])
    assert all(o.grad_fn is None for o in outs)
    img0.requires_grad_(True)
    before = counts()
    outs = PC.bev_correlations(img0, img1, MAIN_LEVELS)
    assert counts() == (before[0] + 1, before[1] + 2, before[2])
    assert all(type(o.grad_fn).__name__ == "_BevCorrelationBackward" for o in outs)
    (outs[0].float().sum() + outs[1].float().sum()).backward()
    assert counts()[2] == before[2] + 2
    assert img0.grad is not None and img1.grad is None
    before = counts()
    fine = PC.bev_correlation(img0, img1, 2, 4)
    (d_fine,) = torch.autograd.grad(fine.float().sum(), img0)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    outs = PC.bev_correlations(img0, img1, MAIN_LEVELS)
    (d_first,) = torch.autograd.grad(outs[0].float().sum(), img0)  # no cotangent for level 2
    assert counts()[2] == before[2] + 2
    assert torch.equal(d_first, d_fine)
    with torch.no_grad():
        assert PC.bev_correlation(img0, img1, 2, 4).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "C72", "pool3", "radius15"])
def test_cuda_wrapper_raises(cuda_device, case):
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    img = torch.zeros(1, 24, 24, 32, device=cuda_device)
    a, levels, error = {
        "fp16": (img.half(), ((2, 4),), TypeError),
        "C72": (torch.zeros(1, 24, 24, 72, device=cuda_device), ((2, 4),), ValueError),
        "pool3": (img, ((2, 4), (3, 3)), ValueError),
        "radius15": (img, ((2, 15),), ValueError),
    }[case]
    with pytest.raises(error):
        PC.bev_correlations(a, a.clone(), levels)


OWN_ORDER_CASES = {
    "pool1 r3": ((2, 64, 96, 32), ((1, 3),)),
    "pool16 coarse": ((2, 256, 256, 32), ((2, 4), (16, 3))),
    "C64 at 256^2": ((8, 512, 512, 64), ((2, 4), (8, 3))),
    "C12 padded": ((2, 64, 80, 12), ((2, 4), (8, 3))),
    "C20 r12": ((1, 96, 128, 20), ((2, 12),)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(OWN_ORDER_CASES))
def test_forward_own_order_within_bound(cuda_device, case, dtype):
    """Shapes at which the kernels add in their own order: pooled images
    against torch's ``mean``, the volume against the plain form of the
    kernel's own pooled images, each within the bound in the module
    docstring; the padded channels never reach the caller."""
    shape, levels = OWN_ORDER_CASES[case]
    b, hh, ww, c = shape
    assert any(PC.torch_order(b, c, hh, ww, s) is None for s, _ in levels)
    img0, img1 = _images(shape, dtype, seed=17, device=cuda_device)
    rel_pool, rel_vol = (2.0**-7, 2.0**-6) if dtype is torch.bfloat16 else (2.0**-21, 2.0**-21)
    with torch.no_grad():
        pooled = PC.correlation_pool(img0, img1, [s for s, _ in levels])
        vols = PC.bev_correlations(img0, img1, levels)
        for (p0, p1), (s, r), vol in zip(pooled, levels, vols):
            assert p0.shape == (b, hh // s, ww // s, c) and vol.is_contiguous()
            for img, p in ((img0, p0), (img1, p1)):
                ref = PC._avg_pool(img.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1).float()
                mean_abs = PC._avg_pool(img.abs().float().permute(0, 3, 1, 2), s)
                bound = rel_pool * ref.abs() + 2.0**-14 * mean_abs.permute(0, 2, 3, 1)
                assert bool(((p.float() - ref).abs() <= bound).all())
            f0, f1 = p0.permute(0, 3, 1, 2), p1.permute(0, 3, 1, 2)
            ref = PC._bev_correlation(f0, f1, r).float()
            size = PC._bev_correlation(f0.abs().float(), f1.abs().float(), r)
            err = (vol.float() - ref).abs()
            bound = rel_vol * ref.abs() + 2.0**-16 * size + 1e-30
            assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pool1 r3", "pool16 coarse", "C12 padded"])
def test_backward_own_order_matches_float64_autograd(cuda_device, case):
    """The backward at shapes where the kernels pool in their own order,
    against float64 autograd of the plain form on the kernel's pooled
    images, within the bound in the module docstring (bf16)."""
    shape, levels = OWN_ORDER_CASES[case]
    img0, img1 = _images(shape, torch.bfloat16, seed=18, device=cuda_device)
    img0.requires_grad_(True)
    img1.requires_grad_(True)
    outs = PC.bev_correlations(img0, img1, levels)
    g = torch.Generator(device=cuda_device).manual_seed(19)
    grads = [torch.randn(o.shape, generator=g, device=cuda_device).to(torch.bfloat16)
             for o in outs]
    d0, d1 = torch.autograd.grad(outs, (img0, img1), grads)
    with torch.no_grad():
        pooled = PC.correlation_pool(img0, img1, [s for s, _ in levels])
    ref, mag = _reference_grads(img0.detach(), img1.detach(), levels, grads, pooled)
    for got, r, m in zip((d0, d1), ref, mag):
        assert got.shape == img0.shape
        err = (got.double() - r).abs()
        bound = 2.0**-8 * r.abs() + 1e-5 * m + 1e-30
        assert bool((err <= bound).all()), float((err / bound).max())
