"""The trunk's fused frozen-BN epilogue (``ops/cuda/conv_epilogue_kernel``,
``csrc/conv_epilogue.cu``) and the paths of ``models/resnet`` and
``models/fpn`` that run it.

On the CPU: the plain mirrors (the kernels' arithmetic in PyTorch) against
the unfused chain (``x * s + b`` -> relu, ``+ shortcut`` -> relu) and the
exact sum; the folded-weight conv against conv-then-affine; the fused
bottleneck (projection bias summed into the closing epilogue) and trunk
against the unfused form; a ``fold_bn``'d params dict against the unfolded
one; the wrappers' refusals; with grad mode on, the unfused form's ops and
gradients; the epilogue calls a trunk makes.

On a card (marker ``cuda``; skipped without one) both kernels must equal
their mirrors bit for bit at the main path's widths. The card has no JAX,
and this file imports none:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_epilogue.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from detectorch_tpu_torch.checkpoint.caffe2_import import fold_bn
from detectorch_tpu_torch.checkpoint.convert import params_from_jax
from detectorch_tpu_torch.models import fpn, resnet
from detectorch_tpu_torch.ops.cuda import conv_epilogue_kernel as cek

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Six pytest workers share the cores: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _epilogue_inputs(seed, shape, dtype):
    g = torch.Generator().manual_seed(seed)
    y = _cl((torch.randn(shape, generator=g) * 2).to(dtype))
    r = _cl(torch.randn(shape, generator=g).to(dtype))
    b = torch.randn(shape[1], generator=g) * 0.5
    return y, r, b


def _ulp_bf16(x):
    """One bf16 ulp at |x| (the normal range)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -120)))
    return torch.pow(2.0, e - 7)


# (N, H, W): P = N*H*W ragged (no power of two), or one pixel
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("channels", [64, 256, 2048])
@pytest.mark.parametrize("pixels", [(3, 5, 7), (1, 1, 1)])
@pytest.mark.parametrize("residual,relu", [(False, True), (True, True), (False, False),
                                           (True, False)])
def test_epilogue_mirror_against_unfused_chain(dtype, channels, pixels, residual, relu):
    dt = DTYPES[dtype]
    n, h, w = pixels
    y, r, b = _epilogue_inputs(channels + h, (n, channels, h, w), dt)
    res = r if residual else None
    chain = resnet.affine(y, torch.ones(channels), b)
    if residual:
        chain = chain + r
    if relu:
        chain = F.relu(chain)
    exact = y.double() + b.double()[:, None, None] + (r.double() if residual else 0)
    if relu:
        exact = exact.clamp_min(0)
    got = cek.epilogue_mirror(y.clone(), b, res, relu)
    assert got.dtype == dt and got.is_contiguous(memory_format=torch.channels_last)
    if dt == torch.float32:
        # the same fp32 adds in the same order: bit for bit
        assert torch.equal(got, chain)
        return
    # one rounding: within half an ulp of the exact sum (fp32's own rounding
    # of the sum aside); the chain rounds b to bf16, and the sum once more
    # with a residual, so it lies no nearer
    ulp = _ulp_bf16(exact.float()).double()
    terms = y.double().abs() + b.double().abs()[:, None, None] + (r.double().abs() if residual
                                                                    else 0)
    err, err_chain = (got.double() - exact).abs(), (chain.double() - exact).abs()
    assert (err <= 0.5 * ulp + 2 ** -22 * terms).all()
    assert err.sum() <= err_chain.sum()


def test_epilogue_mirror_writes_in_place_and_keeps_nan():
    y, r, b = _epilogue_inputs(0, (2, 8, 3, 3), torch.float32)
    y[0, 0, 0, 0] = float("nan")
    out = cek.conv_epilogue(y, b, r, relu=True)
    assert out is y and torch.isnan(y[0, 0, 0, 0])
    assert cek.conv_epilogue.launches == 0  # CPU calls run the mirror


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel,groups,stride,pad", [(1, 1, 1, 0), (1, 1, 2, 0),
                                                      (3, 1, 1, 1), (3, 8, 2, 1), (7, 1, 2, 3)])
def test_folded_conv_against_conv_then_affine(dtype, kernel, groups, stride, pad):
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(kernel * 10 + groups)
    cin, cout = 16, 32
    x = _cl(torch.randn(2, cin, 11, 13, generator=g).to(dt))
    w = torch.randn(cout, cin // groups, kernel, kernel, generator=g) * 0.2
    s = torch.rand(cout, generator=g) + 0.2
    for layout in (w, _cl(w)):
        wf = cek.fold_scale(layout, s, dt)
        assert wf.dtype == dt and wf.stride() == layout.stride()
        assert torch.equal(wf, (w * s[:, None, None, None]).to(dt))
        got = resnet.conv(x, wf, stride, pad, groups)
        exp = (F.conv2d(x.double(), w.double(), stride=stride, padding=pad, groups=groups)
               * s.double()[:, None, None])
        before = resnet.affine(resnet.conv(x, w, stride, pad, groups), s, torch.zeros(cout))
        err, err_before = ((got.double() - exp).abs().max().item(),
                           (before.double() - exp).abs().max().item())
        scale = exp.abs().max().item()
        if dt == torch.float32:
            assert err <= 1e-5 * scale
        else:
            # one bf16 rounding of W*s in place of W's and s's and the product's
            assert err <= 2 ** -6 * scale and err <= 2 * err_before + 2 ** -8 * scale


def _block_params(seed, cin, mid, cout, has_proj, groups=1):
    """One bottleneck's blobs, BN scales and biases drawn away from 1 and 0."""
    rng = np.random.RandomState(seed)
    p = {}

    def add(name, k, ci, co):
        p[f"{name}_w"] = (rng.randn(co, ci, k, k) * np.sqrt(2.0 / (k * k * ci))).astype(np.float32)
        p[f"{name}_bn_s"] = rng.uniform(0.2, 0.9, co).astype(np.float32)
        p[f"{name}_bn_b"] = (rng.randn(co) * 0.2).astype(np.float32)

    if has_proj:
        add("b_branch1", 1, cin, cout)
    add("b_branch2a", 1, cin, mid)
    add("b_branch2b", 3, mid // groups, mid)
    add("b_branch2c", 1, mid, cout)
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("has_proj,stride,groups", [(True, 2, 1), (True, 1, 1), (False, 1, 1),
                                                    (True, 2, 8), (False, 1, 8)])
def test_fused_bottleneck_against_unfused(dtype, has_proj, stride, groups):
    """The projection block's bias b2c + b1 in its closing epilogue (the
    shortcut conv with no epilogue), and the plain block, against the
    unfused form."""
    dt = DTYPES[dtype]
    cin = 64 if has_proj else 128
    p = _block_params(7, cin, 32 if groups == 1 else 64, 128, has_proj, groups)
    x = _cl(torch.randn(2, cin, 10, 12, generator=torch.Generator().manual_seed(3)).to(dt))
    with torch.no_grad():
        got = resnet.bottleneck(p, x, "b", stride, has_proj, groups)
        exp = resnet._bottleneck_unfused(p, x, "b", stride, has_proj, groups)
    assert got.shape == exp.shape and got.is_contiguous(memory_format=torch.channels_last)
    scale = exp.float().abs().max().item()
    err = (got.float() - exp.float()).abs().max().item()
    assert err <= (1e-5 if dt == torch.float32 else 2 ** -5) * scale


def _trunk_params():
    """R-50's blobs (init_params, seed 0) with every BN scale and bias
    redrawn: the init's zero branch2c scales would hide the branches."""
    p = resnet.init_resnet_params("resnet50", seed=0)
    rng = np.random.RandomState(5)
    for name, v in p.items():
        if name.endswith("_bn_s"):
            p[name] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
        elif name.endswith("_bn_b"):
            p[name] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return params_from_jax(p)


@pytest.fixture(scope="module")
def trunk():
    return _trunk_params()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fold_bn_params_give_the_same_trunk(trunk, dtype):
    """fold_bn's W*s with scales of 1 folds to the same weights bit for bit,
    so the trunk's outputs are equal; and the fused trunk against the
    unfused one."""
    dt = DTYPES[dtype]
    x = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(1)).to(dt)
    with torch.no_grad():
        got = resnet.multilevel_body(trunk, x)
        folded = resnet.multilevel_body(fold_bn(trunk), x)
    for k in got:
        assert torch.equal(got[k], folded[k]), k
    leaves = {k: v.clone().requires_grad_(True) for k, v in trunk.items()}
    ref = resnet.multilevel_body(leaves, x)
    for k in got:
        scale = ref[k].detach().float().abs().max().item()
        err = (got[k].float() - ref[k].detach().float()).abs().max().item()
        assert err <= (1e-5 if dt == torch.float32 else 2 ** -4) * scale, k


def _bad_epilogue(name):
    y = _cl(torch.randn(2, 16, 3, 3))
    b, r = torch.zeros(16), _cl(torch.randn(2, 16, 3, 3))
    return {
        "not_channels_last": (lambda: (y.contiguous(), b, None), ValueError),
        "channels_not_multiple_of_8": (lambda: (_cl(torch.randn(2, 12, 3, 3)), torch.zeros(12),
                                                None), ValueError),
        "too_many_channels": (lambda: (_cl(torch.randn(1, 2056, 1, 1)), torch.zeros(2056),
                                       None), ValueError),
        "float16": (lambda: (y.half(), b, None), TypeError),
        "bias_bf16": (lambda: (y, b.bfloat16(), None), ValueError),
        "bias_length": (lambda: (y, torch.zeros(8), None), ValueError),
        "residual_layout": (lambda: (y, b, r.contiguous()), ValueError),
        "residual_dtype": (lambda: (y, b, r.bfloat16()), ValueError),
        "residual_shape": (lambda: (y, b, _cl(torch.randn(1, 16, 3, 3))), ValueError),
    }[name]


@pytest.mark.parametrize("name", ["not_channels_last", "channels_not_multiple_of_8",
                                  "too_many_channels", "float16", "bias_bf16", "bias_length",
                                  "residual_layout", "residual_dtype", "residual_shape"])
def test_epilogue_wrapper_refuses(name):
    make, err = _bad_epilogue(name)
    with pytest.raises(err):
        cek.conv_epilogue(*make())


@pytest.mark.parametrize("what", ["epilogue", "fold"])
def test_wrappers_refuse_operands_autograd_records(what):
    w = torch.randn(16, 8, 1, 1, requires_grad=True)
    y = _cl(torch.randn(1, 16, 2, 2, requires_grad=True))
    with pytest.raises(RuntimeError, match="autograd"):
        if what == "epilogue":
            cek.conv_epilogue(y, torch.zeros(16))
        else:
            cek.fold_scale(w, torch.ones(16), torch.float32)


def test_fold_wrapper_refuses():
    with pytest.raises(ValueError):  # a weight whose output axis is not outermost
        cek.fold_scale(torch.randn(8, 16, 3, 3).transpose(0, 1), torch.ones(16), torch.float32)
    with pytest.raises(ValueError):
        cek.fold_scale(torch.randn(16, 8, 1, 1), torch.ones(8), torch.float32)
    with pytest.raises(TypeError):
        cek.fold_scale(torch.randn(16, 8, 1, 1), torch.ones(16), torch.float16)


def _parent_bottleneck(params, x, prefix, stride, has_proj, groups=1):
    """The bottleneck as the unfused chain: conv (weight cast), affine,
    relu, residual add, relu."""
    def conv_bn(x, name, stride=1, pad=0):
        return resnet.affine(resnet.conv(x, params[f"{name}_w"], stride, pad),
                             params[f"{name}_bn_s"], params[f"{name}_bn_b"])

    shortcut = conv_bn(x, f"{prefix}_branch1", stride) if has_proj else x
    if groups == 1:
        out = F.relu(conv_bn(x, f"{prefix}_branch2a", stride))
        out = F.relu(conv_bn(out, f"{prefix}_branch2b", 1, 1))
    else:
        out = F.relu(conv_bn(x, f"{prefix}_branch2a"))
        out = resnet.conv(out, params[f"{prefix}_branch2b_w"], stride, 1, groups)
        out = F.relu(resnet.affine(out, params[f"{prefix}_branch2b_bn_s"],
                                   params[f"{prefix}_branch2b_bn_b"]))
    return F.relu(conv_bn(out, f"{prefix}_branch2c") + shortcut)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("has_proj,groups,frozen", [(True, 1, False), (False, 1, False),
                                                    (True, 8, False), (True, 1, True)])
def test_autograd_path_is_the_unfused_chain(dtype, has_proj, groups, frozen):
    """Grad mode on, weights that require grad (res3 and up in a training
    step) or none (the frozen stem and res2): the same ops as the unfused
    chain, and the same output and gradients bit for bit."""
    dt = DTYPES[dtype]
    cin = 32 if has_proj else 64
    base = _block_params(11, cin, 32, 64, has_proj, groups)
    x = _cl(torch.randn(2, cin, 6, 6, generator=torch.Generator().manual_seed(2)).to(dt))
    runs = []
    for fn in (resnet.bottleneck, _parent_bottleneck):
        leaves = {k: v.clone().requires_grad_(not frozen and not k.endswith(("_bn_s", "_bn_b")))
                  for k, v in base.items()}
        with _Ops() as ops:
            out = fn(leaves, x, "b", 2 if has_proj else 1, has_proj, groups)
        if not frozen:
            out.float().square().sum().backward()
        runs.append((ops.ops, out.detach(), {k: v.grad for k, v in leaves.items()}))
    (ops, out, grads), (ops_exp, out_exp, grads_exp) = runs
    assert ops == ops_exp
    assert torch.equal(out, out_exp)
    for k, g in grads_exp.items():
        assert (g is None) == (grads[k] is None), k
        if g is not None:
            assert torch.equal(grads[k], g), k


def test_stem_runs_fused_only_with_grad_mode_off(trunk):
    """The stem with its frozen weights: fused with grad mode off, unfused
    with it on (a training step's frozen conv1), and the two agree; a batch
    of one broadcast from a single image (a zero batch stride) still gives
    the epilogue a channels_last output."""
    hwc = torch.randn(32, 48, 3, generator=torch.Generator().manual_seed(4))
    x = hwc.as_strided((1, 3, 32, 48), (0, 1, 144, 3))  # its NCHW view, batch stride 0
    stem = {k: trunk[k] for k in ("conv1_w", "res_conv1_bn_s", "res_conv1_bn_b")}
    calls = []
    saved = resnet.conv_epilogue
    resnet.conv_epilogue = lambda *a, **k: calls.append(1) or saved(*a, **k)
    try:
        with torch.no_grad():
            fused = resnet.stem(stem, x)
        unfused = resnet.stem(stem, x)
    finally:
        resnet.conv_epilogue = saved
    assert len(calls) == 1
    torch.testing.assert_close(fused, unfused, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("body,expected", [("fpn", 1 + 16 * 3 + 8), ("c4", 1 + 13 * 3),
                                           ("c5_head", 3 * 3)])
def test_epilogue_calls_a_trunk_makes(trunk, body, expected):
    """The conv epilogue's calls: one for the stem, three a bottleneck (the
    projection's bias joins its block's closing epilogue), one per FPN
    conv; R-50 FPN 57, C4's body to res4 40, res5 on rois 9."""
    calls = []
    saved = resnet.conv_epilogue, fpn.conv_epilogue

    def counted(*a, **k):
        calls.append(1)
        return saved[0](*a, **k)

    resnet.conv_epilogue = fpn.conv_epilogue = counted
    try:
        with torch.inference_mode():
            if body == "fpn":
                params = dict(trunk, **params_from_jax(fpn.init_fpn_params()))
                x = torch.randn(1, 64, 64, 3).bfloat16()
                fpn.fpn_neck(params, resnet.multilevel_body(params, x))
            elif body == "c4":
                resnet.c4_body(trunk, torch.randn(1, 32, 32, 3).bfloat16())
            else:
                resnet.c5_head(trunk, torch.randn(2, 14, 14, 1024).bfloat16())
    finally:
        resnet.conv_epilogue, fpn.conv_epilogue = saved
    assert len(calls) == expected


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,residual,relu", [
    ((8, 64, 208, 336), False, True),     # R-50 res2 branch2a at batch 8
    ((8, 1024, 52, 84), True, True),      # res4 branch2c with its shortcut
    ((8, 1024, 52, 84), False, True),     # X-101 res4 grouped branch2b
    ((8, 256, 13, 21), False, False),     # an FPN neck conv, bias only
    ((3, 2048, 7, 7), True, False),
    ((1, 8, 1, 3), True, True),
])
def test_epilogue_kernel_equals_mirror(card, dtype, shape, residual, relu):
    dt = DTYPES[dtype]
    y, r, b = _epilogue_inputs(sum(shape), shape, dt)
    y, r, b = y.to(card), r.to(card), b.to(card)
    exp = cek.epilogue_mirror(y.clone(), b, r if residual else None, relu)
    before = cek.conv_epilogue.launches
    got = cek.conv_epilogue(y, b, r if residual else None, relu)
    torch.cuda.synchronize(card)
    assert got is y and cek.conv_epilogue.launches == before + 1
    assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,groups", [((64, 3, 7, 7), 1), ((1024, 16, 3, 3), 64),
                                          ((2048, 1024, 1, 1), 1)])
def test_fold_kernel_equals_mirror(card, dtype, shape, groups):
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(shape[0])
    w = torch.randn(shape, generator=g)
    s = torch.rand(shape[0], generator=g)
    for layout in (w, _cl(w)):
        got = cek.fold_scale(layout.to(card), s.to(card), dt)
        torch.cuda.synchronize(card)
        assert got.stride() == layout.stride()
        assert torch.equal(got.cpu(), cek.fold_mirror(layout, s, dt))
