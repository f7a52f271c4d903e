"""The eval-mode bf16 conv epilogue (``nn/layers.py::conv_epilogue_torch``,
the plain version of ``csrc/conv_epilogue.cu``) against the forward's own
inline epilogue (bit for bit), against ``jax.jit`` of yolojax's epilogue
(``yolojax/nn/layers.py::batch_norm`` / the bias add, ``leaky_relu``, the
cast), and in the exported bf16 serving program, on the CPU."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.models import get_model as jax_get_model
from yolojax.nn import layers as jax_layers
from yolojax_torch.cli.detect import build_serving
from yolojax_torch.config import load_config
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import params_from_jax
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.eval.evaluator import make_infer_fn, serving_weights
from yolojax_torch.kernels import ops
from yolojax_torch.models import get_model
from yolojax_torch.nn import cuda_epilogue
from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    bn_affine,
    conv_epilogue_torch,
)
from yolojax_torch.nn.stem import fuse_stem
from yolojax_torch.serve import ServingModule

from .test_torch_layers import random_jax_weights

EPS, ALPHA = 1e-5, 0.1
OP = "yolojax_torch.conv_epilogue.default"
# the bf16 head of a whole forward, port vs yolojax, of max|ref|: both sum
# each conv in f32 and round it to bf16, in other orders (oneDNN vs XLA), so
# an output may sit one bf16 ulp apart and the difference compounds layer
# by layer. Measured: 1.2e-2 on Darknet-19 @64, 5.9e-3 on the v1 head.
HEAD_RTOL = 3e-2
# BN mode vs jax.jit: XLA's CPU backend contracts x * inv + shift into one
# FMA (a quarter of the f32 values differ from the two roundings) and its
# rsqrt sits up to 2 f32 ulps from torch's, so after the cast to bf16 a few
# values are one bf16 ulp apart. Measured: 6 of 405,504 at C = 1024.
BN_JIT_MAX_FRACTION = 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def epilogue_inputs(shape, seed):
    """bf16 ``y`` of ``shape`` (channel last) and f32 per-channel vectors
    (bias, BN scale, bias, mean, var) from numpy, with the specials: a row
    of +0, one of -0, one of +-inf and NaN, one whose sum with the bias is
    a bf16 rounding tie (y a bf16 value, the bias half its ulp), and a row
    of values on or one step from leaky's zero."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    y = rng.normal(0, 2, shape).astype(np.float32).reshape(-1, c)
    b = rng.normal(0, 0.5, c).astype(np.float32)
    y = torch.from_numpy(y).bfloat16().float().numpy()  # bf16 values
    y[0] = 0.0
    y[1] = -0.0
    y[2] = np.where(np.arange(c) % 3 == 0, np.inf,
                    np.where(np.arange(c) % 3 == 1, -np.inf, np.nan))
    # y[3] + b_tie is a tie: half the bf16 ulp of y[3], away from zero (so
    # the sum stays in y[3]'s binade)
    exp = np.floor(np.log2(np.abs(y[3])))
    b_tie = (np.sign(y[3]) * 2.0 ** (exp - 8)).astype(np.float32)
    y[4] = np.where(np.arange(c) % 2 == 0, -b, -b + np.spacing(np.abs(b)))
    bn = [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c),
          rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c)]
    bn = [torch.from_numpy(v.astype(np.float32)) for v in bn]
    yb = torch.from_numpy(y.reshape(shape)).bfloat16()
    return yb, torch.from_numpy(b), torch.from_numpy(b_tie), bn


def parent_epilogue(y, b=None, bn=None, *, leaky):
    """The forward's inline epilogue before it became one op, as written
    there: ``.float()``, the bias add or ``batch_norm``, ``leaky_relu``,
    the cast."""
    y = y.float()
    if bn is not None:
        scale, bias, mean, var = bn
        inv = torch.rsqrt(var.float() + EPS) * scale.float()
        y = y.float() * inv + (bias.float() - mean.float() * inv)
    else:
        y = y + b.float()
    if leaky:
        y = torch.where(y >= 0, y, ALPHA * y)
    return y.to(torch.bfloat16)


def assert_bits_equal(got, want):
    """bf16 bit for bit, NaN by NaN-ness (payloads may differ)."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])


SHAPES = {"C32": (2, 5, 7, 32), "C125": (2, 5, 7, 125),
          "C1024": (1, 3, 4, 1024), "dense": (6, 4096)}
MODES = ("bias_leaky", "bias_linear", "bn_leaky")


def _case(shape, mode, seed):
    y, b, b_tie, bn = epilogue_inputs(SHAPES[shape], seed)
    leaky = mode != "bias_linear"
    if mode == "bn_leaky":
        inv, shift = bn_affine(*bn, eps=EPS)
        return y, shift, inv, leaky, bn, b_tie
    return y, b, None, leaky, None, b_tie


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_equals_parent_inline(shape, mode):
    """``conv_epilogue_torch`` (through the custom op, whose CPU
    implementation it is) equals the forward's former inline sequence bit
    for bit, specials and bf16 rounding ties included."""
    y, b, scale, leaky, bn, b_tie = _case(shape, mode, seed=1)
    raw_b = b if bn is None else None
    want = parent_epilogue(y, raw_b, bn, leaky=leaky)
    assert_bits_equal(conv_epilogue_torch(y, b, scale, leaky=leaky), want)
    assert_bits_equal(ops.conv_epilogue(y, b, scale, leaky, ALPHA), want)
    if bn is None:  # the tie row: z = y[3] + half its ulp, exactly
        rows = y.reshape(-1, y.shape[-1])
        tie = conv_epilogue_torch(rows[3:4], b_tie, leaky=leaky)
        assert_bits_equal(tie, parent_epilogue(rows[3:4], b_tie, leaky=leaky))
        exact = rows[3].float() + b_tie  # exact in f32, halfway at bf16
        finite = torch.isfinite(exact)
        assert bool(((exact.view(torch.int32) & 0xFFFF) == 0x8000)[finite]
                    .all())


@functools.partial(jax.jit, static_argnames="leaky")
def _jax_epilogue(y, vectors, *, leaky):
    # apply_network's epilogue (yolojax/nn/layers.py:395-420), one program
    yf = y.astype(jnp.float32)
    if len(vectors) == 1:
        z = yf + vectors[0].astype(jnp.float32)
    else:
        z = jax_layers.batch_norm(yf, *vectors, eps=EPS)
    if leaky:
        z = jax_layers.leaky_relu(z, ALPHA)
    return z.astype(jnp.bfloat16)


def jax_epilogue(y, b=None, bn=None, *, leaky):
    """yolojax's epilogue under ``jax.jit``, as ``apply_network`` runs it,
    on numpy copies of the inputs: the bias ``b``, or BN's (scale, bias,
    mean, var) ``bn``."""
    yj = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16)
    vectors = tuple(v.numpy() for v in ([b] if bn is None else bn))
    out = _jax_epilogue(yj, vectors, leaky=leaky).astype(jnp.float32)
    return torch.from_numpy(np.array(out)).bfloat16()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jitted_yolojax(shape, mode):
    """Bias modes: bit-equal to ``jax.jit`` of yolojax's epilogue. BN mode:
    within one bf16 ulp, on at most BN_JIT_MAX_FRACTION of the values (see
    there: XLA contracts the affine into an FMA and rounds rsqrt its own
    way; the port keeps the forward's two roundings, which the card's
    kernel reproduces)."""
    y, b, scale, leaky, bn, _ = _case(shape, mode, seed=2)
    got = conv_epilogue_torch(y, b, scale, leaky=leaky)
    want = jax_epilogue(y, b if bn is None else None, bn, leaky=leaky)
    if bn is None:
        assert_bits_equal(got, want)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g = got.view(torch.int16)[~nan].int()
    w = want.view(torch.int16)[~nan].int()
    ulps = (torch.where(g < 0, -(g & 0x7FFF), g)
            - torch.where(w < 0, -(w & 0x7FFF), w)).abs()
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) <= BN_JIT_MAX_FRACTION * ulps.numel()


# ---------------------------------------------------------------------------
# the forward and the exported serving program
# ---------------------------------------------------------------------------

SMALL = {"v2": ("yolo2", "tiny", 3, 64), "v1": ("yolo", "tiny", 3, 64),
         "darknet19": ("yolo2", "darknet", 20, 64)}


def small_pair(key, fold=True, seed=5):
    """yolojax and port models with the same random weights (BN statistics
    included), folded as serving folds them unless ``fold`` is False."""
    name, inference, classes, dim = SMALL[key]
    jm, tm = (jax_get_model(name, inference, classes),
              get_model(name, inference, classes))
    params, state = random_jax_weights(jm, dim, seed=seed)
    net = params_from_jax(tm, params, state)
    if fold:
        jm, params, state = jax_fold_bn(jm, params, state)
        tm, net = fold_bn(tm, net)
    x = np.random.RandomState(seed + 1).uniform(
        0, 1, (2, dim, dim, 3)).astype(np.float32)
    return jm, params, state, tm, net, x


def n_epilogues(model) -> int:
    return sum(isinstance(s, (ConvSpec, DenseSpec)) for s in model.specs)


@pytest.mark.parametrize("key", ["darknet19", "v1"])
def test_forward_epilogues_match_jitted_yolojax(key):
    """Every conv and dense epilogue of a folded bf16 forward equals
    ``jax.jit`` of yolojax's epilogue on its own input, bit for bit; and the
    head is within HEAD_RTOL of yolojax's bf16 ``apply`` on the same
    weights."""
    jm, params, state, tm, net, x = small_pair(key)
    seen = []

    def held(y, b, scale=None, *, leaky, alpha=ALPHA):
        got = conv_epilogue_torch(y, b, scale, leaky=leaky, alpha=alpha)
        assert scale is None and alpha == ALPHA
        assert_bits_equal(got, jax_epilogue(y, b, leaky=leaky))
        seen.append(tuple(y.shape))
        return got

    with mock.patch.object(cuda_epilogue, "conv_epilogue_cuda", held), \
            torch.inference_mode():
        got = tm.apply(net, torch.from_numpy(x),
                       compute_dtype=torch.bfloat16).numpy()
    assert len(seen) == n_epilogues(tm)
    ref = np.asarray(jax.jit(lambda p, s, im: jm.apply(
        p, s, im, compute_dtype=jnp.bfloat16)[0])(params, state, x))
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= HEAD_RTOL * np.abs(ref).max()


def _exported_ops(infer_fn, net, x):
    with torch.no_grad():
        program = torch.export.export(ServingModule(infer_fn, net), (x,))
    return [str(n.target) for n in program.graph.nodes
            if "yolojax_torch" in str(n.target)]


def _infer(tm, dtype):
    return make_infer_fn(tm, score_thresh=0.001, iou_thresh=0.45, top_k=32,
                         compute_dtype=dtype)


@pytest.mark.parametrize("key", ["v2", "v1"])
def test_export_holds_one_op_per_layer(key):
    """``torch.export`` of the bf16 serving program holds one
    ``conv_epilogue`` node for each conv and dense layer (one fewer with
    the fused stem, whose kernel takes conv0's), and the f32 program none.
    The bf16 head equals a forward that calls ``conv_epilogue_torch``
    directly, bit for bit."""
    _, _, _, tm, net, x = small_pair(key)
    x = torch.from_numpy(x)
    bf16 = serving_weights(net, torch.device("cpu"), torch.bfloat16)
    targets = _exported_ops(_infer(tm, torch.bfloat16), bf16, x)
    assert targets.count(OP) == n_epilogues(tm)
    if key == "v2":
        fm, fnet = fuse_stem(tm, small_pair(key)[4], impl="pallas")
        fnet = serving_weights(fnet, torch.device("cpu"), torch.bfloat16)
        targets = _exported_ops(_infer(fm, torch.bfloat16), fnet, x)
        assert targets.count(OP) == n_epilogues(tm) - 1
        assert "yolojax_torch.stem_fused.default" in targets
    f32 = serving_weights(small_pair(key)[4], torch.device("cpu"),
                          torch.float32)
    assert OP not in _exported_ops(_infer(tm, torch.float32), f32, x)

    calls = []

    def direct(y, b, scale=None, *, leaky, alpha=ALPHA):
        calls.append(1)
        return conv_epilogue_torch(y, b, scale, leaky=leaky, alpha=alpha)

    with torch.inference_mode():
        via_op = tm.apply(bf16, x, compute_dtype=torch.bfloat16)
        with mock.patch.object(cuda_epilogue, "conv_epilogue_cuda", direct):
            plain = tm.apply(bf16, x, compute_dtype=torch.bfloat16)
    assert len(calls) == n_epilogues(tm)
    assert torch.equal(via_op.view(torch.int32), plain.view(torch.int32))


def test_train_mode_and_unfolded_bn():
    """Train mode at bf16 reaches the op through the train-mode Function
    (``nn/train_epilogue.py``): its export holds one ``conv_epilogue`` node
    for each conv and two ``bn_channel_sums`` for each BN conv, and a
    train step's forward calls the wrapper with BN's (inv, shift) of the
    batch statistics; f32 train mode calls no wrapper; an unfolded
    eval-mode bf16 forward reaches it with BN's (inv, shift) of the
    running statistics."""
    _, _, _, tm, net, x = small_pair("v2", fold=False)
    x = torch.from_numpy(x)

    class Train(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, images):
            return tm.apply(self.net, images, compute_dtype=torch.bfloat16,
                            train=True)[0]

    with torch.no_grad():
        program = torch.export.export(Train(), (x,))
    targets = [str(n.target) for n in program.graph.nodes]
    bn_convs = [s.bn for s in tm.specs if isinstance(s, ConvSpec)]
    assert targets.count(OP) == n_epilogues(tm)
    assert targets.count("yolojax_torch.bn_channel_sums.default") == (
        2 * sum(bn_convs))
    modes = []

    def spy(y, b, scale=None, *, leaky, alpha=ALPHA):
        modes.append(scale is not None)
        return conv_epilogue_torch(y, b, scale, leaky=leaky, alpha=alpha)

    with mock.patch.object(cuda_epilogue, "conv_epilogue_cuda", spy):
        tm.apply(net, x, compute_dtype=torch.bfloat16, train=True)
        assert modes == bn_convs and any(modes)
        tm.apply(net, x, compute_dtype=torch.float32, train=True)
        assert modes == bn_convs
        with torch.inference_mode():
            tm.apply(net, x, compute_dtype=torch.bfloat16)
    assert modes == bn_convs * 2


def test_portable_build_has_no_op(tmp_path):
    """``build_serving(portable=True)``, the program the TF exports bake,
    is f32 and launches no epilogue."""
    _, _, _, tm, net, x = small_pair("v2", fold=False)
    npz = str(tmp_path / "w.npz")
    save_network_npz(npz, tm, net)
    ini = tmp_path / "t.ini"
    ini.write_text("[model]\nmodel = yolo2\ninference = tiny\ndim = 64\n"
                   "num_classes = 3\n[detect]\nthreshold = 0.001\n"
                   "top_k = 32\n")
    cfg = load_config([str(ini)])
    _, _, infer_fn, pnet, _ = build_serving(cfg, npz, device="cpu",
                                            portable=True)
    assert OP not in _exported_ops(infer_fn, pnet, torch.from_numpy(x))


def test_wrapper_check_refuses():
    """The wrapper's checks, run on CPU tensors here (on the card they run
    before every launch): a wrong dtype, a wrong bias length, a wrong scale
    and a y whose channels are not contiguous rows."""
    y = torch.zeros((2, 4, 4, 16), dtype=torch.bfloat16)
    b = torch.zeros(16)
    cuda_epilogue._check(y, b, None)
    cuda_epilogue._check(y, b, torch.ones(16))
    wide = torch.zeros((8, 40), dtype=torch.bfloat16)
    cuda_epilogue._check(wide[:, 3:19], b, None)  # a column slice: taken
    assert cuda_epilogue.row_stride(cuda_epilogue._rows(wide[:, 3:19])) == 40
    for bad_y, bad_b, bad_s in (
            (y.float(), b, None),                    # f32 y
            (y.half(), b, None),                     # f16 y
            (y, torch.zeros(15), None),              # short bias
            (y, b.double(), None),                   # f64 bias
            (y, b, torch.ones(8)),                   # short scale
            (y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
             b, None),                               # NCHW memory
            (wide.t(), torch.zeros(8), None)):       # column-major
        with pytest.raises(ValueError):
            cuda_epilogue._check(bad_y, bad_b, bad_s)
