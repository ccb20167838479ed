"""The layer norm's kernel route (``csrc/layer_norm.cu``: ``aat_layer_norm_fwd``
and ``aat_layer_norm_bwd``, behind ``ops/layer_norm.layer_norm``), on the CPU:

- on the meta device, with a library that records the C entries it is
  asked for, every ``_layer_norm`` of ``hubert_encode`` reaches the forward
  entry (and, under autograd, the backward entry), the conv stack's and the
  feature projection's in the channel-first layout with no copy of x, the
  encoder's in rows, in bf16 and f32; the statistics are written only when
  a gradient is wanted; a conv-stack layer saves 6 bytes a value for the
  backward where the plain composite saves 16;
- the dtypes and widths the kernel does not take raise; odd T is taken;
- the backward formula the kernel computes, written in plain torch ops on
  both layouts, against autograd of the composite in f64;
- the benchmark's reader of the kernels' time, ``layer_norm.device_ms``.

The C declarations are held against the ctypes signatures with every other
entry's (``test_torch_flash_fwd_mma.test_c_entries_match_ctypes_signatures``);
``chip_smoke.py`` (``phase_layer_norm``) holds the kernel to the plain
version on the card."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from _recording_library import meta_library  # noqa: F401  (the fixture)
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.ops import layer_norm as tln
from aat_tpu_torch.training.optim import tree_map

# conv widths the channel-first kernels take (a multiple of 32), rows of 64
CONFIG = dataclasses.replace(thub.tiny_test_config(), conv_dim=(32, 32, 32), hidden_size=64,
                             num_attention_heads=4, intermediate_size=128)
COPIES = {torch.ops.aten.clone.default, torch.ops.aten.copy_.default,
          torch.ops.aten._to_copy.default}


class Ops(TorchDispatchMode):
    """Records the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def meta_params(dtype, requires_grad=False):
    params = thub.init_hubert_params(0, CONFIG)

    def leaf(t):
        t = t.to(dtype).to("meta") if t.is_floating_point() else t.to("meta")
        return t.requires_grad_(requires_grad) if t.is_floating_point() else t

    return tree_map(leaf, params)


def fwd_layouts(lib):
    """The layout argument of each forward launch."""
    return [args[8] for name, args in zip(lib.names, lib.args) if name == "aat_layer_norm_fwd"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_hubert_site_reaches_the_kernel(meta_library, dtype):
    """3 conv layers and the feature projection channel-first, two norms a
    layer and the final norm in rows; each forward launch's backward."""
    params = meta_params(dtype, requires_grad=True)
    wave = torch.empty((2, 1600), dtype=dtype, device="meta")
    hidden, _ = thub.hubert_encode(params, CONFIG, wave)
    n_layers = CONFIG.num_hidden_layers
    want = [tln.CHANNELS_FIRST] * 4 + [tln.ROWS] * (2 * n_layers + 1)
    assert fwd_layouts(meta_library) == want
    assert all(args[4] is not None and args[6:8] == (tln._DTYPES[dtype],) * 2
               for args in meta_library.args)  # statistics saved; x and scale in dtype
    conv_t = [args[11] for args in meta_library.args[:3]]
    assert conv_t == [319, 159, 79] and meta_library.args[3][11] == 79  # odd T
    assert [args[9:11] for args in meta_library.args] == (
        [(2, 32)] * 4 + [(2 * 79, 64)] * (2 * n_layers + 1))
    torch.autograd.grad(hidden.sum(), [params["feature_extractor"][0]["layer_norm"]["scale"]])
    assert meta_library.names.count("aat_layer_norm_bwd") == len(want)
    bwd = [args for name, args in zip(meta_library.names, meta_library.args)
           if name == "aat_layer_norm_bwd"]
    assert sorted(args[12] for args in bwd) == sorted(want)
    assert all(args[6] is not None and args[9] == tln.PARTIALS for args in bwd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_stack_norms_copy_nothing(meta_library, dtype):
    """The conv stack's norms read the conv output where it lies and GELU
    reads the kernel's own [B, C, T] (rows padded to whole lines): no copy
    in the forward, none in the backward."""
    params = meta_params(dtype, requires_grad=True)
    wave = torch.empty((2, 1600), dtype=dtype, device="meta")
    with Ops() as fwd:
        features = thub._conv_stack(params, CONFIG, wave)
    with Ops() as bwd:
        torch.autograd.grad(features.sum(), [params["feature_extractor"][0]["conv"]["kernel"]])
    assert fwd_layouts(meta_library) == [tln.CHANNELS_FIRST] * 3
    assert not COPIES & set(fwd.ops), [op for op in fwd.ops if op in COPIES]
    assert not COPIES & set(bwd.ops), [op for op in bwd.ops if op in COPIES]
    assert meta_library.names.count("aat_layer_norm_bwd") == 3


def test_statistics_only_when_a_gradient_is_wanted(meta_library):
    params = meta_params(torch.bfloat16)
    wave = torch.empty((2, 1600), dtype=torch.bfloat16, device="meta")
    thub.hubert_encode(params, CONFIG, wave)
    assert meta_library.names == ["aat_layer_norm_fwd"] * (4 + 2 * CONFIG.num_hidden_layers + 1)
    assert all(args[4] is None and args[5] is None for args in meta_library.args)


def conv_layer_saved_bytes(device, dtype):
    """Bytes saved for the backward by one conv layer's norm, its GELU and
    the next conv (which reads the GELU's output): ``(a value of the
    layer's output, a position's statistics)``."""
    params = thub.init_hubert_params(0, CONFIG)
    layers = [{k: {n: t.to(dtype).to(device).requires_grad_(True) for n, t in v.items()}
               for k, v in layer.items()} for layer in params["feature_extractor"][1:]]
    h = torch.zeros((2, 32, 319), dtype=dtype, device=device, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = F.conv1d(h, layers[0]["conv"]["kernel"], layers[0]["conv"]["bias"], stride=2)
        y = thub._layer_norm(y.transpose(1, 2), layers[0]["layer_norm"], 1e-5).transpose(1, 2)
        F.conv1d(F.gelu(y), layers[1]["conv"]["kernel"], layers[1]["conv"]["bias"], stride=2)
    positions = 2 * 159

    def per(size):
        return sum(t.numel() * t.element_size() for t in saved if t.numel() == size) / size

    return per(32 * positions), per(positions)


def test_a_conv_layer_saves_6_bytes_a_value_where_the_composite_saves_16(meta_library):
    """The kernel keeps x, and GELU's input and the next conv's are bf16:
    6 bytes a value; the composite adds three f32 copies. Both keep two f32
    statistics a position."""
    assert conv_layer_saved_bytes("meta", torch.bfloat16) == (6.0, 8.0)
    assert conv_layer_saved_bytes("cpu", torch.bfloat16) == (16.0, 8.0)


@pytest.mark.parametrize("shape", [(40, 512, 40607), (1, 512, 575999)])
def test_odd_t_channel_first(meta_library, shape):
    """Layer 0's T at 12.69 s and the long-form one are odd: the kernel
    takes them where they lie, and writes y's rows padded to whole lines."""
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    w = torch.empty(512, dtype=torch.bfloat16, device="meta")
    y = tln.layer_norm(x.transpose(1, 2), w, w, 1e-5)
    ldy = -(-shape[2] // tln.ROW_PAD) * tln.ROW_PAD  # rows on whole 128-byte lines
    assert y.shape == (shape[0], shape[2], 512) and y.stride() == (512 * ldy, 1, ldy)
    assert meta_library.args[0][8:13] == (tln.CHANNELS_FIRST, shape[0], 512, shape[2], ldy)


@pytest.mark.parametrize("c, layout", [(1024, tln.ROWS), (48, tln.ROWS), (512, tln.CHANNELS_FIRST),
                                       (32, tln.CHANNELS_FIRST)])
def test_channel_first_widths_past_the_kernel_go_through_rows(meta_library, c, layout):
    """A transposed view whose C the channel-first kernels do not take (past
    512, or off a multiple of 32) is copied into rows."""
    x = torch.empty((2, c, 37), dtype=torch.float32, device="meta").transpose(1, 2)
    w = torch.empty(c, device="meta")
    with Ops() as ops:
        tln.layer_norm(x, w, w, 1e-5)
    assert meta_library.args[0][8] == layout
    assert (torch.ops.aten.clone.default in ops.ops) == (layout == tln.ROWS)


@pytest.mark.parametrize("x_dtype, w_dtype", [(torch.float16, torch.float16),
                                              (torch.float64, torch.float64),
                                              (torch.bfloat16, torch.float16)])
def test_other_dtypes_raise(meta_library, x_dtype, w_dtype):
    x = torch.empty((4, 64), dtype=x_dtype, device="meta")
    w = torch.empty(64, dtype=w_dtype, device="meta")
    with pytest.raises(ValueError, match="layer norm kernel"):
        tln.layer_norm(x, w, w, 1e-5)
    assert meta_library.names == []


@pytest.mark.parametrize("c", [12, 4, 4104, 8192])
def test_widths_the_kernel_does_not_take_raise(meta_library, c):
    x = torch.empty((4, c), dtype=torch.bfloat16, device="meta")
    w = torch.empty(c, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        tln.layer_norm(x, w, w, 1e-5)
    assert meta_library.names == []


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_mixed_dtypes_and_the_widest_rows(meta_library, w_dtype):
    """bf16 x with f32 parameters (each read in its own dtype), and the
    transformer_encoder projection's 4096."""
    x = torch.empty((3, 7, 4096), dtype=torch.bfloat16, device="meta")
    w = torch.empty(4096, dtype=w_dtype, device="meta")
    y = tln.layer_norm(x, w, w, 1e-5)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert meta_library.args[0][6:12] == (1, tln._DTYPES[w_dtype], tln.ROWS, 21, 4096, 1)


def test_a_misaligned_start_goes_through_a_copy(meta_library):
    x = torch.empty(4 * 64 + 8, dtype=torch.bfloat16, device="meta")[3:3 + 4 * 64].view(4, 64)
    w = torch.empty(64, dtype=torch.bfloat16, device="meta")
    with Ops() as ops:
        tln.layer_norm(x, w, w, 1e-5)
    assert torch.ops.aten.clone.default in ops.ops and meta_library.args[0][0] % 16 == 0


def test_a_cpu_tensor_takes_the_plain_version(meta_library):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(1, 2, (5, 7, 64)).astype(np.float32)).to(torch.bfloat16)
    w, b = (torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32)) for _ in range(2))
    assert torch.equal(tln.layer_norm(x, w, b, 1e-5), tln.layer_norm_reference(x, w, b, 1e-5))
    assert meta_library.names == []


def kernel_backward(x_bct, dy_bct, scale, eps):
    """What ``aat_layer_norm_bwd`` computes, channel-first ``[B, C, T]`` over
    C (the rows layout is the same with C last): x̂ from x and the forward's
    mean and rstd, g = dy·scale, dx = rstd·(g − Σg/C − x̂·Σ(g·x̂)/C), and
    dscale = Σ dy·x̂, dbias = Σ dy over every position."""
    c = x_bct.shape[1]
    mean = x_bct.sum(1, keepdim=True) / c
    rstd = torch.rsqrt(((x_bct - mean) ** 2).sum(1, keepdim=True) / c + eps)
    xh = (x_bct - mean) * rstd
    g = dy_bct * scale[None, :, None]
    dx = rstd * (g - g.sum(1, keepdim=True) / c - xh * (g * xh).sum(1, keepdim=True) / c)
    return dx, (dy_bct * xh).sum((0, 2)), dy_bct.sum((0, 2))


@pytest.mark.parametrize("layout", ["rows", "channel_first"])
def test_the_kernels_backward_is_autograd_of_the_composite(layout):
    rng = np.random.default_rng(7)
    b, c, t = 3, 32, 19
    x, dy = (torch.from_numpy(rng.normal(0.5, 2.0, (b, c, t))) for _ in range(2))
    scale, bias = (torch.from_numpy(rng.normal(0, 1, c)) for _ in range(2))
    leaves = [x.clone().requires_grad_(True), scale.clone().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    if layout == "rows":  # [B·T, C] contiguous rows
        x_in, dy_in = (a.transpose(1, 2).reshape(b * t, c) for a in (leaves[0], dy))
    else:  # the transposed view of [B, C, T]
        x_in, dy_in = leaves[0].transpose(1, 2), dy.transpose(1, 2)
    y = tln.layer_norm_reference(x_in, leaves[1], leaves[2], 1e-5)
    assert y.dtype == torch.float64
    want = torch.autograd.grad(y, leaves, dy_in)
    got = kernel_backward(x, dy, scale, 1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_the_reader_of_the_kernels(monkeypatch):
    from portbench import common
    from portbench.yardstick import spans

    reader = common.load_reader("layer_norm.device_ms")
    assert reader.MOVES == "train_audio_s_per_s"
    ops = [("void (anonymous namespace)::layer_norm_cf_fwd<float, float>(...)", 0.0, 9000.0),
           ("void (anonymous namespace)::layer_norm_rows_bwd<float, float, 8>(...)", 1e4, 3e4),
           ("void (anonymous namespace)::layer_norm_finish<float>(...)", 3e4, 3.1e4),
           ("void at::native::elementwise_kernel<128, 2>(...)", 0.0, 5e5)]
    monkeypatch.setattr(spans, "port_counters", lambda: {"span.train.step.calls": 2})
    assert reader.read({"device_ops": ops}) == pytest.approx(15.0)
    # the parent: no such kernels; no traced step or no trace
    assert reader.read({"device_ops": ops[3:]}) is None
    assert reader.read({}) is None
    for table in (None, {}, {"span.train.step.calls": 0}):
        monkeypatch.setattr(spans, "port_counters", lambda: table)
        assert reader.read({"device_ops": ops}) is None
