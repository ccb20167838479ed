"""The flash forward's two kernels, both on the tensor cores: bf16 operands
go to ``aat_flash_fwd_mma`` (``csrc/flash_fwd_mma.cu``), f32 operands to
the 3xTF32 kernel ``aat_flash_fwd_tf32x3`` (``csrc/flash_fwd_tf32x3.cu``),
behind one wrapper per TPU kernel; and the one launch helper
(``kernels.launch``) that every wrapper goes through.

The dispatch runs on the meta device (shapes without data) with a library
that records the C entries it is asked for and the device made current
around each; the C declarations are held against the ctypes signatures,
since no compiler runs here. The keep-mask identity construction (v[k] =
e_k with S = D, so out[q, k] is the dropped, scaled p[q, k] and out == 0
exactly where a key was dropped) is pinned on the plain version and on the
JAX flash forward (Pallas in interpret mode): ``chip_smoke.py`` reads each
forward kernel's mask the same way on the card."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt
from _recording_library import RecordingLibrary, meta_library  # noqa: F401  (the fixture)
from aat_tpu_torch.ops import mel as tmel
from aat_tpu_torch.ops import vq as tvq
from aat_tpu_torch.runtime import kernels


def meta_operands(dtype, t=300, h=4, kvh=2, d=128, head_stride=None):
    """q [1, T, H, D], k/v [1, T, KVH, D] on the meta device; ``head_stride``
    lays q's heads that many elements apart (a view of a wider buffer)."""
    if head_stride is None:
        q = torch.empty((1, t, h, d), dtype=dtype, device="meta")
    else:
        q = torch.empty((1, t, h, head_stride), dtype=dtype, device="meta")[..., :d]
    k, v = (torch.empty((1, t, kvh, d), dtype=dtype, device="meta") for _ in range(2))
    mask = torch.ones((1, t), dtype=torch.int32, device="meta")
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype, entry", [(torch.bfloat16, "aat_flash_fwd_mma"),
                                          (torch.float32, "aat_flash_fwd_tf32x3")])
def test_forward_dispatch_by_dtype(meta_library, dtype, entry, causal):
    """One launch through the entry of the operands' dtype, counted on the
    wrapper of the TPU kernel it replaces."""
    wrapper = tatt.flash_forward_causal_kernel if causal else tatt.flash_forward_kernel
    before = wrapper.launches
    q, k, v, mask = meta_operands(dtype)
    out, lse = tatt.flash_forward(q, k, v, mask, 128 ** -0.5, causal, 0.1, 7, None,
                                  need_lse=True)
    assert meta_library.names == [entry]
    assert wrapper.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype and lse.shape == (1, 4, 300)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_bf16_stride_off_eight_raises(meta_library, operand):
    """The tensor-core kernel copies rows in 16-byte chunks: a bf16 operand
    whose head stride is not a multiple of 8 elements is refused, with no
    fallback to another kernel."""
    q, k, v, mask = meta_operands(torch.bfloat16)
    wide = torch.empty(k.shape[:-1] + (132,), dtype=torch.bfloat16, device="meta")
    operands = {"q": q, "k": k, "v": v}
    operands[operand] = (torch.empty((1, 300, 4, 132), dtype=torch.bfloat16, device="meta")
                         if operand == "q" else wide)[..., :128]
    with pytest.raises(ValueError, match="multiples of 8"):
        tatt.flash_forward(*operands.values(), mask, 128 ** -0.5, False, 0.0, 0, None, False)
    assert meta_library.names == []


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_bf16_start_off_sixteen_bytes_raises(meta_library, operand):
    """A bf16 operand that starts 3 elements (6 bytes) into its buffer
    cannot be copied in aligned 16-byte chunks and is refused."""
    q, k, v, mask = meta_operands(torch.bfloat16)
    operands = {"q": q, "k": k, "v": v}
    x = operands[operand]
    operands[operand] = torch.empty(x.numel() + 8, dtype=torch.bfloat16,
                                    device="meta")[3:3 + x.numel()].view(x.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tatt.flash_forward(*operands.values(), mask, 128 ** -0.5, False, 0.0, 0, None, False)
    assert meta_library.names == []


@pytest.mark.parametrize("rate", [1.0, 1.5, -0.1])
def test_dropout_rate_outside_unit_interval_raises(meta_library, rate):
    """The kernels keep a probability where its hash clears ceil(rate·2^24)·2^8,
    a 32-bit threshold only for rates in [0, 1)."""
    q, k, v, mask = meta_operands(torch.bfloat16)
    with pytest.raises(ValueError, match="dropout rate"):
        tatt.flash_forward(q, k, v, mask, 128 ** -0.5, False, rate, 1, None, False)
    assert meta_library.names == []


def test_f32_takes_any_head_stride(meta_library):
    """f32's 16-byte copies are 4 elements, so f32 takes the head stride of
    132 elements that bf16's 8-element rule refuses."""
    q, k, v, mask = meta_operands(torch.float32, head_stride=132)
    tatt.flash_forward(q, k, v, mask, 128 ** -0.5, False, 0.0, 0, None, False)
    assert meta_library.names == ["aat_flash_fwd_tf32x3"]


@pytest.mark.parametrize("fault", ["stride", "start"])
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_f32_forward_refuses_unaligned_operands(meta_library, operand, fault):
    """The 3xTF32 forward copies f32 rows in 16-byte chunks: a head stride
    off 4 elements (130), or a start 2 elements (8 bytes) into the buffer,
    is refused, with no fallback to another kernel."""
    q, k, v, mask = meta_operands(torch.float32)
    operands = {"q": q, "k": k, "v": v}
    x = operands[operand]
    if fault == "stride":
        operands[operand] = torch.empty(x.shape[:-1] + (130,), device="meta")[..., :128]
    else:
        operands[operand] = torch.empty(x.numel() + 4, device="meta")[2:2 + x.numel()].view(
            x.shape)
    match = "multiples of 4" if fault == "stride" else "f32 .* 16-byte boundary"
    with pytest.raises(ValueError, match=match):
        tatt.flash_forward(*operands.values(), mask, 128 ** -0.5, True, 0.0, 0, None, True)
    assert meta_library.names == []


def _launch_five_wrappers():
    """One launch of each wrapper on meta operands: the flash forward, the
    backward's dq and dk/dv kernels (the split route's wrappers, one C
    entry each), mel and vq. Returns the operands' device."""
    q, k, v, mask = meta_operands(torch.float32, kvh=4)
    lse = torch.empty((1, 4, 300), device="meta")
    tatt.flash_forward_kernel(q, k, v, mask, 128 ** -0.5)
    tatt.flash_backward_dq_long(q, k, v, mask, q, lse, q, 128 ** -0.5)
    tatt.flash_backward_dkv_long(q, k, v, mask, q, lse, q, 128 ** -0.5)
    tmel.melspec_kernel(torch.empty((2, 7, tmel.N_FFT), device="meta"))
    x = torch.empty((5, 16), device="meta")
    tvq.nearest_codebook_kernel(x, torch.empty((3, 16), device="meta"),
                                torch.empty((3,), device="meta"))
    return q.device


def test_every_wrapper_launches_through_the_device_guard(meta_library):
    """Each of the five wrappers launches through ``kernels.launch``: the
    operands' device is current around the C call, and the stream passed
    last is that device's."""
    device = _launch_five_wrappers()
    assert meta_library.names == ["aat_flash_fwd_tf32x3", "aat_flash_bwd_dq_tf32x3",
                                  "aat_flash_bwd_dkv_tf32x3", "aat_mel_forward",
                                  "aat_vq_nearest"]
    assert meta_library.devices == [device] * 5
    assert [args[-1] for args in meta_library.args] == [("stream", device)] * 5


def test_launch_makes_the_operands_device_current(meta_library):
    """``kernels.launch`` on a second card: that card is current around the
    C call (the C entries set none), its stream is passed, and the caller's
    device is current again afterwards."""
    second = torch.device("cuda", 1)
    kernels.launch("aat_vq_nearest", second, 1, 2, 3, 4, 5, 6, 7)
    assert meta_library.names == ["aat_vq_nearest"]
    assert meta_library.devices == [second]
    assert meta_library.args[0] == (1, 2, 3, 4, 5, 6, 7, ("stream", second))
    assert meta_library.current is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_launch_nothing(monkeypatch, dtype):
    """A CPU tensor takes the plain version and never reaches the library;
    the kernel wrapper itself refuses it."""
    lib = RecordingLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 40, 2, 64)).astype(np.float32)).to(dtype)
               for _ in range(3))
    mask = torch.ones((1, 40), dtype=torch.int32)
    out = tatt.flash_forward(q, k, v, mask, 0.125, True, 0.0, 0, None, False)
    ref = tatt.reference_attention_bthd(q, k, v, mask, 0.125, causal=True)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_forward_kernel(q, k, v, mask, 0.125)
    assert lib.names == []


_C_TYPES = {"const void*": kernels._P, "void*": kernels._P, "const int*": kernels._P,
            "float*": kernels._P, "const float*": kernels._P, "int*": kernels._P,
            "cudaStream_t": kernels._P, "int": kernels._I, "long long": kernels._I64,
            "float": kernels._F}


def c_parameter_types(name):
    """The parameter types of ``extern "C" int name(...)`` in csrc/*.cu."""
    for fname in sorted(os.listdir(kernels.CSRC)):
        if not fname.endswith(".cu"):
            continue
        with open(os.path.join(kernels.CSRC, fname)) as f:
            found = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", f.read(), re.S)
        if found:
            params = [" ".join(p.split()) for p in found.group(1).split(",")]
            return [re.sub(r"\s*\w+$", "", p).replace(" *", "*") for p in params]
    raise AssertionError(f"no C entry {name} in {kernels.CSRC}")


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_c_entries_match_ctypes_signatures(name):
    """ctypes passes arguments by the declared argtypes: a list that drifts
    from the C declaration would cut pointers or shift every argument."""
    types = c_parameter_types(name)
    assert [_C_TYPES[t] for t in types] == kernels._SIGNATURES[name], types


def identity_case(dtype, b=2, t=24, h=2, s=16, seed=3):
    """q [B, T, H, S], k [B, S, H, S] Gaussian and v[:, key, :, :] = e_key,
    so that out[b, q, h, key] is the dropped, scaled probability of key."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, t, h, s)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, h, s)).astype(np.float32)
    v = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None, :], (b, s, h, s)).copy()
    mask = np.ones((b, s), np.int32)
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)] + [torch.from_numpy(mask)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_v_reveals_the_keep_mask(dtype, causal):
    """On the allowed positions the plain forward's zeros are exactly the
    dropped keys of ``_keep_mask``; the other positions are zero."""
    q, k, v, mask = identity_case(dtype)
    b, t, h, s = q.shape
    rate, seed = 0.5, 97531
    out = tatt.reference_attention_bthd(q, k, v, mask, s ** -0.5, causal, rate, seed)
    kept = (out != 0).permute(0, 2, 1, 3)  # [B, H, T, S]
    keep = tatt._keep_mask(seed, b, h, t, s, rate, q.device)
    allowed = tatt._allowed(mask, t, s, causal, None).expand(b, h, t, s)
    assert torch.equal(kept[allowed], keep[allowed])
    assert not kept[~allowed].any()
    assert 0.3 < float(keep[allowed].float().mean()) < 0.7  # the mask is not trivial


@pytest.mark.parametrize("causal", [False, True])
def test_identity_v_through_jax_flash_gives_the_same_zeros(causal):
    """The JAX flash forward (Pallas ``_fwd_kernel`` / ``_fwd_tri_kernel``
    in interpret mode) drops the same positions as the port's plain version,
    so the mask the card check reads is the reference's."""
    q, k, v, mask = identity_case(torch.float32, seed=4)
    rate, seed = 0.5, -20240611
    want = tatt.reference_attention_bthd(q, k, v, mask, None, causal, rate, seed)
    qj, kj, vj = (jnp.asarray(x.numpy()).transpose(0, 2, 1, 3) for x in (q, k, v))
    got = np.asarray(jatt.flash_attention(qj, kj, vj, jnp.asarray(mask.numpy()), causal,
                                          None, rate, seed)).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got == 0, want.numpy() == 0)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)
