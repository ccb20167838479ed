"""The flash backward's two kernel pairs, both on the tensor cores: bf16
operands go to ``aat_flash_bwd_dq_mma`` and ``aat_flash_bwd_dkv_mma``
(``csrc/flash_bwd_mma.cu``), f32 operands to the 3xTF32 kernels
``aat_flash_bwd_dq_tf32x3`` and ``aat_flash_bwd_dkv_tf32x3``
(``csrc/flash_bwd_tf32x3.cu``), on the S <= 8192 route
and on the split route, behind one wrapper and counter per TPU kernel.

The dispatch runs on the meta device with a library that records the C
entries it is asked for. The two keep-mask identity constructions that
``chip_smoke.py`` reads the kernels' dropout masks with are pinned on the
plain backward and on the JAX package's ``_flash_backward`` (Pallas in
interpret mode):
- dk/dv: T = D and dout[q] = e_q, so dv[k, d] = p_v[d, k];
- dq: S = D, k[j] = v[j] = e_j and out = 0 (so delta = 0), so dq[q, d] =
  sm_scale·round(p·keep·dout/(1 - rate))[q, d].
Either way a gradient is zero exactly where the keep mask dropped a key.

Last, the model builder's device: ``cuda:0`` unless the caller passes
another, and without a GPU it raises before it draws a weight."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training.config import TrainingConfig
from test_torch_flash_fwd_mma import meta_library  # noqa: F401  (the fixture)

ENTRIES = {torch.bfloat16: ["aat_flash_bwd_dq_mma", "aat_flash_bwd_dkv_mma"],
           torch.float32: ["aat_flash_bwd_dq_tf32x3", "aat_flash_bwd_dkv_tf32x3"]}


def meta_backward_operands(dtype, s, h=4, kvh=2, d=64):
    """q/out/dout [1, S, H, D], k/v [1, S, KVH, D], mask [1, S], lse
    [1, H, S] on the meta device (shapes without data)."""
    q, out, dout = (torch.empty((1, s, h, d), dtype=dtype, device="meta") for _ in range(3))
    k, v = (torch.empty((1, s, kvh, d), dtype=dtype, device="meta") for _ in range(2))
    mask = torch.ones((1, s), dtype=torch.int32, device="meta")
    lse = torch.empty((1, h, s), dtype=torch.float32, device="meta")
    return q, k, v, mask, out, lse, dout


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [300, tatt.FUSED_BWD_MAX_S + 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_dispatch_by_dtype(meta_library, dtype, s, causal):
    """One launch of each entry of the operands' dtype, on both routes,
    counted on the wrappers of the TPU kernels they replace."""
    if s > tatt.FUSED_BWD_MAX_S:
        wrappers = [tatt.flash_backward_dq_long, tatt.flash_backward_dkv_long]
    else:
        wrappers = [tatt.flash_backward_causal_kernel if causal else tatt.flash_backward_kernel]
    before = [w.launches for w in wrappers]
    q, k, v, mask, out, lse, dout = meta_backward_operands(dtype, s)
    dq, dk, dv = tatt.flash_backward(q, k, v, mask, out, lse, dout, 64 ** -0.5, causal, 0.1, 7,
                                     None)
    assert meta_library.names == ENTRIES[dtype]
    assert [w.launches for w in wrappers] == [n + 1 for n in before]
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == dtype


@pytest.mark.parametrize("operand", ["out", "dout"])
def test_bf16_backward_refuses_unaligned_out_and_dout(meta_library, operand):
    """The tensor-core backward copies out and dout rows in 16-byte chunks:
    a bf16 one that starts 3 elements (6 bytes) into its buffer is refused,
    with no fallback to another kernel."""
    q, k, v, mask, out, lse, dout = meta_backward_operands(torch.bfloat16, 300)
    operands = {"out": out, "dout": dout}
    x = operands[operand]
    operands[operand] = torch.empty(x.numel() + 8, dtype=torch.bfloat16,
                                    device="meta")[3:3 + x.numel()].view(x.shape)
    with pytest.raises(ValueError, match=f"bf16 {operand} must start on a 16-byte boundary"):
        tatt.flash_backward(q, k, v, mask, operands["out"], lse, operands["dout"], 0.125,
                            False, 0.0, 0, None)
    assert meta_library.names == []


def test_f32_backward_takes_any_start(meta_library):
    """The 3xTF32 kernels read out with 4-byte loads (only delta =
    rowsum(dout·out) reads it), so an f32 out may start anywhere."""
    q, k, v, mask, out, lse, dout = meta_backward_operands(torch.float32, 300)
    out = torch.empty(out.numel() + 8, device="meta")[3:3 + out.numel()].view(out.shape)
    tatt.flash_backward(q, k, v, mask, out, lse, dout, 0.125, True, 0.0, 0, None)
    assert meta_library.names == ENTRIES[torch.float32]


def identity_case(kernel, b=2, h=2, d=16, n=24, seed=11):
    """q, k, v, dout [B, rows, H, D] as numpy: for the dk/dv kernel T = D
    queries against ``n`` keys with dout the identity; for the dq kernel
    ``n`` queries against S = D keys with k = v the identity."""
    rng = np.random.default_rng(seed)
    eye = np.broadcast_to(np.eye(d, dtype=np.float32)[None, :, None, :], (b, d, h, d)).copy()

    def gauss(rows):
        return rng.normal(0, 1, (b, rows, h, d)).astype(np.float32)

    if kernel == "dkv":
        return gauss(d), gauss(n), gauss(n), eye
    return gauss(n), eye, eye, gauss(n)


def keep_mask_reading(kernel, dq, dv):
    """[B, H, T, S] bool: where the identity construction's gradient is
    nonzero (dv [B, S, H, T] for dk/dv, dq [B, T, H, S] for dq)."""
    return (dv.permute(0, 2, 3, 1) if kernel == "dkv" else dq.permute(0, 2, 1, 3)) != 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_reveals_the_backward_keep_mask(dtype, kernel, causal):
    """On the allowed positions the plain backward's zeros are exactly the
    dropped keys of ``_keep_mask``; the other positions are zero."""
    q, k, v, dout = (torch.from_numpy(x).to(dtype) for x in identity_case(kernel))
    b, t, h, d = q.shape
    s = k.shape[1]
    rate, seed = 0.5, 97531
    mask = torch.ones((b, s), dtype=torch.int32)
    out, lse = tatt.flash_forward_reference(q, k, v, mask, d ** -0.5, causal, rate, seed)
    if kernel == "dq":
        out = torch.zeros_like(out)
    dq, _, dv = tatt.flash_backward_reference(q, k, v, mask, out, lse, dout, d ** -0.5, causal,
                                              rate, seed)
    kept = keep_mask_reading(kernel, dq, dv)
    keep = tatt._keep_mask(seed, b, h, t, s, rate, q.device)
    allowed = tatt._allowed(mask, t, s, causal, None).expand(b, h, t, s)
    assert torch.equal(kept[allowed], keep[allowed])
    assert not kept[~allowed].any()
    assert 0.3 < float(keep[allowed].float().mean()) < 0.7  # the mask is not trivial


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_identity_through_jax_backward_gives_the_same_zeros(kernel, causal, fused):
    """The JAX backward (Pallas ``_bwd_fused_kernel`` / ``_bwd_fused_tri_kernel``,
    or with ``fused=False`` the split ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``, in interpret mode) zeroes the same positions of the
    same construction as the port's plain backward, so the mask the card
    checks read is the reference's."""
    q, k, v, dout = identity_case(kernel, seed=12)
    b, t, h, d = q.shape
    s = k.shape[1]
    rate, seed, scale = 0.5, -20240611, d ** -0.5
    mask = np.ones((b, s), np.int32)
    qt, kt, vt, dt = (torch.from_numpy(x) for x in (q, k, v, dout))
    maskt = torch.from_numpy(mask)
    out, lse = tatt.flash_forward_reference(qt, kt, vt, maskt, scale, causal, rate, seed)
    if kernel == "dq":
        out = torch.zeros_like(out)
    want_dq, _, want_dv = tatt.flash_backward_reference(qt, kt, vt, maskt, out, lse, dt, scale,
                                                        causal, rate, seed)
    qj, kj, vj, dj = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v, dout))
    maskj = jnp.asarray(mask)
    out_j, lse_j, _ = jatt._flash_forward(qj, kj, vj, maskj, causal, scale, dropout_rate=rate,
                                          dropout_seed=jnp.int32(seed))
    if kernel == "dq":
        out_j = jnp.zeros_like(out_j)
    dq_j, _, dv_j = jatt._flash_backward(qj, kj, vj, maskj, out_j, lse_j, causal, scale, dj,
                                         dropout_rate=rate, dropout_seed=jnp.int32(seed),
                                         fused=fused)
    got_dq, got_dv = (torch.from_numpy(np.asarray(x).transpose(0, 2, 1, 3).copy())
                      for x in (dq_j, dv_j))
    got = keep_mask_reading(kernel, got_dq, got_dv)
    want = keep_mask_reading(kernel, want_dq, want_dv)
    assert torch.equal(got, want)
    assert got.any() and not got.all()
    read, ref = (got_dv, want_dv) if kernel == "dkv" else (got_dq, want_dq)
    np.testing.assert_allclose(read.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.fixture
def tiny_models(monkeypatch):
    """The full-size configs swapped for tiny ones, and a record of the
    weight draws."""
    draws = []
    init_hubert, init_llama = thub.init_hubert_params, tllm.init_llama_params
    monkeypatch.setattr(thub, "hubert_large_config", thub.tiny_test_config)
    monkeypatch.setattr(tllm, "smollm_135m_config", tllm.tiny_test_config)
    monkeypatch.setattr(thub, "init_hubert_params",
                        lambda *a: draws.append("encoder") or init_hubert(*a))
    monkeypatch.setattr(tllm, "init_llama_params",
                        lambda *a: draws.append("decoder") or init_llama(*a))
    return draws


BUILDERS = {"build_model": lambda **kw: tbuild.build_model(TrainingConfig(), **kw),
            "build_audio_encoder": lambda **kw: tbuild.build_audio_encoder(TrainingConfig(), **kw),
            "build_lm_decoder": lambda **kw: tbuild.build_lm_decoder(TrainingConfig(), **kw)}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builders_default_to_the_card_and_raise_without_one(monkeypatch, tiny_models, builder):
    """With no device the builders take ``cuda:0``; without a GPU that
    raises, naming the CPU route, before any weight is drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BUILDERS[builder](pretrained=False)
    assert tiny_models == []


def test_builder_refusals_come_before_the_device(monkeypatch, tiny_models):
    """Pretrained weights named by a hub name with no local directory are
    refused as such (``FileNotFoundError``), on a machine without a GPU too:
    the directory is checked before the device is resolved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FileNotFoundError, match="local checkpoint directory"):
        tbuild.build_model(TrainingConfig(), pretrained=True)
    assert tiny_models == []


def test_build_model_on_the_cpu_when_asked(tiny_models):
    model, params = tbuild.build_model(TrainingConfig(), pretrained=False, device="cpu")
    leaves = [params["audio_encoder"]["feature_projection"]["projection"]["kernel"],
              params["lm_decoder"]["embed_tokens"]["embedding"],
              params["adapter"]["projection"]["in"]["kernel"]]
    assert all(x.device.type == "cpu" for x in leaves)
    assert tiny_models == ["encoder", "decoder"]
    assert model.lm_config.hidden_size == tllm.tiny_test_config().hidden_size
