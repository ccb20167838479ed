"""``tokenizer.tokenize_dense`` against JAX's (chunked and flat, every
table leaf and the dense segment batch bitwise; ``tests/test_ragged.py:92``
on the port), ``utils/timing.profile_trace`` (a Chrome trace written into
``logdir``), and ``utils/flops`` equal to JAX's on the flagship configs,
with the H100's peak in ``mfu``."""

import json
import os

import numpy as np
import pytest
import torch

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.ops import mel as jmel
from aat_tpu.ops.segmentation import TokenizerConfig as JTokCfg
from aat_tpu.tokenizer import tokenize_dense as jtokenize_dense
from aat_tpu.utils import flops as jflops
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.ops.segmentation import TokenizerConfig as TTokCfg
from aat_tpu_torch.tokenizer import tokenize_dense
from aat_tpu_torch.utils import flops as tflops
from aat_tpu_torch.utils.timing import profile_trace
from tests.conftest import make_speechlike_waveform

TABLE_KEYS = ("starts", "ends", "out_lens", "segment_mask", "num_segments")


def batch(b=6, seconds=2.0):
    waveforms = np.stack([
        jmel.normalize_waveform(make_speechlike_waveform(np.random.default_rng(i), seconds))
        for i in range(b)]).astype(np.float32)
    lengths = np.full((b,), waveforms.shape[1], np.int32)
    lengths[1] -= 7000  # a padded row
    waveforms[1, lengths[1]:] = 0.0
    return waveforms, lengths


@pytest.mark.parametrize("batch_chunk", [2, 4, 6])
def test_tokenize_dense_equals_jax_chunked_and_flat(batch_chunk):
    waveforms, lengths = batch()
    kw = dict(max_segments=32, max_minima=64)
    want = jtokenize_dense(waveforms, lengths, JTokCfg(**kw), batch_chunk=batch_chunk)
    got = tokenize_dense(torch.from_numpy(waveforms), torch.from_numpy(lengths), TTokCfg(**kw),
                         batch_chunk=batch_chunk)
    flat = tokenize_dense(torch.from_numpy(waveforms), torch.from_numpy(lengths), TTokCfg(**kw),
                          batch_chunk=len(waveforms))
    (t_got, seg_got, fm_got), (t_want, seg_want, fm_want) = got, want
    chunked = batch_chunk < len(waveforms)
    assert ("melspec" in t_got) == ("melspec" in t_want) == (not chunked)
    assert seg_got.shape == (6, 32, TTokCfg().max_segment_frames) and fm_got.dtype == torch.bool
    np.testing.assert_array_equal(seg_got.numpy(), np.asarray(seg_want))
    np.testing.assert_array_equal(fm_got.numpy(), np.asarray(fm_want))
    for key in TABLE_KEYS:
        np.testing.assert_array_equal(t_got[key].numpy(), np.asarray(t_want[key]), err_msg=key)
        assert torch.equal(t_got[key], flat[0][key]), key
    assert torch.equal(seg_got, flat[1]) and torch.equal(fm_got, flat[2])
    assert int(t_got["num_segments"].min()) > 1


def test_tokenize_dense_segments_hold_the_waveform():
    """Each valid segment row is its slice of the waveform, zero past its
    end; a padded slot is all zero."""
    waveforms, lengths = batch(b=3, seconds=1.5)
    table, segments, frame_mask = tokenize_dense(torch.from_numpy(waveforms),
                                                 torch.from_numpy(lengths), batch_chunk=2)
    for b in range(3):
        n = int(table["num_segments"][b])
        for s in range(n):
            start, end = int(table["starts"][b, s]), int(table["ends"][b, s])
            np.testing.assert_array_equal(segments[b, s, : end - start].numpy(),
                                          waveforms[b, start:end])
            assert float(segments[b, s, end - start:].abs().sum()) == 0.0
        assert float(segments[b, n:].abs().sum()) == 0.0 and not bool(frame_mask[b, n:].any())


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def flagship():
    """(JAX, port) pairs of the flagship configs: hubert-large with
    SmolLM-135M and with Qwen-1.5-1.8B, linear projection."""
    out = []
    for jlm, tlm in ((jllm.smollm_135m_config(), tllm.smollm_135m_config()),
                     (jllm.qwen15_18b_config(), tllm.qwen15_18b_config())):
        out.append(((jhub.hubert_large_config(), jlm,
                     jaslm.AslmConfig(lm_hidden=jlm.hidden_size)),
                    (thub.hubert_large_config(), tlm,
                     taslm.AslmConfig(lm_hidden=tlm.hidden_size))))
    return out


@pytest.mark.parametrize("lm", [0, 1], ids=["smollm", "qwen"])
def test_flops_equal_jax_on_flagship_configs(lm):
    (jenc, jlm, jcfg), (tenc, tlm, tcfg) = flagship()[lm]
    for frames in (24000, 192000, 2720000):
        assert tflops.conv_extractor_frames(tenc, frames) == jflops.conv_extractor_frames(
            jenc, frames)
        assert tflops.hubert_forward_flops(tenc, 2, frames) == jflops.hubert_forward_flops(
            jenc, 2, frames)
    assert tflops.llama_forward_flops(tlm, 2, 700) == jflops.llama_forward_flops(jlm, 2, 700)
    assert tflops.projection_flops(tcfg, 4, 499) == jflops.projection_flops(jcfg, 4, 499)
    for n_segments, frames in ((None, 320000), (12, 24000)):
        for flags in ((True, False), (False, True), (False, False)):
            want = jflops.aslm_train_step_flops(jenc, jlm, jcfg, 2, n_segments, frames, 40, *flags)
            got = tflops.aslm_train_step_flops(tenc, tlm, tcfg, 2, n_segments, frames, 40, *flags)
            assert got == want
    total = want["total"]
    assert tflops.mfu(total, 0.5) == jflops.mfu(total, 0.5, peak=989e12) == total / 0.5 / 989e12
    assert tflops.H100_BF16_PEAK == 989e12


def test_flops_equal_jax_on_the_pooling_projection():
    """The transformer_encoder projection's count (the default
    ``PoolingConfig``: the port's ``AslmConfig`` carries it now) on
    hubert-large and SmolLM-135M, segmented as phase 16a runs it."""
    jcfg = jaslm.AslmConfig(projection_type="transformer_encoder", lm_hidden=576)
    tcfg = taslm.AslmConfig(projection_type="transformer_encoder", lm_hidden=576)
    assert tflops.projection_flops(tcfg, 128, 12) == jflops.projection_flops(jcfg, 128, 12)
    for flags in ((True, False), (False, False)):
        want = jflops.aslm_train_step_flops(jhub.hubert_large_config(), jllm.smollm_135m_config(),
                                            jcfg, 2, 64, 4000, 48, *flags)
        got = tflops.aslm_train_step_flops(thub.hubert_large_config(), tllm.smollm_135m_config(),
                                           tcfg, 2, 64, 4000, 48, *flags)
        assert got == want and got["projection_fwd"] > 0
