#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``aat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile ``aat_tpu_torch/csrc/*.cu`` for sm_90a (nvcc, ctypes);
  3. mel kernel vs its plain PyTorch version at the serving path's shape
     (frames of 8 x 12 s of speech-like audio): max abs error <= 1e-4;
  4. flash forward kernel vs its plain version at [1,999,16,64] and
     [2,1499,16,64] with a padded key tail and a fully masked row, f32
     (<= 1e-4) and bf16 (<= 2e-2); the masked row must be exactly 0;
  5. adaptive serving at full width (hubert-large + linear projection +
     SmolLM-135M, random weights from a seed): 6 utterances of 2-12 s,
     4 slots, 32 new tokens, chunks of 8; segment tables of the kernel and
     plain mel routes must be equal;
  6. whole-utterance serving: 12 s and 20 s utterances, one segment each,
     so HuBERT runs at T = 999 through the flash kernel; the encoder output
     must agree with the plain attention route within 1e-3 * max|ref|.
Launch counters are reset just before the two serving runs and read just
after; each kernel must have launched there. Then a JSON line of kernel
results, and last ``{"ok": true, "device": {...}}``.

There is no CPU route: without a CUDA device, or outside the repository,
the script exits non-zero and prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

MEL_TOL = 1e-4
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ENCODER_REL_TOL = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def speechlike_waveform(rng, duration_s, sampling_rate=16000):
    """Bursts of band-limited noise separated by near-silence (the test
    corpus generator of tests/conftest.py:make_speechlike_waveform)."""
    n = int(duration_s * sampling_rate)
    t = np.arange(n) / sampling_rate
    envelope = np.zeros(n)
    pos = 0
    while pos < n:
        burst = int(rng.uniform(0.15, 0.6) * sampling_rate)
        gap = int(rng.uniform(0.05, 0.3) * sampling_rate)
        envelope[pos : pos + burst] = np.hanning(max(burst, 2))[: max(n - pos, 0)][:burst]
        pos += burst + gap
    carrier = rng.normal(0, 1.0, n) * 0.5 + 0.3 * np.sin(2 * np.pi * 220 * t)
    return (envelope * carrier + rng.normal(0, 1e-4, n)).astype(np.float32)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def padded_batch(torch, waves, device):
    from aat_tpu_torch.serving.serve import padded_length

    pad_to = padded_length(waves)
    x = np.zeros((len(waves), pad_to), np.float32)
    for i, w in enumerate(waves):
        x[i, : w.size] = w
    lengths = np.array([w.size for w in waves], np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(lengths).to(device)


def phase_mel(torch, device, rng):
    from aat_tpu_torch.ops import mel

    waves = [speechlike_waveform(rng, 12.0) for _ in range(8)]
    x, lengths = padded_batch(torch, waves, device)
    x = (x - x.mean(-1, keepdim=True)) / (x.std(-1, keepdim=True) + 1e-6)
    frames = mel.frame_waveform_ragged(x, lengths).contiguous()  # [8, 1201, 400]
    got = mel.melspec_kernel(frames)
    ref = mel.melspec_frames_reference(frames)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    # both f32 routes against the same arithmetic in f64 on the same f32
    # constants: the kernel is checked on its own, not only against the
    # plain version (the two may round identically)
    basis, filters = (torch.from_numpy(c).to(device, torch.float64)
                      for c in mel._dft_mel_constants(400, 64, 16000, 8000.0))
    spec = frames.double() @ basis
    exact = torch.log10(torch.clamp_min(
        (spec[..., :201] ** 2 + spec[..., 201:] ** 2) @ filters, mel.MEL_FLOOR))
    err64 = float((got.double() - exact).abs().max())
    plain_err64 = float((ref.double() - exact).abs().max())
    n_diff = int((got != ref).sum())
    ms = cuda_ms(torch, lambda: mel.melspec_kernel(frames))
    plain_ms = cuda_ms(torch, lambda: mel.melspec_frames_reference(frames))
    print(f"mel: frames {tuple(frames.shape)} max_abs_err {err:.3e} (bound {MEL_TOL}), "
          f"{n_diff} of {got.numel()} values differ; vs f64: kernel {err64:.3e} "
          f"plain {plain_err64:.3e}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
    check(err64 <= MEL_TOL, f"mel kernel differs from the f64 computation by {err64}")
    check(bool(torch.isfinite(got).all()), "mel kernel output not finite")
    check(err <= MEL_TOL, f"mel kernel differs from its plain version by {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_flash(torch, device, rng):
    from aat_tpu_torch.ops import attention as att

    main = None
    cases = [((1, 999, 16, 16, 64), "tail"), ((2, 1499, 16, 16, 64), "tail+dead"),
             ((1, 300, 8, 2, 128), "tail")]  # the last: GQA and D=128
    for (b, t, h, kvh, d), masking in cases:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q = torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(np.float32))
            k = torch.from_numpy(rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32))
            v = torch.from_numpy(rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32))
            q, k, v = (z.to(device=device, dtype=dtype) for z in (q, k, v))
            mask = torch.ones((b, t), dtype=torch.int32, device=device)
            mask[:, t - t // 10:] = 0
            if "dead" in masking:
                mask[b - 1] = 0
            scale = d ** -0.5
            got = att.flash_forward_kernel(q, k, v, mask, scale)
            ref = att.reference_attention_bthd(q, k, v, mask, scale)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            ms = cuda_ms(torch, lambda: att.flash_forward_kernel(q, k, v, mask, scale))
            plain_ms = cuda_ms(torch, lambda: att.reference_attention_bthd(q, k, v, mask, scale))
            dead_ok = True
            if "dead" in masking:
                dead_ok = bool((got[b - 1] == 0).all())
            print(f"flash: [{b},{t},{h}/{kvh},{d}] {dtype_name} max_abs_err {err:.3e} "
                  f"(bound {FLASH_TOL[dtype_name]}) masked_row_zero {dead_ok} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
            check(bool(torch.isfinite(got.float()).all()), "flash output not finite")
            check(err <= FLASH_TOL[dtype_name], f"flash kernel differs by {err}")
            check(dead_ok, "fully masked row is not exactly zero")
            if (b, t, h, d, dtype_name) == (1, 999, 16, 64, "float32"):
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return main


def flagship_model(torch, device, seed=0):
    from aat_tpu_torch.models import aslm, hubert, llama

    audio_cfg = hubert.hubert_large_config()
    lm_cfg = llama.smollm_135m_config()
    model = aslm.AslmModel(
        aslm.AslmConfig(projection_type="linear", audio_encoder_embeddings_seq_len=1,
                        audio_encoder_hidden=audio_cfg.hidden_size,
                        lm_hidden=lm_cfg.hidden_size),
        audio_cfg, lm_cfg)
    return model, model.init_params(seed, device=device)


def phase_segment_tables(torch, device, waves, serve_cfg):
    """Segment tables of the mel kernel route equal those of the plain
    route, on the adaptive requests as the serving path pads them."""
    from aat_tpu_torch.ops import mel, segmentation

    x, lengths = padded_batch(torch, waves, device)
    valid = torch.arange(x.shape[-1], device=device)[None, :] < lengths[:, None]
    n = lengths.to(torch.float32)[:, None]
    mean = torch.where(valid, x, 0.0).sum(-1, keepdim=True) / n
    var = torch.where(valid, (x - mean) ** 2, 0.0).sum(-1, keepdim=True) / n
    norm = torch.where(valid, (x - mean) / (torch.sqrt(var) + 1e-6), 0.0)
    cfg = segmentation.TokenizerConfig(
        max_segments=serve_cfg.max_segments,
        max_segment_duration_milliseconds=serve_cfg.max_segment_frames * 1000 // 16000)
    kernel_route = segmentation.segment_waveforms(norm, lengths, cfg)
    plain_mel = mel.melspec_frames_reference(
        mel.frame_waveform_ragged(norm, lengths)).transpose(-1, -2)
    plain_route = segmentation.segment_table_from_melspec(plain_mel, lengths, cfg)
    for key in ("starts", "ends", "out_lens", "segment_mask", "num_segments"):
        check(torch.equal(kernel_route[key], plain_route[key]),
              f"segment table '{key}' differs between kernel and plain mel routes")
    return [int(s) for s in kernel_route["num_segments"].cpu()]


def phase_encoder_routes(torch, model, params, wave, pad_to):
    """Whole-utterance encoder output, flash kernel route vs plain route."""
    from aat_tpu_torch.data.ondevice import segment_raw_batch
    from aat_tpu_torch.models.aslm import AslmModel

    device = params["lm_decoder"]["embed_tokens"]["embedding"].device
    x = np.zeros((1, pad_to), np.float32)
    x[0, : wave.size] = wave
    batch = segment_raw_batch(
        {"raw_waveforms": torch.from_numpy(x).to(device),
         "raw_lengths": torch.tensor([wave.size], device=device)},
        segmentation="uniform", max_segments=1, max_segment_frames=pad_to,
        sampling_rate=16000)
    seg = batch["batched_segments"][0]
    wmask = batch["segments_waveforms_mask"][0]
    plain_model = AslmModel(
        model.config, dataclasses.replace(model.audio_encoder_config, attention_impl="xla"),
        model.lm_config)
    with torch.no_grad():
        got, fmask = model.encode_audio(params, seg, wmask)
        ref, _ = plain_model.encode_audio(params, seg, wmask)
    torch.cuda.synchronize()
    valid = fmask[..., None]
    err = float(((got - ref).abs() * valid).max())
    scale = float((ref.abs() * valid).max())
    print(f"encoder: whole utterance T={got.shape[1]} (valid {int(fmask.sum())}) "
          f"kernel vs plain max_abs_err {err:.3e} max|ref| {scale:.3e}", flush=True)
    check(bool(torch.isfinite(got).all()), "encoder output not finite")
    check(err <= ENCODER_REL_TOL * scale, f"encoder routes differ by {err} (max|ref| {scale})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU route here", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from aat_tpu_torch.ops import attention as att
        from aat_tpu_torch.ops import mel
        from aat_tpu_torch.runtime import kernels
        from aat_tpu_torch.serving import serve
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable from {REPO}: {exc}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    start = time.perf_counter()
    lib = kernels.library()
    with open(os.path.join(os.path.dirname(lib.path), "nvcc.log"), "w") as f:
        f.write(lib.build_log)  # nvcc and ptxas -v output, beside the library
    usage = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - start:.1f} s (nvcc {lib.build_seconds:.1f} s) "
          f"{os.path.relpath(lib.path, REPO)}; ptxas: {' | '.join(usage)}", flush=True)

    rng = np.random.default_rng(0)
    # 3-4. kernels vs their plain versions
    mel_result = phase_mel(torch, device, rng)
    flash_result = phase_flash(torch, device, rng)

    # 5-6. serving at full width
    start = time.perf_counter()
    model, params = flagship_model(torch, device)
    torch.cuda.synchronize()
    print(f"model: hubert-large + linear projection + SmolLM-135M, random weights "
          f"(seed 0), init {time.perf_counter() - start:.1f} s", flush=True)
    adaptive_waves = [speechlike_waveform(rng, d) for d in (2.0, 4.5, 12.0, 7.0, 3.2, 9.5)]
    whole_waves = [speechlike_waveform(rng, d) for d in (12.0, 20.0)]
    adaptive_cfg = serve.ServeConfig(segmentation="adaptive", max_slots=4, max_new_tokens=32,
                                     chunk=8, max_segments=64, max_segment_frames=4000)
    whole_cfg = dataclasses.replace(adaptive_cfg, segmentation="whole")
    n_segments = phase_segment_tables(torch, device, adaptive_waves, adaptive_cfg)

    mel.melspec_kernel.launches = 0
    att.flash_forward_kernel.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    adaptive_ids = serve.serve(model, params, adaptive_waves, adaptive_cfg)
    torch.cuda.synchronize()
    adaptive_s = time.perf_counter() - start
    mel_after_adaptive = mel.melspec_kernel.launches
    start = time.perf_counter()
    whole_ids = serve.serve(model, params, whole_waves, whole_cfg)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - start
    launches = {"mel": mel.melspec_kernel.launches,
                "flash_fwd": att.flash_forward_kernel.launches}

    vocab = model.lm_config.vocab_size
    print(f"serve adaptive: {len(adaptive_ids)} requests, segments {n_segments} "
          f"(total {sum(n_segments)}), wall {adaptive_s:.3f} s, mel launches "
          f"{mel_after_adaptive}, first ids {adaptive_ids[0][:8].tolist()}", flush=True)
    print(f"serve whole-utterance: {len(whole_ids)} requests, wall {whole_s:.3f} s, "
          f"flash launches {launches['flash_fwd']}, first ids {whole_ids[0][:8].tolist()}",
          flush=True)
    for ids in adaptive_ids + whole_ids:
        check(ids.shape == (adaptive_cfg.max_new_tokens,), f"ids shape {ids.shape}")
        check(bool((ids >= 0).all() and (ids < vocab).all()), "token id out of range")
    check(len(adaptive_ids) == 6 and len(whole_ids) == 2, "not every request finished")
    check(mel_after_adaptive > 0, "adaptive serving never launched the mel kernel")
    check(launches["flash_fwd"] > 0, "whole-utterance serving never launched the flash kernel")

    phase_encoder_routes(torch, model, params, whole_waves[0],
                         serve.padded_length(whole_waves))

    kernels_line = {"kernels": [
        {"name": "mel", "route": "cuda", "source": "aat_tpu_torch/csrc/mel.cu",
         "replaces": "aat_tpu/ops/mel_pallas.py:36", "launches": launches["mel"],
         **mel_result},
        {"name": "flash_fwd", "route": "cuda", "source": "aat_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "aat_tpu/ops/attention.py:186", "launches": launches["flash_fwd"],
         **flash_result},
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
