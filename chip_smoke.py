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
  7. the training kernels vs their plain versions at the training path's
     shapes, f32 and bf16: dense [2,999,16,64] with dropout 0.1 (HuBERT),
     causal GQA [2,1050,9/3,64] with a padded key tail (SmolLM), a dense
     case with a fully masked batch row (exact zeros forward, zero
     gradients backward), causal D=128 GQA with pack_len; forward (out,
     lse) within 1e-4 (f32) / 2e-2 (bf16; out: of max(1, max|ref|)),
     gradients within 1e-3 (f32) / 3e-2 (bf16) of max|ref| (sums in
     another order; bf16 rounds p and ds);
  8. training at full width: ``projection_training_config()`` (bf16
     compute over f32 masters, hubert-large train-mode dropout and
     LayerDrop, frozen LM, fused guarded AdamW), 3 optimizer steps of 2
     microbatches of 2 utterances (8-20 s, captions of 32-48 tokens):
     finite losses, the frozen LM bitwise unchanged, trained weights
     moved; then one f32 gradient step through the kernel route and the
     plain route with the same seeds: loss and global grad norm within
     1e-3 relative, feature_projection grads within 1e-3 * max|ref|; one
     more step under ``torch.profiler`` gives the device's busy time and
     idle share, with device time by kernel written beside the build log
     (``aat_tpu_torch/build/train_profile.txt``).
  9. the offline discrete-token pipeline at full width: 8 speech-like
     utterances of 4-20 s through ``scripts.segment_embeddings`` (host
     tokenizer, hubert-large eval with seeded random weights) →
     ``scripts.mean_segment_embeddings`` → ``scripts.quantize_embeddings``
     in a temporary directory, twice: 1024 codes (N < 1024, so the
     codebook carries padded duplicate codes and k-means has nothing to
     move) and 64 codes (N > 64: the codes move), 10 EMA iterations each;
     ids below K, and the written ids equal to a plain-route rerun of the
     assignment where
     the best-to-second gap exceeds 1e-4 * max(1, |best|) (near-ties may
     resolve either way: the kernel and cuBLAS sum x.c in other orders),
     with the chosen distance within that margin on every row;
 10. the vq kernel vs its plain version at corpus scale, N = 262,144
     seeded Gaussian-mixture rows of D = 1024 against K = 1024 and the
     overhanging K = 1000, with exact duplicate codes (which must go to the
     lowest id) and the same near-tie rule; then 10 iterations of the
     quantize loop at that size, after one that warms it up;
 11. the long-form path's kernels vs their plain versions at its shapes
     (key length > 8192): HuBERT's dense [1,8499,16,64] with dropout 0.1
     and Qwen's causal [1,8540,16,128], padded key tails, f32 and bf16 at
     phase 7's tolerances; the forward (out, lse) and the split backward's
     dq and dk/dv kernels. The plain versions run 4 heads at a time, so
     their [B, H, T, S] f32 tensors stay near 1.2 GB (a batch of one, so a
     head's dropout mask is keyed on seed + head·GOLDEN, and a chunk
     starting at head h0 takes the seed shifted by h0·GOLDEN); then 2
     optimizer steps of ``projection_training_config()``
     with the Qwen-1.5-1.8B LM at full width (random weights through
     ``models.build.build_model``), one utterance of 170 s and one of
     180 s (HuBERT T = 8499 and 8999): finite losses, the frozen Qwen
     bitwise unchanged, the encoder moved, the split kernels launched and
     the S <= 8192 backward kernels not; then one more step under
     ``torch.profiler`` (``aat_tpu_torch/build/longform_profile.txt``).
Launch counters are reset just before each main path (the two serving
runs, the 3 training steps, the pipeline, the 2 long-form steps) and read
just after; each kernel of the path must have launched there. Then a JSON
line of kernel results, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

There is no CPU route: without a CUDA device, or outside the repository,
the script exits non-zero and prints no result.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# shapes of phases 9-11
PIPELINE_SECONDS = (4.0, 6.5, 9.0, 11.5, 14.0, 16.5, 18.0, 20.0)
VQ_CORPUS = (262144, 1024, (1024, 1000))  # N, D, codebook sizes
# (B, T, H, D), causal, dropout: HuBERT's and Qwen's attention in phase 11
SPLIT_CASES = (((1, 8499, 16, 64), False, (0.1, 24680)),
               ((1, 8540, 16, 128), True, (0.0, 0)))
PLAIN_HEADS = 4  # heads per call of a plain version in phase 11
LONGFORM_SECONDS = (170.0, 180.0)

MEL_TOL = 1e-4
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_REL_TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # of max|ref|
ENCODER_REL_TOL = 1e-3
TRAIN_REL_TOL = 1e-3


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


def phase_flash_train(torch, device, rng):
    """Forward (out, lse) and backward kernels vs their plain versions at
    the training path's shapes. Returns the f32 results of the main cases
    for the kernels line."""
    from aat_tpu_torch.ops import attention as att

    # (B, T, H, KVH, D), causal, masking, dropout (rate, seed), pack_len
    cases = [((2, 999, 16, 16, 64), False, "tail", (0.1, 1234567), None),
             ((2, 1050, 9, 3, 64), True, "tail", None, None),
             ((2, 300, 16, 16, 64), False, "dead", (0.1, -42), None),
             ((1, 600, 8, 2, 128), True, "tail", None, 300)]
    results = {}
    for (b, t, h, kvh, d), causal, masking, dropout, pack_len in cases:
        rate, seed = dropout or (0.0, 0)
        fwd = att.flash_forward_causal_kernel if causal else att.flash_forward_kernel
        bwd = att.flash_backward_causal_kernel if causal else att.flash_backward_kernel
        fkw = dict(dropout_rate=rate, dropout_seed=seed, need_lse=True)
        bkw = dict(dropout_rate=rate, dropout_seed=seed)
        if causal:
            fkw["pack_len"] = bkw["pack_len"] = pack_len
        pkw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed, pack_len=pack_len)
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, g = (torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(np.float32))
                    .to(device=device, dtype=dtype) for _ in range(2))
            k, v = (torch.from_numpy(rng.normal(0, 1, (b, t, kvh, d)).astype(np.float32))
                    .to(device=device, dtype=dtype) for _ in range(2))
            mask = torch.ones((b, t), dtype=torch.int32, device=device)
            mask[:, t - t // 10:] = 0
            if masking == "dead":
                mask[b - 1] = 0
            scale = d ** -0.5
            out, lse = fwd(q, k, v, mask, scale, **fkw)
            ref_out, ref_lse = att.flash_forward_reference(q, k, v, mask, scale, **pkw)
            # both backward versions read the plain forward's out and lse
            grads = bwd(q, k, v, mask, ref_out, ref_lse, g, scale, **bkw)
            ref_grads = att.flash_backward_reference(q, k, v, mask, ref_out, ref_lse, g,
                                                     scale, **pkw)
            torch.cuda.synchronize()
            out_err = float((out.float() - ref_out.float()).abs().max())
            live = ref_lse > -1e29
            lse_err = float((lse - ref_lse)[live].abs().max())
            grad_errs = [float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())
                         for a, r in zip(grads, ref_grads)]
            fwd_ms = cuda_ms(torch, lambda: fwd(q, k, v, mask, scale, **fkw), iters=10)
            fwd_plain_ms = cuda_ms(torch, lambda: att.flash_forward_reference(
                q, k, v, mask, scale, **pkw), iters=10)
            bwd_ms = cuda_ms(torch, lambda: bwd(q, k, v, mask, ref_out, ref_lse, g, scale,
                                                **bkw), iters=10)
            bwd_plain_ms = cuda_ms(torch, lambda: att.flash_backward_reference(
                q, k, v, mask, ref_out, ref_lse, g, scale, **pkw), iters=10)
            dead_ok = True
            if masking == "dead":
                dead_ok = (bool((out[b - 1] == 0).all()) and bool((lse[b - 1] == -1e30).all())
                           and all(bool((x[b - 1] == 0).all()) for x in grads))
            label = (f"{'causal' if causal else 'dense'} [{b},{t},{h}/{kvh},{d}] {dtype_name}"
                     f"{f' dropout {rate}' if rate else ''}{f' pack {pack_len}' if pack_len else ''}")
            # the out bound scales with the output's size: a bf16 rounding flip
            # is an ulp, 2**-8 of the value, and causal rows near the top
            # average few keys, so |out| reaches 4
            out_bound = FLASH_TOL[dtype_name] * (
                max(1.0, float(ref_out.float().abs().max())) if dtype_name == "bfloat16" else 1.0)
            print(f"flash train: {label} out err {out_err:.3e} (bound {out_bound:.2e}) lse err "
                  f"{lse_err:.3e} (bound {FLASH_TOL[dtype_name]}); dq/dk/dv err/max|ref| "
                  f"{'/'.join(f'{e:.2e}' for e in grad_errs)} (bound {GRAD_REL_TOL[dtype_name]})"
                  f"{' masked_row_zero ' + str(dead_ok) if masking == 'dead' else ''}; "
                  f"fwd {fwd_ms:.4f} ms plain {fwd_plain_ms:.4f} ms, "
                  f"bwd {bwd_ms:.4f} ms plain {bwd_plain_ms:.4f} ms", flush=True)
            check(all(bool(torch.isfinite(x.float()).all()) for x in (out, *grads)),
                  f"flash train {label}: non-finite output or gradient")
            check(out_err <= out_bound and lse_err <= FLASH_TOL[dtype_name],
                  f"flash train {label}: forward differs by {out_err} (lse {lse_err})")
            check(max(grad_errs) <= GRAD_REL_TOL[dtype_name],
                  f"flash train {label}: gradients differ by {grad_errs} of max|ref|")
            check(dead_ok, f"flash train {label}: fully masked row not exactly zero")
            if dtype_name == "float32" and masking == "tail" and d == 64:
                name = "causal" if causal else "dense"
                results[f"fwd_{name}"] = {"max_abs_err": out_err, "ms": fwd_ms,
                                          "plain_ms": fwd_plain_ms}
                results[f"bwd_{name}"] = {
                    "max_abs_err": max(float((a.float() - r.float()).abs().max())
                                       for a, r in zip(grads, ref_grads)),
                    "ms": bwd_ms, "plain_ms": bwd_plain_ms}
    return results


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


TRAIN_KERNELS = ("flash_fwd", "flash_fwd_causal", "flash_bwd", "flash_bwd_causal")


def kernel_wrappers():
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.ops import mel, vq

    return {"mel": mel.melspec_kernel, "flash_fwd": att.flash_forward_kernel,
            "flash_fwd_causal": att.flash_forward_causal_kernel,
            "flash_bwd": att.flash_backward_kernel,
            "flash_bwd_causal": att.flash_backward_causal_kernel,
            "flash_bwd_dq_long": att.flash_backward_dq_long,
            "flash_bwd_dkv_long": att.flash_backward_dkv_long,
            "vq": vq.nearest_codebook_kernel}


def training_batches(torch, device, rng, n_steps, accum, per_batch=2):
    """Speech-like utterances of 8, 12, 16 and 20 s (normalized over their
    valid samples, padded to the longer of each pair) and random caption
    ids of 32-48 tokens, padded."""
    durations = [8.0, 12.0, 16.0, 20.0]
    steps = []
    for step in range(n_steps):
        micro = []
        for m in range(accum):
            waves = [speechlike_waveform(rng, durations[(step * accum * per_batch + m * per_batch + i)
                                                        % len(durations)])
                     for i in range(per_batch)]
            waves = [(w - w.mean()) / (w.std() + 1e-7) for w in waves]
            length = max(w.size for w in waves)
            x = np.zeros((per_batch, length), np.float32)
            wmask = np.zeros((per_batch, length), np.int32)
            cap_lens = rng.integers(32, 49, per_batch)
            ids = np.zeros((per_batch, int(cap_lens.max())), np.int64)
            cmask = np.zeros(ids.shape, np.int32)
            for i, (w, c) in enumerate(zip(waves, cap_lens)):
                x[i, : w.size], wmask[i, : w.size] = w, 1
                ids[i, :c], cmask[i, :c] = rng.integers(3, 49152, c), 1
            micro.append({k: torch.from_numpy(v).to(device) for k, v in (
                ("waveforms", x), ("waveforms_attention_mask", wmask), ("input_ids", ids),
                ("attention_mask", cmask), ("input_ids_attention_mask", cmask))})
        steps.append(micro)
    return steps


def phase_training(torch, model, params, rng):
    """3 optimizer steps at full width through the kernels, then one f32
    gradient step through the kernel and plain routes. Returns the launch
    counts of the 3 steps."""
    from aat_tpu_torch.models.aslm import AslmModel
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.config import projection_training_config
    from aat_tpu_torch.training.trainer import AATTrainer

    device = params["lm_decoder"]["embed_tokens"]["embedding"].device
    cfg = dataclasses.replace(projection_training_config(), per_device_train_batch_size=2,
                              gradient_accumulation_steps=2)
    trainer = AATTrainer(model, params, cfg)
    lm_before = [x.clone() for x in optim.tree_leaves(params["lm_decoder"])]
    watched = {"adapter/projection/in/kernel": params["adapter"]["projection"]["in"]["kernel"],
               "audio_encoder/feature_projection/projection/kernel":
                   params["audio_encoder"]["feature_projection"]["projection"]["kernel"]}
    before = {k: v.clone() for k, v in watched.items()}
    batches = training_batches(torch, device, rng, n_steps=3, accum=2)

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    losses, walls = [], []
    for micro in batches:
        start = time.perf_counter()
        metrics = trainer.training_step(micro)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        losses.append(metrics["train/loss"])
    launches = {name: w.launches for name, w in wrappers.items()}
    t_audio = [int(b["waveforms"].shape[1]) for micro in batches for b in micro]
    print(f"train: projection_training_config, bf16 compute, 3 steps x 2 microbatches x 2 "
          f"utterances (padded samples {t_audio}), losses {[round(x, 5) for x in losses]}, "
          f"step walls {[round(x, 3) for x in walls]} s (warm step {walls[-1]:.3f} s), "
          f"skipped {metrics['train/skipped_nonfinite_total']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {launches}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(metrics["train/skipped_nonfinite_total"] == 0.0, "an update was dropped as non-finite")
    check(all(torch.equal(a, b) for a, b in zip(lm_before, optim.tree_leaves(params["lm_decoder"]))),
          "a frozen LM weight changed")
    for name, old in before.items():
        check(not torch.equal(old, watched[name]), f"trained weight {name} did not move")
    for name in TRAIN_KERNELS:
        check(launches[name] > 0, f"training never launched the {name} kernel")
    del lm_before, before

    profile_training_step(torch, trainer, batches[-1])

    # one f32 gradient step, kernel route vs plain route, same seeds
    plain_model = AslmModel(
        model.config, dataclasses.replace(model.audio_encoder_config, attention_impl="xla"),
        dataclasses.replace(model.lm_config, attention_impl="xla"))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    routes = {}
    for label, m in (("kernel", model), ("plain", plain_model)):
        t = AATTrainer(m, params, f32)
        grads, metrics = t._grad_step(params, batches[0][0], t.dropout_seed(0, 0))
        routes[label] = (metrics["train/loss"].item(), optim.global_norm(grads).item(),
                         grads["audio_encoder"]["feature_projection"]["projection"]["kernel"])
        del t, grads
        torch.cuda.empty_cache()
    (loss_k, norm_k, fp_k), (loss_p, norm_p, fp_p) = routes["kernel"], routes["plain"]
    fp_err = float((fp_k - fp_p).abs().max())
    fp_scale = float(fp_p.abs().max())
    print(f"train f32 routes: loss kernel {loss_k:.6f} plain {loss_p:.6f}; grad norm kernel "
          f"{norm_k:.6e} plain {norm_p:.6e}; feature_projection grad max err {fp_err:.3e} "
          f"(max|ref| {fp_scale:.3e})", flush=True)
    check(abs(loss_k - loss_p) <= TRAIN_REL_TOL * abs(loss_p), "f32 loss differs between routes")
    check(abs(norm_k - norm_p) <= TRAIN_REL_TOL * norm_p, "f32 grad norm differs between routes")
    check(fp_err <= TRAIN_REL_TOL * fp_scale, "f32 feature_projection grads differ between routes")
    return launches


def profile_training_step(torch, trainer, micro, name="train"):
    """One torch.profiler pass over a warm training step: device busy time
    (the union of kernel intervals), the idle share of the step's wall, and
    device time by kernel, to ``<name>_profile.txt`` in the kernels' build
    directory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aat_tpu_torch.runtime.kernels import BUILD_DIR

    path = os.path.join(BUILD_DIR, f"{name}_profile.txt")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.training_step(micro)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(kernels, "the profiler recorded no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:  # union of the kernel intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.end - e.time_range.start, count + 1)
    with open(path, "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy_us / 1e6:.4f} s, "
                f"{len(kernels)} kernels\n\ndevice ms, launches, kernel\n")
        for kernel, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:60]:
            f.write(f"{total / 1e3:10.3f} {count:6d}  {kernel[:160]}\n")
        f.write("\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=30))
    print(f"profile: warm {name} step wall {wall:.3f} s (profiled), device busy "
          f"{busy_us / 1e6:.3f} s, idle share {1 - busy_us / 1e6 / wall:.3f}, "
          f"{len(kernels)} kernels ({os.path.relpath(path, REPO)})", flush=True)


def assert_ids_near(torch, label, got, x, codebook):
    """Ids ``got`` against the plain route's assignment of x to the
    codebook: equal where the plain best-to-second distance gap exceeds
    1e-4 * max(1, |best|), and on every row the chosen code's distance
    within that margin of the plain minimum (the kernel and cuBLAS sum x.c
    in other orders, so a near-tie may resolve either way). Returns (plain
    ids, rows with a clear gap, rows that differ, worst excess)."""
    from aat_tpu_torch.ops import vq

    cbn = vq.codebook_norms(codebook)
    ref = vq.nearest_codebook_reference(x, codebook, cbn).long()
    dist = cbn[None, :] - 2.0 * (x @ codebook.t())
    two = torch.topk(dist, 2, dim=1, largest=False).values
    best, second = two[:, 0], two[:, 1]
    margin = 1e-4 * torch.clamp_min(best.abs(), 1.0)
    clear = (second - best) > margin
    chosen = dist.gather(1, got.long()[:, None])[:, 0]
    excess = float((chosen - best - margin).max())
    same = got.long() == ref
    check(bool(same[clear].all()), f"{label}: ids differ from the plain route where the gap "
                                   "is clear")
    check(excess <= 0.0, f"{label}: a chosen code is {excess} past the margin")
    return ref, int(clear.sum()), int((~same).sum()), excess


def pipeline_items(rng):
    """Speech-like utterances of ``PIPELINE_SECONDS``, as dataset items."""
    return [{"id": f"utt{i}", "audio": {"array": speechlike_waveform(rng, d)}}
            for i, d in enumerate(PIPELINE_SECONDS)]


def phase_pipeline(torch, device, rng):
    """The offline discrete-token pipeline at full width (hubert-large with
    seeded random weights, 1024 codes): the three command lines in a
    temporary directory. Returns the launch counts of the run."""
    import tempfile

    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.ops import vq
    from aat_tpu_torch.runtime.kernels import BUILD_DIR
    from aat_tpu_torch.scripts import mean_segment_embeddings, quantize_embeddings
    from aat_tpu_torch.scripts import segment_embeddings

    items = pipeline_items(rng)
    all_codes = (1024, 64)
    os.makedirs(BUILD_DIR, exist_ok=True)
    # the dataset is the synthetic items, read where --dataset would load one
    load_hf_dataset = segment_embeddings.load_hf_dataset
    segment_embeddings.load_hf_dataset = lambda name, split=None: items
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        seg_dir, mean_dir = (os.path.join(tmp, d) for d in ("seg", "mean"))
        tok_dirs = [os.path.join(tmp, f"tok{codes}") for codes in all_codes]
        # HuBERT sees 74 frames per 1.5 s segment, under the flash gate
        # (MIN_PALLAS_SEQ_LEN, as in JAX): the flash count stays 0
        for w in (vq.nearest_codebook_kernel, att.flash_forward_kernel):
            w.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            segment_embeddings.main(["--dataset", "synthetic", "--out", seg_dir,
                                     "--random-init"], device=device)
        finally:
            segment_embeddings.load_hf_dataset = load_hf_dataset
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - start
        start = time.perf_counter()
        mean_segment_embeddings.main(["--embeddings", seg_dir, "--out", mean_dir])
        for codes, tok_dir in zip(all_codes, tok_dirs):
            quantize_embeddings.main(["--embeddings", mean_dir, "--out", tok_dir,
                                      "--codes", str(codes), "--iters", "10"], device=device)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - start
        launches = {"vq": vq.nearest_codebook_kernel.launches,
                    "flash_fwd": att.flash_forward_kernel.launches}

        names = [it["id"] for it in items]
        means = [np.load(os.path.join(mean_dir, f"{n}.npy"))[0] for n in names]
        runs = [([np.load(os.path.join(d, f"{n}.tokens.npy")) for n in names],
                 np.load(os.path.join(d, "codebook.npy"))) for d in tok_dirs]
    per_utt = [m.shape[0] for m in means]
    n = sum(per_utt)
    x = torch.from_numpy(np.concatenate(means)).to(device)
    print(f"pipeline: {len(items)} utterances, segments per utterance {per_utt}, N {n} "
          f"embeddings of dim {x.shape[1]}, segment_embeddings {seg_s:.2f} s, mean + "
          f"quantize ({' and '.join(map(str, all_codes))} codes) {quant_s:.2f} s; "
          f"launches {launches}", flush=True)
    check(n < all_codes[0] and n > all_codes[1], "N does not fall between the code counts")
    check(bool(torch.isfinite(x).all()), "pipeline embeddings not finite")
    for codes, (tokens, codebook) in zip(all_codes, runs):
        codebook = torch.from_numpy(codebook).to(device)
        ids = torch.from_numpy(np.concatenate(tokens)).to(device)
        _, clear, differ, excess = assert_ids_near(torch, f"pipeline ids ({codes} codes)", ids,
                                                   x, codebook)
        print(f"pipeline {codes} codes ({'padded: N < K' if n < codes else 'N > K'}): "
              f"{len(torch.unique(ids))} codes used; written ids vs plain rerun: {clear} "
              f"rows with a clear gap equal, {differ} differ on near-ties, worst excess "
              f"{excess:.3e}", flush=True)
        check(all(t.shape == (m.shape[0],) for t, m in zip(tokens, means)),
              "token files do not match the embeddings")
        check(bool(((ids >= 0) & (ids < codes)).all()), "a token id is out of range")
    check(launches["vq"] > 0, "the pipeline never launched the vq kernel")
    return launches


def corpus_embeddings(torch, device, n, d, seed):
    """A seeded Gaussian mixture ``[n, d]`` made on the device: 256 centres,
    unit noise around them at 0.5."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centres = torch.randn((256, d), generator=g, device=device)
    which = torch.randint(0, 256, (n,), generator=g, device=device)
    return centres[which] + 0.5 * torch.randn((n, d), generator=g, device=device)


def phase_vq_corpus(torch, device):
    """Kernel 8 against its plain version at corpus scale (N = 262,144,
    D = 1024), K = 1024 and the overhanging K = 1000, with exact duplicate
    codes; then 10 EMA iterations of the quantize command line's loop.
    Returns the K = 1024 result for the kernels line."""
    from aat_tpu_torch.ops import vq
    from aat_tpu_torch.scripts.quantize_embeddings import train_codebook

    n, d, sizes = VQ_CORPUS
    x = corpus_embeddings(torch, device, n, d, seed=10)
    result = None
    for k in sizes:
        g = torch.Generator(device=device)
        g.manual_seed(k)
        cb = x[torch.randperm(n, generator=g, device=device)[:k]] + 0.1 * torch.randn(
            (k, d), generator=g, device=device)
        cb[k - 24:] = cb[5]  # exact duplicates of code 5
        cb[k // 2] = cb[7]  # and of code 7, between the two
        x[:64] = cb[5]  # rows sitting exactly on a duplicated code
        x[64:128] = cb[7]
        cbn = vq.codebook_norms(cb)
        got = vq.nearest_codebook_kernel(x, cb, cbn)
        ref, clear, differ, excess = assert_ids_near(torch, f"vq K={k}", got, x, cb)
        ms = cuda_ms(torch, lambda: vq.nearest_codebook_kernel(x, cb, cbn), iters=5, warmup=1)
        plain_ms = cuda_ms(torch, lambda: vq.nearest_codebook_reference(x, cb, cbn), iters=5,
                           warmup=1)
        gflop = 2.0 * n * k * d / 1e9
        print(f"vq: N {n} D {d} K {k}: {clear} rows with a clear gap equal, {differ} ids "
              f"differ from the plain route (near-ties), worst excess {excess:.3e}; exact "
              f"duplicates -> {sorted(set(got[:128].tolist()))}; kernel {ms:.4f} ms "
              f"({gflop / ms:.1f} TFLOP/s) plain {plain_ms:.4f} ms", flush=True)
        check(bool((got[:64] == 5).all() and (got[64:128] == 7).all()),
              f"vq K={k}: an exact tie did not go to the lowest id")
        check(bool((ref[:64] == 5).all() and (ref[64:128] == 7).all()),
              f"vq K={k}: the plain route broke an exact tie")
        if result is None:
            # ids that differ count as the error: an id is right or wrong
            result = {"max_abs_err": float(differ), "ms": ms, "plain_ms": plain_ms}
        del ref
    train_codebook(x, sizes[0], 1, 0.8, log=lambda line: None)  # warm-up: first-call costs
    torch.cuda.synchronize()
    mse = []
    start = time.perf_counter()
    state = train_codebook(x, sizes[0], 10, 0.8, log=mse.append)
    torch.cuda.synchronize()
    ema_ms = (time.perf_counter() - start) * 1e3 / 10
    print(f"vq EMA: 10 iterations of the quantize loop at N {n} K {sizes[0]} (after one "
          f"warm-up iteration): {ema_ms:.2f} ms per iteration; {' | '.join(mse)}", flush=True)
    check(bool(torch.isfinite(state.codebook).all()), "EMA codebook not finite")
    return result


def plain_by_heads(torch, fn, q, k, v, mask, residuals, scale, kw):
    """A plain version over ``PLAIN_HEADS`` heads at a time of a batch of
    one with KVH = H, its results joined on their head axes. ``residuals``
    is ``(out, lse, dout)`` for the backward's plain versions, else None.
    Head h's dropout mask is keyed on seed + h·GOLDEN, so a chunk starting
    at head h0 takes the seed shifted by h0·GOLDEN."""
    from aat_tpu_torch.ops.dropout import GOLDEN, to_int32

    b, _, h, _ = q.shape
    check(b == 1 and k.shape[2] == h, "plain_by_heads takes B = 1 and KVH = H")
    parts = []
    for h0 in range(0, h, PLAIN_HEADS):
        heads = slice(h0, h0 + PLAIN_HEADS)
        args = [x[:, :, heads] for x in (q, k, v)] + [mask]
        if residuals is not None:
            out, lse, dout = residuals
            args += [out[:, :, heads], lse[:, heads], dout[:, :, heads]]
        seed = to_int32(kw["dropout_seed"] + h0 * GOLDEN)
        result = fn(*args, scale, **dict(kw, dropout_seed=seed))
        parts.append(result if isinstance(result, tuple) else (result,))
    # [B, T, H, D] outputs join on axis 2, the lse [B, H, T] on axis 1
    joined = tuple(torch.cat(xs, dim=1 if xs[0].dim() == 3 else 2) for xs in zip(*parts))
    return joined if len(joined) > 1 else joined[0]


def phase_split_backward(torch, device, rng):
    """The long-form path's kernels at its shapes (``SPLIT_CASES``, key
    lengths above 8192) against their plain versions, f32 and bf16, at
    phase 7's tolerances: the forward kernel (out, lse), then the split
    route's dq and dk/dv kernels fed the plain forward's out and lse. The
    plain versions run through :func:`plain_by_heads`. Returns the f32
    results for the kernels line."""
    from aat_tpu_torch.ops import attention as att

    results = {}
    for (b, t, h, d), causal, (rate, seed) in SPLIT_CASES:
        check(t > att.FUSED_BWD_MAX_S, "the split case does not exceed the fused cap")
        fwd = att.flash_forward_causal_kernel if causal else att.flash_forward_kernel
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(np.float32))
                          .to(device=device, dtype=dtype) for _ in range(4))
            mask = torch.ones((b, t), dtype=torch.int32, device=device)
            mask[:, t - t // 10:] = 0
            scale = d ** -0.5
            kw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
            fkw = dict(dropout_rate=rate, dropout_seed=seed, need_lse=True)

            def plain(fn, residuals=None):
                return plain_by_heads(torch, fn, q, k, v, mask, residuals, scale, kw)

            out, lse = fwd(q, k, v, mask, scale, **fkw)
            ref_out, ref_lse = plain(att.flash_forward_reference)
            args = (q, k, v, mask, ref_out, ref_lse, g, scale)
            dq = att.flash_backward_dq_long(*args, **kw)
            dk, dv = att.flash_backward_dkv_long(*args, **kw)
            ref_dq = plain(att.flash_backward_dq_reference, (ref_out, ref_lse, g))
            ref_dk, ref_dv = plain(att.flash_backward_dkv_reference, (ref_out, ref_lse, g))
            torch.cuda.synchronize()
            out_err = float((out.float() - ref_out.float()).abs().max())
            live = ref_lse > -1e29
            lse_err = float((lse - ref_lse)[live].abs().max())
            out_bound = FLASH_TOL[dtype_name] * (
                max(1.0, float(ref_out.float().abs().max())) if dtype_name == "bfloat16" else 1.0)
            errs = [float((a.float() - r.float()).abs().max()) for a, r in
                    ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv))]
            rel = [e / float(r.float().abs().max()) for e, r in zip(errs, (ref_dq, ref_dk, ref_dv))]
            del ref_dq, ref_dk, ref_dv
            torch.cuda.empty_cache()
            fwd_ms = cuda_ms(torch, lambda: fwd(q, k, v, mask, scale, **fkw), iters=3, warmup=1)
            dq_ms = cuda_ms(torch, lambda: att.flash_backward_dq_long(*args, **kw), iters=3,
                            warmup=1)
            dkv_ms = cuda_ms(torch, lambda: att.flash_backward_dkv_long(*args, **kw), iters=3,
                             warmup=1)
            fwd_plain_ms = cuda_ms(torch, lambda: plain(att.flash_forward_reference), iters=2,
                                   warmup=1)
            dq_plain_ms = cuda_ms(torch, lambda: plain(att.flash_backward_dq_reference,
                                                       (ref_out, ref_lse, g)), iters=2, warmup=1)
            dkv_plain_ms = cuda_ms(torch, lambda: plain(att.flash_backward_dkv_reference,
                                                        (ref_out, ref_lse, g)), iters=2, warmup=1)
            torch.cuda.empty_cache()
            label = (f"{'causal' if causal else 'dense'} [{b},{t},{h},{d}] {dtype_name}"
                     f"{f' dropout {rate}' if rate else ''}")
            print(f"long-form kernels: {label} fwd out err {out_err:.3e} (bound {out_bound:.2e}) "
                  f"lse err {lse_err:.3e} (bound {FLASH_TOL[dtype_name]}); split bwd dq/dk/dv "
                  f"err/max|ref| {'/'.join(f'{e:.2e}' for e in rel)} (bound "
                  f"{GRAD_REL_TOL[dtype_name]}); fwd {fwd_ms:.4f} ms plain {fwd_plain_ms:.4f} ms, "
                  f"dq {dq_ms:.4f} ms plain {dq_plain_ms:.4f} ms, dkv {dkv_ms:.4f} ms plain "
                  f"{dkv_plain_ms:.4f} ms", flush=True)
            check(all(bool(torch.isfinite(x.float()).all()) for x in (out, dq, dk, dv)),
                  f"long-form kernels {label}: non-finite output or gradient")
            check(out_err <= out_bound and lse_err <= FLASH_TOL[dtype_name],
                  f"long-form kernels {label}: forward differs by {out_err} (lse {lse_err})")
            check(max(rel) <= GRAD_REL_TOL[dtype_name],
                  f"long-form kernels {label}: gradients differ by {rel} of max|ref|")
            if dtype_name == "float32":
                name = "causal" if causal else "dense"
                results[f"fwd_{name}"] = {"max_abs_err": out_err, "ms": fwd_ms,
                                          "plain_ms": fwd_plain_ms}
                results[f"dq_{name}"] = {"max_abs_err": errs[0], "ms": dq_ms,
                                         "plain_ms": dq_plain_ms}
                results[f"dkv_{name}"] = {"max_abs_err": max(errs[1:]), "ms": dkv_ms,
                                          "plain_ms": dkv_plain_ms}
            del q, k, v, g, out, lse, ref_out, ref_lse, args, dq, dk, dv
            torch.cuda.empty_cache()
    return results


def longform_batch(torch, device, rng, seconds, vocab):
    """One whole utterance of ``seconds`` of speech-like audio, normalized,
    and a random caption of 32-48 tokens."""
    w = speechlike_waveform(rng, seconds)
    w = (w - w.mean()) / (w.std() + 1e-7)
    c = int(rng.integers(32, 49))
    ids = rng.integers(3, vocab, (1, c))
    ones = np.ones((1, c), np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in (
        ("waveforms", w[None].astype(np.float32)),
        ("waveforms_attention_mask", np.ones((1, w.size), np.int32)), ("input_ids", ids),
        ("attention_mask", ones), ("input_ids_attention_mask", ones))}


def phase_longform(torch, device, rng):
    """2 optimizer steps of ``projection_training_config()`` with the
    Qwen-1.5-1.8B LM at full width (random weights through ``build_model``),
    one utterance of 170 s and one of 180 s: every attention's key length
    exceeds 8192, so the backward takes the split route. Returns the launch
    counts of the 2 steps."""
    from aat_tpu_torch.models.build import build_model
    from aat_tpu_torch.models.hubert import feature_lengths
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.config import projection_training_config
    from aat_tpu_torch.training.trainer import AATTrainer

    cfg = dataclasses.replace(projection_training_config(), lm_pretrained_model="Qwen/Qwen1.5-1.8B",
                              per_device_train_batch_size=1, gradient_accumulation_steps=1)
    start = time.perf_counter()
    model, params = build_model(cfg, pretrained=False, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - start
    lm = model.lm_config
    n_lm = sum(x.numel() for x in optim.tree_leaves(params["lm_decoder"]))
    trainer = AATTrainer(model, params, cfg)
    lm_before = [x.detach().cpu() for x in optim.tree_leaves(params["lm_decoder"])]
    fp = params["audio_encoder"]["feature_projection"]["projection"]["kernel"]
    fp_before = fp.detach().clone()
    batches = [longform_batch(torch, device, rng, s, lm.vocab_size) for s in LONGFORM_SECONDS]

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for batch in batches:
        start = time.perf_counter()
        metrics = trainer.training_step([batch])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        losses.append(metrics["train/loss"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: w.launches for name, w in wrappers.items()}
    frames = [int(feature_lengths(model.audio_encoder_config,
                                  b["waveforms_attention_mask"].sum(-1))[0]) for b in batches]
    print(f"longform: Qwen-1.5-1.8B ({n_lm / 1e9:.3f} B LM params, {lm.num_hidden_layers} "
          f"layers, width {lm.hidden_size}, D {lm.head_dim}) + hubert-large, init "
          f"{init_s:.1f} s; 2 steps of one utterance ({LONGFORM_SECONDS} s: {frames} frames, "
          f"captions {[int(b['input_ids'].shape[1]) for b in batches]}), losses "
          f"{[round(x, 5) for x in losses]}, step walls {[round(x, 3) for x in walls]} s, "
          f"peak memory {peak:.1f} GiB, launches {launches}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite long-form loss {losses}")
    check(metrics["train/skipped_nonfinite_total"] == 0.0, "an update was dropped as non-finite")
    check(all(torch.equal(a, b.detach().cpu())
              for a, b in zip(lm_before, optim.tree_leaves(params["lm_decoder"]))),
          "a frozen Qwen weight changed")
    check(not torch.equal(fp_before, fp), "the encoder's weights did not move")
    for name in ("flash_fwd", "flash_fwd_causal", "flash_bwd_dq_long", "flash_bwd_dkv_long"):
        check(launches[name] > 0, f"long-form training never launched {name}")
    for name in ("flash_bwd", "flash_bwd_causal"):
        check(launches[name] == 0, f"long-form training launched {name} (S <= 8192 route)")
    del lm_before
    profile_training_step(torch, trainer, [batches[-1]], name="longform")
    return launches


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
    # 7. training kernels vs their plain versions
    train_results = phase_flash_train(torch, device, rng)

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

    for w in kernel_wrappers().values():
        w.launches = 0
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

    # 8. training at full width (the serving weights, trained in place)
    train_launches = phase_training(torch, model, params, rng)
    del model, params  # SmolLM and its encoder leave the card before Qwen comes
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the offline discrete-token pipeline at full width
    pipeline_launches = phase_pipeline(torch, device, rng)
    # 10. kernel 8 at corpus scale
    vq_result = phase_vq_corpus(torch, device)
    # 11. the long-form path's kernels at its shapes, then training with Qwen
    split_results = phase_split_backward(torch, device, rng)
    gc.collect()
    torch.cuda.empty_cache()
    longform_launches = phase_longform(torch, device, rng)

    def entry(name, source, replaces, count, result):
        return {"name": name, "route": "cuda", "source": f"aat_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": count, **result}

    kernels_line = {"kernels": [
        entry("mel", "mel.cu", "aat_tpu/ops/mel_pallas.py:36", launches["mel"], mel_result),
        entry("flash_fwd", "flash_fwd.cu", "aat_tpu/ops/attention.py:186",
              launches["flash_fwd"], flash_result),
        entry("flash_fwd_causal", "flash_fwd.cu", "aat_tpu/ops/attention.py:245",
              train_launches["flash_fwd_causal"], train_results["fwd_causal"]),
        entry("flash_bwd", "flash_bwd.cu", "aat_tpu/ops/attention.py:764",
              train_launches["flash_bwd"], train_results["bwd_dense"]),
        entry("flash_bwd_causal", "flash_bwd.cu", "aat_tpu/ops/attention.py:709",
              train_launches["flash_bwd_causal"], train_results["bwd_causal"]),
        entry("flash_bwd_dq_long", "flash_bwd.cu", "aat_tpu/ops/attention.py:562",
              longform_launches["flash_bwd_dq_long"], split_results["dq_dense"]),
        entry("flash_bwd_dkv_long", "flash_bwd.cu", "aat_tpu/ops/attention.py:595",
              longform_launches["flash_bwd_dkv_long"], split_results["dkv_dense"]),
        entry("vq", "vq.cu", "aat_tpu/ops/vq.py:50", pipeline_launches["vq"], vq_result),
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
