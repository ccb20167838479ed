#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``aat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--mla [--ab LABEL=CSRC ...]]

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile ``aat_tpu_torch/csrc/*.cu`` for sm_90a (nvcc, ctypes);
  3. mel kernel vs its plain PyTorch version at the serving path's shape
     (frames of 8 x 12 s of speech-like audio), on the framing's strided
     view and on a contiguous copy: max abs error <= 1e-4, against the f64
     computation too, the two inputs' results equal; timed beside PR 6's
     first version (another call's time) and at serving's [1,1201,400];
  4. flash forward kernels vs their plain version at [1,999,16,64] and
     [2,1499,16,64] with a padded key tail and a fully masked row, and GQA
     [1,300,8/2,128], f32 (<= 1e-4, the 3xTF32 tensor-core kernel of
     csrc/flash_fwd_tf32x3.cu) and bf16 (<= 2e-2, the tensor-core kernel
     of csrc/flash_fwd_mma.cu), each launch through its dtype's C entry,
     and every flash forward's ||out - ref||_F / ||ref||_F within 1e-4
     (f32) / 1e-2 (bf16); the masked row must be exactly 0; SDPA's f32
     (memory-efficient backend) time printed beside each f32 case;
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
     and phase 4's norm ratio,
     gradients within 1e-3 (f32) / 3e-2 (bf16) of max|ref| (sums in
     another order; bf16 rounds p and ds) and each of dq, dk and dv within
     ||g - ref||_F / ||ref||_F <= 1e-4 (f32) / 1e-2 (bf16); bf16 through
     the tensor-core entries (``*_mma``), f32 through the 3xTF32 entries
     (``*_tf32x3``), counted by C entry; the yardstick
     ``scaled_dot_product_attention`` (SDPA) is timed on the same operands
     (forward; backward as forward plus backward minus forward), with the
     bounds, in both dtypes. Then the keep-mask identity checks, dropout
     0.5, dense and causal: the bf16 and f32 forwards at [2,300,4,128]
     against S = D = 128 keys with v the identity (out == 0 reads its keep
     mask; in f32 this also pins the 3xTF32 kernel's relabelled P.V, whose
     hash must take the true key); in bf16 and f32 the dk/dv kernel with
     T = D = 128 and dout the identity (dv == 0) and the dq kernel with
     S = D = 128, k = v the identity and out = 0 (dq == 0). Each must equal
     the plain version's ``_keep_mask`` on every allowed position. Then the
     head keys of a tensor-parallel shard, through all six C entries, bf16
     and f32, dense and causal, D = 64 and 128, 8 q-heads over 2 kv heads
     at T = 300 with the same identity readings (dk/dv one q-head of each
     kv group at a time): two launches on half the heads each, with
     ``head_keys = (8, 0)`` and ``(8, 4)``, must read exactly the global
     launch's masks of their heads, bit for bit, and the plain version's
     halves too; the global launch reads ``_keep_mask``, and a half keyed
     on its own heads (the keys a tp shard took before ``head_keys``) must
     not;
  8. training at full width: ``projection_training_config()`` (bf16
     compute over f32 masters, hubert-large train-mode dropout and
     LayerDrop, frozen LM, fused guarded AdamW), 3 optimizer steps of 2
     microbatches of 2 utterances (8-20 s, captions of 32-48 tokens):
     finite losses, the frozen LM bitwise unchanged, trained weights
     moved, every bf16 flash launch through the tensor-core C entries
     (``aat_flash_fwd_mma``, ``aat_flash_bwd_dq_mma``,
     ``aat_flash_bwd_dkv_mma``) and none through the f32 ones; one more
     step under ``torch.profiler`` gives the device's busy time and idle
     share, with device time by kernel written beside the build log
     (``aat_tpu_torch/build/train_profile.txt``) and the forward and
     backward kernels' device time printed by name; then one f32 gradient
     step through the kernel route and the plain route with the same seeds:
     loss and global grad norm within 1e-3 relative, feature_projection
     grads within 1e-3 * max|ref|; its flash launches through the 3xTF32
     entries only.
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
 10. the vq kernel (3xTF32 on the tensor cores) vs its plain version at
     corpus scale, N = 262,144 seeded Gaussian-mixture rows of D = 1024
     against K = 1024 and the overhanging K = 1000, with exact duplicate
     codes (which must go to the lowest id), 4,096 planted near-tie rows
     (best-to-second gap 0.25-0.75 of the margin, ``NEAR_TIE_GAP``, built
     between two codes of one mixture centre: the ids must equal the f64
     argmin on every one; one-pass TF32 would miss about one in ten)
     and the same near-tie rule; a ragged case (N 4,099, K 333, D 1,001:
     4-byte copies) under the same rules; then 10 iterations of the
     quantize loop at that size, after one that warms it up;
 11. the long-form path's kernels vs their plain versions at its shapes
     (key length > 8192): HuBERT's dense [1,8499,16,64] with dropout 0.1
     and Qwen's causal [1,8540,16,128], padded key tails, f32 and bf16 at
     phase 7's tolerances and routing; the forward (out, lse) and the split
     backward's dq and dk/dv kernels, with SDPA timed as in phase 7,
     and the dense bf16 forward timed again at rate 0. Two faults are
     planted through the kernels' own arguments (the 1/(1 - rate) rescale
     left out; keys 1024-1087, one 64-key tile, left out), in the bf16
     forward and in both backward entries of each dtype: the out and
     gradient norm ratios must reject every one, and a control launch with
     the wrappers' arguments must reproduce their output bit for bit. The
     plain
     versions run 4 heads at a time, so
     their [B, H, T, S] f32 tensors stay near 1.2 GB (a batch of one, so a
     head's dropout mask is keyed on seed + head·GOLDEN, and a chunk
     starting at head h0 takes the seed shifted by h0·GOLDEN); then 2
     optimizer steps of ``projection_training_config()``
     with the Qwen-1.5-1.8B LM at full width (random weights through
     ``models.build.build_model``), one utterance of 170 s and one of
     180 s (HuBERT T = 8499 and 8999): finite losses, the frozen Qwen
     bitwise unchanged, the encoder moved, the split kernels launched and
     the S <= 8192 backward kernels not, every flash launch through the
     tensor-core entries; then one more step under ``torch.profiler``
     (``aat_tpu_torch/build/longform_profile.txt``).
 12. train → evaluate → save → resume → finalize at full width, run right
     after phase 8 on its model and weights, with cuDNN's deterministic
     algorithms, in a temporary directory under the build directory that
     it deletes: run A, ``projection_training_config()`` with
     ``eval_steps = save_steps = 2``, ``max_steps = 4``, one microbatch of
     2 utterances (8-20 s) a step, ``train(batches, eval_batches=...)``
     over 2 eval batches with a text prefix, ``ComputeMetrics`` through a
     decode-only word tokenizer (eos 2): ``checkpoint-2`` and
     ``checkpoint-4`` with their ``trainer_meta.json``, two evals with a
     finite ``eval/loss`` and every metric, beam-3 generation with the
     reference's settings; with the larger eval loss counted as best,
     ``finalize()`` brings back ``checkpoint-2``'s weights (which differ
     from step 4's) and keeps step 4 and its moments, bit for bit;
     ``save_pretrained`` then ``build_model(from_pretrained_adapter=...)``
     gives the adapter back bit for bit; run B, a fresh trainer on that
     build, ``train(batches, resume_from_checkpoint=checkpoint-2)``: the
     restored state equals what run A saved, the fast-forward skips
     exactly steps 1-2's microbatches, and the step-4 params, moments,
     counts and step equal run A's bit for bit. The training steps and
     the eval loss launch through the ``*_mma`` entries only, each
     generation prefix (f32 masters) through ``aat_flash_fwd_tf32x3`` only,
     rows 2-5 each at least once. The generation ids of the kernel prefix
     route equal the plain route's, or the routes' first differing beam
     selection (2K candidates, pool merge or running beams) is a near tie
     in the plain route's own scores: its pick beats the kernel route's by
     less than 1e-4 * max(1, |score|), phase 9's rule. It prints the eval
     walls, generation tokens/s, and the checkpoint save and restore
     seconds with bytes, beside the card's name and power limit.
 13. the command lines at full width, right after phase 12, in a temporary
     directory under the build directory (deleted at the end), with cuDNN's
     deterministic algorithms and wandb disabled: hubert-large written as an
     HF ``HubertForCTC`` directory (the ``hubert.`` prefix, the positional
     conv as ``weight_g``/``weight_v``, ``lm_head.*`` and
     ``masked_spec_embed`` as keys the model lacks; f32) and SmolLM-135M as
     a tied ``LlamaForCausalLM`` in bf16, from seeded weights, through a
     small safetensors writer here; ``build_model(pretrained=True)`` must
     read every tensor bit for bit (the LM after its bf16 upcast) and the
     positional conv within 1e-6 (norm ratio) of g v / ||v|| in f64. Then
     ``scripts.train.main`` with the dataset and tokenizer replaced at
     their seams (8 train and 4 validation utterances of 8-20 s with words
     and their times; a word-level tokenizer): run A, the default preset
     with ``--pretrained`` on those directories, 2 epochs of 4 steps of 2
     utterances, evals and saves at steps 3 and 6, ``--no-load-best-
     model-at-end`` (neither trainer restores the best-metric record):
     train and eval lines in ``metrics.jsonl``, the steps' and eval losses'
     flash launches through the ``*_mma`` entries only, the generation
     prefixes' through ``aat_flash_fwd_tf32x3`` only; run B resumes from
     ``checkpoint-6`` (epoch 1, 2 batches fast-forwarded, the collators'
     generators restored from the checkpoint) and must write a
     ``checkpoint-8`` equal to run A's on every tensor of ``params.pt`` and
     ``optimizer.pt``; a 2-step ``--segmentation adaptive`` run (the
     ``n_words`` 50 crop) with finite losses; ``scripts.validate`` on run
     A's export (``--no-pretrained``) with its metrics printed; and
     ``scripts.serve --model-dir`` on that export, whose ids must equal
     ``serving.serve`` on the model it loaded, with mel kernel launches. It
     prints the read seconds and bytes, and the walls of steps, evals and
     saves, beside the card's name and power limit.
 14. the dataset utilities at full width, in phase 13's directory: a
     ``datasets`` dataset of 16 seeded speech-like utterances of 4-30 s
     (``Dataset.from_dict``, saved to disk), then ``scripts.
     melspec_precompute``, ``scripts.audio_tokenization`` on the host
     route and with ``--device-batch 8`` (every utterance's
     ``segment_frames`` equal, the mel kernel launched; on a mismatch each
     differing utterance is printed with its boundary frame and the plain
     mel route's result on the card), ``tokenizer.tokenize_dense`` in
     chunks of 8 against one flat call (tables and segments equal, and the
     table equal to the device route's), ``scripts.reduce_seq_len``
     against a local alignment dataset, ``merge_datasets``,
     ``dataset_info``, ``inspect_embeddings``, ``parity_check --clips 8``
     and ``parity_check --weights`` / ``--lm-weights`` on phase 13's
     hubert-large and SmolLM directories (frames within 2e-4 of
     ``transformers``' HubertModel on the CPU, bf16 segment means within
     1e-3 relative MSE, the eval wiring); the native host library
     (``csrc/aat_host.cpp``) built, the route the host tokenizer and the
     adaptive collator took, and one collated batch bitwise equal to the
     numpy route's. Each command's wall is printed.
 15. the trainer's pieces at full width: on phase 8's model after phase
     12, the whole-utterance step (2 microbatches of 2 utterances) and on
     phase 11's model the 170 s long-form step, each without remat and
     with encoder remat "full" and "dots" from the same state (fresh
     trainers, cuDNN deterministic): losses and updated parameters equal
     bit for bit, the encoder's flash forwards twice as many under remat
     (the recompute), peak memory and walls printed; 3 whole-utterance
     steps with Adafactor (``learning_rate=None``, guarded), a save, a
     step, and a fresh trainer restored from the save taking the same step
     bit for bit, then 3 steps of the unfused AdamW chain
     (``skip_nonfinite_updates=False``), finite, the frozen LM unchanged;
     in phase 13's directory the train command line with
     ``--unfreeze-lm-at-epoch 1`` (SmolLM bit for bit the read weights
     through epoch 0, moved in epoch 1) and a run resumed from
     ``checkpoint-6``, after the unfreeze, ending on run A's
     ``checkpoint-8`` bit for bit; and the MFU of phases 8 and 11's warm
     steps from ``utils/flops`` (model FLOPs over the step wall over 989
     TFLOP/s).
 16. the two encoder/projection paths ported last, at full width, after
     phase 15: (a) the ``transformer_encoder`` projection (the default
     ``PoolingConfig``, dropout 0.1) on phase 8's hubert-large and
     SmolLM-135M, 3 steps of 2 microbatches of 2 raw-waveform utterances
     of 2-12 s segmented adaptively on the device (the mel kernel, its
     segment tables equal to the plain mel route's), bf16 over f32
     masters: finite losses, the LM unchanged, the pooling and encoder
     weights moved; an f32 gradient step through the kernel and plain
     routes (mel's plain version, ``attention_impl="xla"``) within
     ``TRAIN_REL_TOL``; the step under remat "dots" against no remat, bit
     for bit, with peak memory (the plain attention route, whose batched
     products "dots" now recomputes); evaluate with generation; the warm
     step's MFU. (b) EfficientNet-b0 (seeded random), the linear
     projection and SmolLM-135M on the train command line's adaptive
     collator's melspec batches of 28-35 s utterances with no n_words
     crop, so every LM row reaches the flash gate: 3 steps with the
     encoder trained (the causal flash kernels through the bf16 entries),
     the stem's BN running mean the EMA of its 6 folds (within 1e-6) and
     moved by no more than 6 EMAs of momentum 0.01 can, one more step
     with the encoder frozen moving only the BN running statistics, an
     f32 kernel-versus-plain step, and evaluate with generation (eval-mode
     BN). (c) in phase 13's directory, the train command line with
     ``--audio-encoder-type efficient_net --projection-type
     transformer_encoder --segmentation adaptive`` (SmolLM read from its
     directory, EfficientNet random after JAX's warning), 2 steps;
     ``scripts.validate`` on its export; the export read back by
     ``load_pretrained`` as an EfficientNet run with a ``PoolingConfig``,
     its params bit for bit.
 17. multi-device training, after phase 16 with the card freed: phase 8's
     model (hubert-large, the linear projection, SmolLM-135M; seed 0) at
     f32 compute (the 3xTF32 kernels: reduction order sets the
     tolerances), 2 steps of ``projection_training_config()`` on one global
     batch of 4 utterances of 8-20 s. First an NCCL process group at world
     size 1 on cuda:0: a step through the mesh code (its collectives on
     NCCL over one rank) equal bit for bit to the plain step (cuDNN
     deterministic). Then the one-process reference in this process, for
     dropout and LayerDrop 0.1 and for 0, its results written under the
     build directory with the initial state, which the ranks load. Then 4
     ranks sharing cuda:0 over gloo (``parallel.distributed.launch``), one
     launch per mesh: ``dp4`` (dropout 0.1, masks keyed on global
     positions), ``dp2 x fsdp2``, ``dp2 x tp2`` (HuBERT's layers as
     tensor-parallel bodies; SmolLM's 9 heads do not split, so its
     tp-sharded leaves are gathered; dropout and LayerDrop 0.1, its head
     and column shards' masks keyed on their global places) and ``dp2 x
     sp2`` (Ulysses attention over full T on 8 heads a rank), dropout 0
     for ``dp2 x fsdp2`` and ``dp2 x sp2``. Each
     rank's losses must be within ``MESH_LOSS_TOL`` (relative) of the
     reference's, and at most ``MESH_FLIP_SHARE`` of the trainable
     coordinates apart by more than ``MESH_FLIP`` (AdamW's first step is
     sign-like: a rounding-level gradient may flip a whole update); kernels 2-5 launched on every
     rank, through the 3xTF32 entries. Three planted faults must break those
     bounds (the factor past them printed): a rank that keeps its own
     gradients in place of the reduced ones (dp2 x fsdp2), dp4 masks keyed
     as the batch's first rows on every rank, and dp2 x tp2 attention
     masks keyed on each rank's own heads (``tp_local_heads``). The fsdp
     ranks' peak memory must be below that of a dp
     control step on the same rows. It prints each rank's flash launches
     by C entry, peak memory and step walls (4 ranks sharing one H100, not
     a scaling number), and the collectives gloo ran, naming those built
     from others.
 18. pipeline-parallel training, right after phase 17 on its model, batch
     and one-process references (the card freed again): 4 gloo ranks on
     cuda:0, one launch per mesh: ``dp2 x pp2`` (12 encoder and 15 LM
     layers a stage, 2 microbatches, dropout and LayerDrop 0.1, held to
     the dropout reference: each microbatch's masks are keyed as its
     first global row), ``pp2 x tp2`` (4 microbatches, dropout and
     LayerDrop 0.1; HuBERT's stacks tp-sharded Megatron bodies keying
     their masks on global heads and columns, SmolLM's pp only),
     ``fsdp2 x pp2`` and
     ``dp2 x pp2`` under Adafactor (relative step), whose one update is
     held to ``optim.adafactor`` applied to the *stacked* tree of the
     one-process trainer's first-step gradients (JAX's pp math factors
     the stacked leaves). Bounds: phase 17's on every rank, and the
     step's gradient-norm metrics within ``MESH_NORM_TOL`` of the
     reference's; kernels 2-5 launched on every rank through the 3xTF32
     entries, and ring permutes run. The two planted boundary faults (the
     result leaving through an all-reduce with a summed gradient, the
     input entering without the sum of the stages' gradients) must break
     the bounds by 10 times or more. Each ``dp2 x pp2`` rank's stacked
     parameter and moment bytes must be exactly half of the whole
     stacks'. The ``dp2 x pp2`` launch also evaluates the initial weights
     with beam generation (eval loss and ids equal to the one-process
     evaluation's, generated on the same 2 rows a data rank holds; where
     ids differ, the first differing beam selection must be a near tie,
     phase 12's rule), writes a checkpoint (stacked on disk) that a
     one-process trainer restores bit for bit, and restores a one-process
     checkpoint bit for bit. It prints each rank's step walls, peak
     memory, ring-permute counts and bytes (4 ranks sharing one H100
     through host memory, not a scaling number).
 19. the element dropout's kernel (``csrc/dropout.cu``) vs its plain
     version, right after phase 7 (``phase_dropout``): forward and
     backward bit for bit on the training path's shapes, views and every
     ``ElementShard`` case, bf16, f32 and f16, seeds at the int32 edges, rates
     0.1 and 0.5; each entry timed at [40,634,4096] against its bytes bound,
     the bf16 entries at 70% of it or more.
 20. the latent-attention kernels, bf16 (D, DV) = (192, 128), causal
     (``phase_mla_kernels``, right after phase 19): the forward with lse,
     the fused backward at [2,999,16,192/128] and the split dq and dk/dv
     kernels at [1,8540,16,192/128] (keys past 8192) against their plain
     versions within phase 11's bounds, v never padded to 192; each timed
     with its bound (2·(192 + 128) flops a pair forward) and, in the same
     call, the (128, 128) causal kernels at the same T: the forward may take
     at most 1.6x theirs (1.25x the flops). ``python3 chip_smoke.py --mla``
     runs phases 1-2 and this one alone; ``--ab LABEL=CSRC`` then also
     times rows 2-7 of the kernel table against the build of another
     ``csrc/`` directory (``ab_flash_entries``).
Launch counters are reset just before each main path (the two serving
runs, the 3 training steps, phase 12's runs A and B, the pipeline, the 2
long-form steps, phase 13's run A and its serve command, phase 14, each
remat step of phase 15, its optimizer steps and its unfreeze run A,
phase 16's three runs, and each rank's steps in phases 17 and 18) and
read just after; each kernel of the path must have
launched there, and each path's flash launches must all go through the C
entries of one dtype (serving's f32 forward through
``aat_flash_fwd_tf32x3``, training's and long-form training's bf16 forward
and backward through the ``*_mma`` entries; phase 12's generation prefixes
are counted apart, as the path ``train_eval_prefix``, from its bf16 part,
``train_eval``; phase 13's likewise, as ``train_cli_prefix`` and
``train_cli``, and its serve command as ``serve_cli``; phase 14 as
``dataset``, phase 15's remat steps as ``train_remat`` and
``longform_remat``, its optimizer steps as ``train_optimizers`` and its
unfreeze run as ``train_unfreeze_cli``; phase 16's as ``train_pooling``,
``train_efficientnet`` and ``train_projections_cli``; phase 17's dp4 rank 0
as ``train_multidevice`` and phase 18's dp2 x pp2 rank 0 as
``train_pipeline``, each rank's launches checked by the rank). Then a
JSON line of kernel results, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. In the kernel line the flash entries
report bf16 (the tensor-core kernels, counting only launches through their
C entries, ``c_entry``), with the f32 kernels' results (the 3xTF32
forward and backward, with their own bounds and SDPA's memory-efficient
f32 times) under ``f32_`` keys and ``f32_source``; the
entry ``flash_fwd_f32`` is the 3xTF32 forward with serving's launches at
serving's shape; ``library_ms`` is SDPA's time (null for mel and vq, which
no single PyTorch call computes), and ``bound_ms`` the larger of the bytes
over 3.35 TB/s and the operations over their peak rates, counted from this
run's inputs: matrix products at 989 TFLOP/s in bf16 and, in f32, at 495 /
3 = 165 TFLOP/s (``PEAK_FLOPS``: an f32-accurate product is three TF32
products on the tensor cores, as 3xTF32; this prices the flash kernels and
vq whatever pipes they use), mel's f32 work at the FFMA rate of 67 TFLOP/s
(``FFMA_FLOPS``: its contract keeps it off TF32), the exponentials and the
dropout hash at the SM's MUFU and INT32 issue rates.

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
NEAR_TIES = 4096  # planted near-tie rows of phase 10
# their best-to-second gap, in near-tie margins: in the CPU emulation of
# tests/test_torch_tf32x3.py (this construction, D = 1024) one-pass TF32's
# error in a gap spreads over about a third of a margin, so at 1.1 margins
# and above it flips almost no row; here it flips about one in ten, while
# 3xTF32's error stays within a fiftieth of a margin
NEAR_TIE_GAP = (0.25, 0.75)
VQ_RAGGED = (4099, 333, 1001)  # N, K, D of phase 10's ragged case
# (B, T, H, D), causal, dropout: HuBERT's and Qwen's attention in phase 11
SPLIT_CASES = (((1, 8499, 16, 64), False, (0.1, 24680)),
               ((1, 8540, 16, 128), True, (0.0, 0)))
PLAIN_HEADS = 4  # heads per call of a plain version in phase 11
LONGFORM_SECONDS = (170.0, 180.0)
EVAL_EOS = 2  # the eos id of phase 12's tokenizer (captions use ids >= 3)

MEL_TOL = 1e-4
# the first FFMA mel kernel at phase 3's shape, chip run 5 of PR 6 (NVIDIA
# H100 80GB HBM3, 700 W): another call's time, printed beside this one's
MEL_EARLIER_MS = 0.3383
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# ||out - ref||_F / ||ref||_F of a flash forward: bf16 rounding of q, p and
# out gives about 3e-3; leaving the 1/(1 - rate) rescale out at rate 0.1
# gives 0.1, and leaving one 64-key tile out of ~7650 keys about 0.09
FLASH_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
FAULT_TILE = (1024, 1088)  # the key tile whose keys a planted fault masks
GRAD_REL_TOL = {"float32": 1e-3, "bfloat16": 3e-2}  # of max|ref|
# ||g - ref||_F / ||ref||_F of each of dq, dk and dv: bf16 rounding of q_s,
# p_v and ds; the faults planted in phase 11 give about 0.1
GRAD_NORM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the f32 kernels, whose results the kernels line keeps under f32_ keys
F32_SOURCE = {"fwd": "aat_tpu_torch/csrc/flash_fwd_tf32x3.cu",
              "bwd": "aat_tpu_torch/csrc/flash_bwd_tf32x3.cu"}
SDPA_BACKEND = {"bfloat16": "FlashAttention", "float32": "memory-efficient"}  # sdpa_ms
ENCODER_REL_TOL = 1e-3
TRAIN_REL_TOL = 1e-3

# the bounds of the kernels line: NVIDIA H100 SXM peaks (data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
# matrix products: f32-accurate ones as three TF32 products (3xTF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
FFMA_FLOPS = 67e12  # f32 outside the tensor cores: mel, which must stay off TF32
# Hopper SM issue rates (16 MUFU and 64 INT32 operations a clock) x 132 SMs
# at the 1.98 GHz boost clock behind the data sheet's f32 rate
MUFU_PER_S = 132 * 16 * 1.98e9
INT32_PER_S = 132 * 64 * 1.98e9
HASH_OPS = 10  # integer operations of the dropout position hash per score
# products of D-long rows per allowed (q, k) pair: the forward's q.k and p.v;
# the backward's q.k, dout.v, then dq (ds.k), dk (ds.q) and dv (p.dout)
PRODUCTS = {"fwd": 2, "bwd": 5, "dq": 3, "dkv": 4}


def optional_packages():
    """The installed version of each package the port reaches only through
    a lazy import (or only its tests use), by name, read without importing."""
    from importlib import metadata

    out = {}
    for name in ("transformers", "tokenizers", "safetensors", "datasets", "wandb", "triton"):
        try:
            out[name] = metadata.version(name)
        except metadata.PackageNotFoundError:
            out[name] = None
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def out_errors(out, ref):
    """``(max|out - ref|, ||out - ref||_F / ||ref||_F)`` in f32. The ratio
    scales with the values: a bound on the largest error alone is as large
    as a typical |out| where a few rows dominate max|ref|."""
    diff = out.float() - ref.float()
    return float(diff.abs().max()), float(diff.norm() / ref.float().norm())


def bound_ms(tensors, op_seconds):
    """``(bound_ms, bound_by)``: the larger of the bytes of ``tensors`` (each
    input read once, each output written once) over HBM's rate and the
    slowest kind of operation, ``op_seconds`` being each kind's count over
    its peak rate."""
    mem_s = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    ops_s = max(op_seconds)
    return max(mem_s, ops_s) * 1e3, "bytes" if mem_s >= ops_s else "operations"


def attention_bound(torch, kind, tensors, q, mask, causal, pack_len, rate):
    """The bound of a flash kernel (``PRODUCTS`` kind) from this run's
    inputs: the allowed (q, k) pairs of ``mask`` and the causal rule, each
    pair costing 2·D flops per product on the tensor cores at q's dtype,
    one exponential, and with dropout one hash."""
    from aat_tpu_torch.ops import attention as att

    b, t, h, d = q.shape
    s = mask.shape[1]
    scores = h * float(att._allowed(mask, t, s, causal, pack_len).expand(b, 1, t, s).sum())
    seconds = [2.0 * d * PRODUCTS[kind] * scores / PEAK_FLOPS[str(q.dtype)[6:]],
               scores / MUFU_PER_S]
    if rate > 0.0:
        seconds.append(HASH_OPS * scores / INT32_PER_S)
    return bound_ms(tensors, seconds)


def sdpa_ms(torch, q, k, v, causal, rate):
    """The yardstick of the flash kernels: one PyTorch call,
    ``scaled_dot_product_attention``, on the same operands (copied to its
    [B, H, T, D] layout, GQA k/v repeated to H heads, no key mask; dropout
    at ``rate``), on its FlashAttention backend in bf16 and its
    memory-efficient one in f32, which the former does not take. Returns its
    forward ms and its backward ms (forward plus backward minus forward).
    The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backend = (SDPBackend.FLASH_ATTENTION if q.dtype == torch.bfloat16
               else SDPBackend.EFFICIENT_ATTENTION)
    h = q.shape[2]
    qh, kh, vh = (x.transpose(1, 2).repeat_interleave(h // x.shape[2], dim=1).contiguous()
                  .requires_grad_(True) for x in (q, k, v))
    g = torch.randn_like(qh)

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=rate, is_causal=causal)

    with sdpa_kernel([backend]):
        fwd_ms = cuda_ms(torch, fwd, iters=10)
        both_ms = cuda_ms(torch, lambda: torch.autograd.grad(fwd(), (qh, kh, vh), g), iters=10)
    return {"fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms}


def ptxas_usage(log):
    """``kernel: N registers, S/L bytes spilled`` for each entry function in
    the ptxas -v output of ``log``, demangled where c++filt exists."""
    import re
    import shutil

    rows, name, spill = [], None, ""
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if found:
            name = found.group(1)
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found:
            spill = f"{found.group(1)}/{found.group(2)} bytes spilled"
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            rows.append((name, f"{found.group(1)} registers, {spill}"))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(short_name(n), u) for n, (_, u) in zip(names, rows)]
    return [f"{n}: {u}" for n, u in rows]


def short_name(kernel):
    """A demangled kernel name without namespace, return type and arguments."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


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
    # the framing's strided view, as the serving path passes it, and a copy
    strided = mel.frame_waveform_ragged(x, lengths)  # [8, 1201, 400]
    check(not strided.is_contiguous(), "the framed view is not strided")
    frames = strided.contiguous()
    got = mel.melspec_kernel(frames)
    got_strided = mel.melspec_kernel(strided)
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
    err64_strided = float((got_strided.double() - exact).abs().max())
    plain_err64 = float((ref.double() - exact).abs().max())
    n_diff = int((got != ref).sum())
    ms = cuda_ms(torch, lambda: mel.melspec_kernel(strided))
    plain_ms = cuda_ms(torch, lambda: mel.melspec_frames_reference(strided))
    one = strided[:1]  # one 12 s request, as serving frames it
    serve_ms = cuda_ms(torch, lambda: mel.melspec_kernel(one))
    print(f"mel: frames {tuple(frames.shape)} max_abs_err {err:.3e} (bound {MEL_TOL}), "
          f"{n_diff} of {got.numel()} values differ; vs f64: kernel {err64:.3e} (strided view "
          f"{err64_strided:.3e}) plain {plain_err64:.3e}; kernel {ms:.4f} ms on the strided view "
          f"(another call, chip run 5 of PR 6: {MEL_EARLIER_MS} ms, the first FFMA version) "
          f"plain {plain_ms:.4f} ms; serving's [1,1201,400] {serve_ms:.4f} ms", flush=True)
    check(err64 <= MEL_TOL and err64_strided <= MEL_TOL,
          f"mel kernel differs from the f64 computation by {err64} ({err64_strided} strided)")
    check(torch.equal(got, got_strided), "mel kernel: the strided view and its copy differ")
    check(bool(torch.isfinite(got).all()), "mel kernel output not finite")
    check(err <= MEL_TOL, f"mel kernel differs from its plain version by {err}")
    # f32 FFMA on the work these inputs need, per frame: the dense DFT
    # (400 x 402), the power, and the nonzero Slaney products (388 of
    # 201 x 64); no single PyTorch call computes a log-mel
    n = frames.numel() // frames.shape[-1]
    flops = n * (2 * 400 * 402 + 3 * 201 + 2 * int((filters != 0).sum()))
    bound = bound_ms((frames, basis.float(), filters.float(), got),
                     [flops / FFMA_FLOPS])
    print(f"mel: {flops / 1e9:.3f} GFLOP, bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def phase_flash(torch, device, rng):
    """The dense forward at serving's shapes, f32 (3xTF32) and bf16, each
    launch through its dtype's C entry, with SDPA's f32 time beside each f32
    case. Returns the f32 result at [1,999,16,64], the shape serving's
    HuBERT runs, for the kernels line."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime.kernels import library

    cases = [((1, 999, 16, 16, 64), "tail"), ((2, 1499, 16, 16, 64), "tail+dead"),
             ((1, 300, 8, 2, 128), "tail")]  # the last: GQA and D=128
    result = None
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
            label = f"[{b},{t},{h}/{kvh},{d}] {dtype_name}"
            before = dict(library().calls)
            got = att.flash_forward_kernel(q, k, v, mask, scale)
            routed(before, dtype_name, f"flash {label}", backward=False)
            ref = att.reference_attention_bthd(q, k, v, mask, scale)
            torch.cuda.synchronize()
            err, rel = out_errors(got, ref)
            ms = cuda_ms(torch, lambda: att.flash_forward_kernel(q, k, v, mask, scale))
            plain_ms = cuda_ms(torch, lambda: att.reference_attention_bthd(q, k, v, mask, scale))
            dead_ok = True
            if "dead" in masking:
                dead_ok = bool((got[b - 1] == 0).all())
            lib = sdpa_ms(torch, q, k, v, False, 0.0) if dtype_name == "float32" else None
            print(f"flash: {label} max_abs_err {err:.3e} (bound {FLASH_TOL[dtype_name]}) "
                  f"norm ratio {rel:.3e} (bound {FLASH_REL_TOL[dtype_name]}) masked_row_zero "
                  f"{dead_ok} kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                  + (f" SDPA (memory-efficient backend, no key mask) {lib['fwd_ms']:.4f} ms"
                     if lib else ""), flush=True)
            check(bool(torch.isfinite(got.float()).all()), "flash output not finite")
            check(err <= FLASH_TOL[dtype_name] and rel <= FLASH_REL_TOL[dtype_name],
                  f"flash kernel differs by {err} (norm ratio {rel})")
            check(dead_ok, "fully masked row is not exactly zero")
            if result is None:
                bound = attention_bound(torch, "fwd", (q, k, v, mask, got), q, mask, False,
                                        None, 0.0)
                result = {"max_abs_err": err, "norm_ratio": rel, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib["fwd_ms"], "bound_ms": bound[0],
                          "bound_by": bound[1]}
                print(f"flash: {label}: bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    return result


def phase_flash_train(torch, device, rng):
    """Forward (out, lse) and backward kernels vs their plain versions at
    the training path's shapes, each case's launches through the C entries
    of its dtype. Returns the results of the main cases for the kernels
    line: bf16, with SDPA's times and the bound, and the f32 results under
    ``f32_`` keys."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime.kernels import library

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
            label = (f"{'causal' if causal else 'dense'} [{b},{t},{h}/{kvh},{d}] {dtype_name}"
                     f"{f' dropout {rate}' if rate else ''}{f' pack {pack_len}' if pack_len else ''}")
            before = dict(library().calls)
            out, lse = fwd(q, k, v, mask, scale, **fkw)
            ref_out, ref_lse = att.flash_forward_reference(q, k, v, mask, scale, **pkw)
            # both backward versions read the plain forward's out and lse
            grads = bwd(q, k, v, mask, ref_out, ref_lse, g, scale, **bkw)
            routed(before, dtype_name, f"flash train {label}")
            ref_grads = att.flash_backward_reference(q, k, v, mask, ref_out, ref_lse, g,
                                                     scale, **pkw)
            torch.cuda.synchronize()
            out_err, out_rel = out_errors(out, ref_out)
            live = ref_lse > -1e29
            lse_err = float((lse - ref_lse)[live].abs().max())
            grad_errs = [float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())
                         for a, r in zip(grads, ref_grads)]
            grad_rel = [out_errors(a, r)[1] for a, r in zip(grads, ref_grads)]
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
            # the out bound scales with the output's size: a bf16 rounding flip
            # is an ulp, 2**-8 of the value, and causal rows near the top
            # average few keys, so |out| reaches 4
            out_bound = FLASH_TOL[dtype_name] * (
                max(1.0, float(ref_out.float().abs().max())) if dtype_name == "bfloat16" else 1.0)
            print(f"flash train: {label} out err {out_err:.3e} (bound {out_bound:.2e}) norm "
                  f"ratio {out_rel:.3e} (bound {FLASH_REL_TOL[dtype_name]}) lse err "
                  f"{lse_err:.3e} (bound {FLASH_TOL[dtype_name]}); dq/dk/dv err/max|ref| "
                  f"{'/'.join(f'{e:.2e}' for e in grad_errs)} (bound {GRAD_REL_TOL[dtype_name]}) "
                  f"norm ratios {'/'.join(f'{e:.2e}' for e in grad_rel)} (bound "
                  f"{GRAD_NORM_TOL[dtype_name]})"
                  f"{' masked_row_zero ' + str(dead_ok) if masking == 'dead' else ''}; "
                  f"fwd {fwd_ms:.4f} ms plain {fwd_plain_ms:.4f} ms, "
                  f"bwd {bwd_ms:.4f} ms plain {bwd_plain_ms:.4f} ms", flush=True)
            check(all(bool(torch.isfinite(x.float()).all()) for x in (out, *grads)),
                  f"flash train {label}: non-finite output or gradient")
            check(out_err <= out_bound and out_rel <= FLASH_REL_TOL[dtype_name]
                  and lse_err <= FLASH_TOL[dtype_name],
                  f"flash train {label}: forward differs by {out_err} (norm ratio {out_rel}, "
                  f"lse {lse_err})")
            check(max(grad_errs) <= GRAD_REL_TOL[dtype_name]
                  and max(grad_rel) <= GRAD_NORM_TOL[dtype_name],
                  f"flash train {label}: gradients differ by {grad_errs} of max|ref| "
                  f"(norm ratios {grad_rel})")
            check(dead_ok, f"flash train {label}: fully masked row not exactly zero")
            if masking == "tail" and d == 64:
                name = "causal" if causal else "dense"
                bwd_err = max(float((a.float() - r.float()).abs().max())
                              for a, r in zip(grads, ref_grads))
                # SDPA on its flash backend in bf16, its memory-efficient one
                # in f32; the bounds at the dtype's matrix rate
                lib = sdpa_ms(torch, q, k, v, causal, rate)
                fwd_bound = attention_bound(torch, "fwd", (q, k, v, mask, out, lse), q, mask,
                                            causal, pack_len, rate)
                bwd_bound = attention_bound(torch, "bwd", (q, k, v, mask, ref_out, ref_lse, g,
                                                           *grads), q, mask, causal, pack_len, rate)
                pre = "f32_" if dtype_name == "float32" else ""
                results.setdefault(f"fwd_{name}", {}).update({
                    f"{pre}max_abs_err": out_err, f"{pre}ms": fwd_ms,
                    f"{pre}plain_ms": fwd_plain_ms, f"{pre}library_ms": lib["fwd_ms"],
                    f"{pre}bound_ms": fwd_bound[0], f"{pre}bound_by": fwd_bound[1]})
                results.setdefault(f"bwd_{name}", {}).update({
                    f"{pre}max_abs_err": bwd_err, f"{pre}norm_ratio": max(grad_rel),
                    f"{pre}ms": bwd_ms, f"{pre}plain_ms": bwd_plain_ms,
                    f"{pre}library_ms": lib["bwd_ms"], f"{pre}bound_ms": bwd_bound[0],
                    f"{pre}bound_by": bwd_bound[1]})
                if pre:
                    results[f"bwd_{name}"]["f32_source"] = F32_SOURCE["bwd"]
                print(f"flash train: {label}: SDPA ({SDPA_BACKEND[dtype_name]} backend, no key "
                      f"mask) fwd {lib['fwd_ms']:.4f} ms bwd {lib['bwd_ms']:.4f} ms; bound fwd "
                      f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}) bwd {bwd_bound[0]:.4f} ms "
                      f"({bwd_bound[1]})", flush=True)
    return results


def phase_keep_mask(torch, device, rng):
    """The tensor-core forwards' dropout keep masks, read directly. With v
    the identity (v[k] = e_k, S = D = 128), out[q, k] is p[q, k] dropped and
    scaled, so out == 0 exactly where key k was dropped for query q. bf16
    and f32, B = 2, T = 300, H = 4, rate 0.5, dense and causal: the zeros
    must equal the plain version's ``_keep_mask`` on every allowed position,
    and every other position must be zero. (A transposed, shifted or
    permuted mask has the same distribution, which the tolerances of the
    other checks cannot see: the 3xTF32 kernel reads P.V's keys in a
    relabelled order, and a hash given the relabelled key passes them all.)"""
    from aat_tpu_torch.ops import attention as att

    b, t, h, s, rate, seed = 2, 300, 4, 128, 0.5, 97531
    q32 = torch.from_numpy(rng.normal(0, 1, (b, t, h, s)).astype(np.float32)).to(device)
    k32 = torch.from_numpy(rng.normal(0, 1, (b, s, h, s)).astype(np.float32)).to(device)
    mask = torch.ones((b, s), dtype=torch.int32, device=device)
    keep = att._keep_mask(seed, b, h, t, s, rate, device)  # [B, H, T, S]
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        q, k = q32.to(dtype), k32.to(dtype)
        v = torch.eye(s, device=device, dtype=dtype)[None, :, None, :].expand(
            b, s, h, s).contiguous()
        for causal in (False, True):
            fwd = att.flash_forward_causal_kernel if causal else att.flash_forward_kernel
            out = fwd(q, k, v, mask, s ** -0.5, dropout_rate=rate, dropout_seed=seed)
            ref = att.reference_attention_bthd(q, k, v, mask, s ** -0.5, causal, rate, seed)
            torch.cuda.synchronize()
            allowed = att._allowed(mask, t, s, causal, None).expand(b, h, t, s)
            kept, ref_kept = ((x != 0).permute(0, 2, 1, 3) for x in (out, ref))
            differ = int((kept != keep)[allowed].sum())
            plain_differ = int((ref_kept != keep)[allowed].sum())
            stray = int(kept[~allowed].sum())
            print(f"keep mask: {'causal' if causal else 'dense'} [{b},{t},{h},{s}] {dtype_name} "
                  f"dropout {rate}, identity v: {int(allowed.sum())} allowed positions, "
                  f"{int(keep[allowed].sum())} kept; kernel zeros differ from _keep_mask at "
                  f"{differ} (plain version {plain_differ}), nonzero outside the allowed "
                  f"positions {stray}", flush=True)
            check(differ == 0 and plain_differ == 0 and stray == 0,
                  f"the {dtype_name} keep mask read through an identity v differs from _keep_mask")
    head_keys_keep_checks(torch, device, ("fwd",))


def dropout_cases(torch, device, dtype):
    """(label, x, shard) of phase 19 in ``dtype``: the training path's
    shapes, a non-contiguous view, a start 6 bytes into its buffer (which
    the 16-byte vectors cannot take), each ``ElementShard`` piece of
    ``tests/test_torch_dropout_tp.py`` (x [8, 19, 12]: row blocks, a time
    slice padded past T = 19, tensor-parallel columns), a 4-D tensor and two
    placed tensors the vectors walk (a time slice with padding, columns of
    2048). Contiguous tensors carry -0, a subnormal and two values that
    overflow when scaled."""
    from aat_tpu_torch.ops.dropout import ElementShard

    gen = torch.Generator(device=device).manual_seed(19)
    planted = torch.tensor([-0.0, 1e-40, 3.3e38, -3.3e38], device=device).to(dtype)

    def gauss(*shape):
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        x.view(-1)[:4] = planted
        return x

    for shape in ((40, 634, 4096), (40, 634, 1024), (1, 8499, 1024)):
        yield f"{list(shape)}", gauss(*shape), None
    yield "[40,634,1024] transposed view", gauss(634, 40, 1024).transpose(0, 1), None
    n = 40 * 634 * 1024
    yield ("[40,634,1024] off 16 bytes", torch.empty(n + 8, dtype=dtype, device=device)[3:3 + n]
           .view(40, 634, 1024).copy_(gauss(40, 634, 1024)), None)
    padded = torch.nn.functional.pad(gauss(8, 19, 12), (0, 0, 0, 1))
    for tp in (2, 4):
        width = 12 // tp
        for rows in (1, 2):
            for time in (False, True):
                for r, block in enumerate(padded.chunk(rows)):
                    for sp in range(2 if time else 1):
                        part = block[:, sp * 10:(sp + 1) * 10] if time else block[:, :19]
                        for c in range(tp):
                            shard = ElementShard(r, (sp * 10, 19) if time else None,
                                                 (c * width, 12))
                            yield (f"tp{tp} rows{rows} {'sp2' if time else 'whole time'} piece "
                                   f"{r},{sp},{c}", part[..., c * width:(c + 1) * width], shard)
    yield "4-D [2,3,5,8]", gauss(2, 3, 5, 8), ElementShard(1, (3, 7), (8, 16))
    yield "[4,320,1024] sp slice past T 634", gauss(4, 320, 1024), ElementShard(1, (320, 634))
    yield "[4,634,2048] tp columns", gauss(4, 634, 2048), ElementShard(1, None, (2048, 4096))


def phase_dropout(torch, device):
    """19. The element dropout's kernel (``csrc/dropout.cu``) against its
    plain version (``ops/dropout.dropout_reference``, the int64 hash) on the
    same CUDA tensors, bit for bit: the forward (``aat_dropout_fwd``) and
    the backward of a Gaussian dy (``aat_dropout_bwd``, the mask
    regenerated from the seed against autograd's backward of the plain
    version), bf16, f32 and f16, seeds -2^31 and 2^31 - 1, rates 0.1 and 0.5, on
    ``dropout_cases``; each launch counted on its C entry. Then each
    entry alone at [40, 634, 4096] bf16 and f32 against its bound (x read
    and y written once, over 3.35 TB/s) and the plain forward; the bf16
    entries must reach 70% of the bound."""
    from aat_tpu_torch.ops import dropout as drop
    from aat_tpu_torch.runtime import kernels

    calls = kernels.library().calls
    gen = torch.Generator(device=device).manual_seed(20)

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    n_cases = differ = 0
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for label, x, shard in dropout_cases(torch, device, dtype):
            dy = torch.randn(x.shape, generator=gen, device=device).to(dtype)
            for seed in (-(2**31), 2**31 - 1):
                for rate in (0.1, 0.5):
                    before = (calls["aat_dropout_fwd"], calls["aat_dropout_bwd"])
                    xk = x.detach().requires_grad_(True)
                    y = drop.dropout(seed, xk, rate, shard)
                    (dx,) = torch.autograd.grad(y, xk, dy)
                    xr = x.detach().requires_grad_(True)
                    y_ref = drop.dropout_reference(seed, xr, rate, shard)
                    (dx_ref,) = torch.autograd.grad(y_ref, xr, dy)
                    ok = (torch.equal(bits(y), bits(y_ref)) and torch.equal(bits(dx), bits(dx_ref))
                          and (calls["aat_dropout_fwd"], calls["aat_dropout_bwd"])
                          == (before[0] + 1, before[1] + 1))
                    n_cases += 1
                    if not ok:
                        differ += 1
                        print(f"dropout kernel: {label} {str(dtype)[6:]} seed {seed} rate "
                              f"{rate}: differs from the plain version (forward equal "
                              f"{torch.equal(bits(y), bits(y_ref))}, backward equal "
                              f"{torch.equal(bits(dx), bits(dx_ref))})", flush=True)
    torch.cuda.synchronize()
    print(f"dropout kernel: {n_cases} cases (bf16, f32 and f16, 2 seeds, 2 rates), forward and "
          f"backward bit for bit equal to the plain version in {n_cases - differ}", flush=True)
    check(differ == 0, f"the dropout kernel differs from its plain version in {differ} cases")

    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((40, 634, 4096), generator=gen, device=device).to(dtype)
        args = drop._kernel_args(12345, x, 0.1, None)
        bound, _ = bound_ms([x, x], [0.0])
        name = str(dtype)[6:]
        for entry in ("aat_dropout_fwd", "aat_dropout_bwd"):
            ms = cuda_ms(torch, lambda: drop._launch(entry, x, args))
            result[f"{name}_{entry[12:]}_ms"] = ms
            result[f"{name}_{entry[12:]}_roofline"] = 100.0 * bound / ms
        result[f"{name}_bound_ms"] = bound
        result[f"{name}_plain_ms"] = cuda_ms(
            torch, lambda: drop.dropout_reference(12345, x, 0.1), iters=5)
    print(f"dropout kernel timing [40,634,4096] dropout 0.1 (ms, % of the bytes bound): "
          f"{json.dumps(result)}", flush=True)
    check(min(result["bfloat16_fwd_roofline"], result["bfloat16_bwd_roofline"]) >= 70.0,
          "the bf16 dropout kernel is under 70% of its bytes bound")
    return result


def phase_backward_keep_mask(torch, device, rng):
    """The tensor-core backward's dropout keep mask, read from each kernel
    through identity operands. bf16 and f32 (3xTF32), B = 2, H = KVH = 4,
    D = 128, rate 0.5, dense and causal, through the S <= 8192 wrappers
    (both kernels):
    - dk/dv: T = D = 128 queries against 300 keys, dout[q] = e_q, so
      dv[k, d] = p_v[d, k]: dv == 0 exactly where key k was dropped for
      query d;
    - dq: 300 queries against S = D = 128 keys, k[j] = v[j] = e_j, out = 0
      (so delta = 0) and dout random, so dq[q, d] =
      sm_scale·round(p·keep·dout/(1 - rate))[q, d]: zero exactly where key
      d was dropped for query q.
    On every allowed position the zeros must equal ``_keep_mask``, the
    plain backward's zeros too, and every other position must be zero. (In
    the dk/dv kernel the hash's row is the fragment's column, and the
    3xTF32 kernels relabel the columns of p and ds: a swapped (q, k), or a
    hash given a relabelled index, passes every tolerance and only this
    check finds it.)"""
    from aat_tpu_torch.ops import attention as att

    b, h, d, n, rate, seed = 2, 4, 128, 300, 0.5, 13579
    scale = d ** -0.5
    for dtype_name, causal in ((x, c) for x in ("bfloat16", "float32") for c in (False, True)):
        dtype = getattr(torch, dtype_name)
        eye = torch.eye(d, device=device, dtype=dtype)[None, :, None, :].expand(
            b, d, h, d).contiguous()

        def gauss(rows):
            return torch.from_numpy(rng.normal(0, 1, (b, rows, h, d)).astype(np.float32)).to(
                device=device, dtype=dtype)

        bwd = att.flash_backward_causal_kernel if causal else att.flash_backward_kernel
        pkw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
        for kernel in ("dk/dv", "dq"):
            if kernel == "dk/dv":
                q, k, v, dout = gauss(d), gauss(n), gauss(n), eye
            else:
                q, k, v, dout = gauss(n), eye, eye, gauss(n)
            t, s = q.shape[1], k.shape[1]
            mask = torch.ones((b, s), dtype=torch.int32, device=device)
            out, lse = att.flash_forward_reference(q, k, v, mask, scale, **pkw)
            if kernel == "dq":
                out = torch.zeros_like(out)
            grads = bwd(q, k, v, mask, out, lse, dout, scale, dropout_rate=rate,
                        dropout_seed=seed)
            ref = att.flash_backward_reference(q, k, v, mask, out, lse, dout, scale, **pkw)
            torch.cuda.synchronize()

            def nonzero(gr):  # [B, H, T, S]: dv [B, S, H, T], dq [B, T, H, S]
                x = gr[2].permute(0, 2, 3, 1) if kernel == "dk/dv" else gr[0].permute(0, 2, 1, 3)
                return x != 0

            kept, ref_kept = nonzero(grads), nonzero(ref)
            keep = att._keep_mask(seed, b, h, t, s, rate, device)
            allowed = att._allowed(mask, t, s, causal, None).expand(b, h, t, s)
            differ = int((kept != keep)[allowed].sum())
            plain_differ = int((ref_kept != keep)[allowed].sum())
            stray = int(kept[~allowed].sum())
            print(f"backward keep mask: {kernel} kernel, {'causal' if causal else 'dense'} "
                  f"[{b},{t},{h},{d}] against {s} keys, {dtype_name} dropout {rate}: "
                  f"{int(allowed.sum())} allowed positions, {int(keep[allowed].sum())} kept; "
                  f"kernel zeros differ from _keep_mask at {differ} (plain version "
                  f"{plain_differ}), nonzero outside the allowed positions {stray}", flush=True)
            check(differ == 0 and plain_differ == 0 and stray == 0,
                  f"the {dtype_name} {kernel} kernel's keep mask read through identity operands "
                  "differs from _keep_mask")
    head_keys_keep_checks(torch, device, ("dq", "dkv"))


# the head-key checks: q-heads over kv heads, launched whole and in two
# halves; their operands' generator (of its own: the later phases draw as
# before)
HEAD_KEYS_LAYOUT = (8, 2)
HEAD_KEYS_SEED = 15
HEAD_KEYS_ENTRIES = {"fwd": ("aat_flash_fwd_mma", "aat_flash_fwd_tf32x3"),
                     "dq": ("aat_flash_bwd_dq_mma", "aat_flash_bwd_dq_tf32x3"),
                     "dkv": ("aat_flash_bwd_dkv_mma", "aat_flash_bwd_dkv_tf32x3")}


def read_keep(torch, route, ops, causal, head_keys, kernel, rate, seed):
    """[B, H, T, S] bool: where a launch (``kernel``) or the plain version
    with ``head_keys`` kept a key, read through identity operands: ``fwd``
    with v = I (S = D), out == 0 where dropped; ``dq`` with k = v = I
    (S = D) and out = 0, dq == 0; ``dkv`` with T = D and dout = I on one
    q-head of each kv group at a time (dv sums the group), dv == 0. Only
    the kernels launch through the C entries; the backward's out and lse
    come from the plain forward."""
    from aat_tpu_torch.ops import attention as att

    q, k, v = ops["q"], ops["k"], ops["v"]
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    scale = d ** -0.5
    mask = torch.ones((b, s), dtype=torch.int32, device=q.device)
    kw = dict(dropout_rate=rate, dropout_seed=seed, head_keys=head_keys)
    if route == "fwd":
        if kernel:
            fwd = att.flash_forward_causal_kernel if causal else att.flash_forward_kernel
            out = fwd(q, k, v, mask, scale, **kw)
        else:
            out = att.reference_attention_bthd(q, k, v, mask, scale, causal, **kw)
        return (out != 0).permute(0, 2, 1, 3)
    out, lse = att.flash_forward_reference(q, k, v, mask, scale, causal, **kw)

    def grads(dout, out):
        if kernel:
            bwd = att.flash_backward_causal_kernel if causal else att.flash_backward_kernel
            return bwd(q, k, v, mask, out, lse, dout, scale, **kw)
        return att.flash_backward_reference(q, k, v, mask, out, lse, dout, scale, causal, **kw)

    if route == "dq":
        return (grads(ops["dout"], torch.zeros_like(out))[0] != 0).permute(0, 2, 1, 3)
    rep = h // kvh
    kept = torch.zeros((b, h, t, s), dtype=torch.bool, device=q.device)
    for r in range(rep):
        dout = torch.zeros_like(q)
        dout[:, :, r::rep] = torch.eye(d, device=q.device, dtype=q.dtype)[None, :, None, :]
        kept[:, r::rep] = (grads(dout, out)[2] != 0).permute(0, 2, 3, 1)
    return kept


def head_keys_keep_checks(torch, device, routes):
    """A tensor-parallel shard's head keys in the kernels: for each of
    ``routes`` (``fwd``, ``dq``, ``dkv``: the six C entries over bf16 and
    f32), dense and causal, D = 64 and 128, B = 2, 8 q-heads over 2 kv
    heads, 300 rows against S = D keys (dk/dv: T = D queries against 300
    keys), rate 0.5: the global launch's keep mask (read by
    :func:`read_keep`) must equal the plain version's, and ``_keep_mask``
    on the allowed positions (zero elsewhere); each half of the heads,
    launched with ``head_keys = (8, 0)`` and ``(8, 4)`` and its kv head,
    must read the global launch's masks of its heads bit for bit, the
    plain version's halves too; and the second half keyed on its own heads
    (the keys a tp shard took before ``head_keys``) must read other
    masks."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime.kernels import library

    h, kvh = HEAD_KEYS_LAYOUT
    b, n, rate, seed = 2, 300, 0.5, 24680
    rng = np.random.default_rng(HEAD_KEYS_SEED)
    calls = library().calls
    before = dict(calls)
    for route, dtype_name in ((r, x) for r in routes for x in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        seen = []
        for d, causal in ((d, c) for d in (64, 128) for c in (False, True)):
            def gauss(*shape):
                return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
                    device=device, dtype=dtype)

            eye = torch.eye(d, device=device, dtype=dtype)[None, :, None, :].expand(
                b, d, kvh, d).contiguous()
            if route == "fwd":
                ops = {"q": gauss(b, n, h, d), "k": gauss(b, d, kvh, d), "v": eye}
            elif route == "dq":
                ops = {"q": gauss(b, n, h, d), "k": eye, "v": eye, "dout": gauss(b, n, h, d)}
            else:
                ops = {"q": gauss(b, d, h, d), "k": gauss(b, n, kvh, d), "v": gauss(b, n, kvh, d)}
            args = (route, ops, causal)
            whole = read_keep(torch, *args, None, True, rate, seed)
            plain = read_keep(torch, *args, None, False, rate, seed)
            t, s = whole.shape[2:]
            allowed = att._allowed(torch.ones((b, s), dtype=torch.int32, device=device), t, s,
                                   causal, None).expand(b, h, t, s)
            keep = att._keep_mask(seed, b, h, t, s, rate, device)
            off_global = (int((whole != plain).sum()) + int((whole[allowed] != keep[allowed]).sum())
                          + int(whole[~allowed].sum()))
            off_half = off_plain = 0
            for part in range(2):
                hs, ks = slice(part * h // 2, (part + 1) * h // 2), slice(part * kvh // 2,
                                                                        (part + 1) * kvh // 2)
                sub = {name: x[:, :, ks if name in ("k", "v") else hs] for name, x in ops.items()}
                head_keys = (h, part * h // 2)
                off_half += int((read_keep(torch, route, sub, causal, head_keys, True, rate, seed)
                                 != whole[:, hs]).sum())
                off_plain += int((read_keep(torch, route, sub, causal, head_keys, False, rate,
                                            seed) != whole[:, hs]).sum())
            local = read_keep(torch, route, sub, causal, None, True, rate, seed)
            off_local = int((local != whole[:, h // 2:]).sum())
            torch.cuda.synchronize()
            seen.append((d, causal, int(allowed.sum()), off_global, off_half, off_plain,
                         off_local))
            check(off_global == 0, f"{route} {dtype_name} D={d} causal={causal}: the global "
                  f"launch's keep mask is off the plain version's at {off_global}")
            check(off_half == 0 and off_plain == 0,
                  f"{route} {dtype_name} D={d} causal={causal}: the half-head launches with head "
                  f"keys differ from the global launch's heads at {off_half} (plain {off_plain})")
            check(off_local > 0, f"{route} {dtype_name} D={d} causal={causal}: a half keyed on "
                  "its own heads reads the global masks, so the check cannot see local keys")
        print(f"head keys: {route} {dtype_name} [{b},{n},{h}/{kvh} heads], rate {rate}, halves "
              f"(8, 0) and (8, 4): (D, causal, allowed positions, global off plain and "
              f"_keep_mask, halves off the global launch, plain halves off, own-head keys off) "
              f"{seen}", flush=True)
    for route in routes:
        for entry in HEAD_KEYS_ENTRIES[route]:
            check(calls[entry] > before[entry], f"the head-key checks never launched {entry}")


# rows 2-7 of PERF.md's kernel table at the main path's bf16 shapes:
# (launch, [B, T, H, KVH, D], causal, dropout rate), and their operands'
# generator
AB_SEED = 16
# pointers before B of each flash C entry (the forward's out and lse; the
# backward's out, dout, lse and its outputs)
AB_HEADS = {"aat_flash_fwd_mma": 6, "aat_flash_fwd_tf32x3": 6, "aat_flash_bwd_dq_mma": 8,
            "aat_flash_bwd_dq_tf32x3": 8, "aat_flash_bwd_dkv_mma": 10,
            "aat_flash_bwd_dkv_tf32x3": 10}
AB_ROWS = {2: ("fwd", (1, 8499, 16, 16, 64), False, 0.1),
           3: ("fwd", (1, 8540, 16, 16, 128), True, 0.0),
           4: ("bwd", (2, 999, 16, 16, 64), False, 0.1),
           5: ("bwd", (2, 1050, 9, 3, 64), True, 0.0),
           6: ("dq", (1, 8499, 16, 16, 64), False, 0.1),
           7: ("dkv", (1, 8499, 16, 16, 64), False, 0.1)}


def ab_flash_entries(torch, device, others, rounds=3, iters=20):
    """Not run by ``main``: the bf16 flash C entries of this checkout's
    build against builds of other ``csrc/`` directories (``others``:
    label → directory; one whose ``flash_fwd_mma.cu`` has no
    ``head_offset`` is taken to lack the two head-key arguments, one with no
    ``int DV`` the value width after D), timed in
    turns (every build, then every build in reverse order) ``rounds``
    times at ``AB_ROWS``' shapes with the wrappers' own arguments, on the
    same operands. Returns ``{row: {label: ms}}`` (``"this"`` for this
    checkout), each a list of ``2 · rounds`` means over ``iters`` launches
    (CUDA events)."""
    import ctypes

    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime import kernels

    libs = {"this": (kernels.library()._lib, True, True)}
    for label, csrc in others.items():
        sources = sorted(os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cu"))
        path = os.path.join(kernels.BUILD_DIR, f"libaat_kernels_ab_{label}.so")
        kernels._build(path, sources)
        with open(os.path.join(csrc, "flash_fwd_mma.cu")) as f:
            text = f.read()
        keys, widths = "head_offset" in text, "int DV" in text
        lib = ctypes.CDLL(path)
        for name, argtypes in kernels._SIGNATURES.items():
            if name.startswith("aat_flash"):
                at = AB_HEADS[name] + 6  # DV follows B, T, S, H, KVH, D
                argtypes = argtypes if widths else argtypes[:at] + argtypes[at + 1:]
                argtypes = argtypes if keys else argtypes[:-3] + argtypes[-1:]
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[label] = (lib, keys, widths)
    order = list(libs) + list(libs)[::-1]
    rng = np.random.default_rng(AB_SEED)
    results = {}
    for row, (kind, (b, t, h, kvh, d), causal, rate) in AB_ROWS.items():
        def gauss(*shape):
            return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)

        q, k, v, dout = (gauss(b, t, n, d) for n in (h, kvh, kvh, h))
        mask = torch.ones((b, t), dtype=torch.int32, device=device)
        scale = d ** -0.5
        fwd = att.flash_forward_causal_kernel if causal else att.flash_forward_kernel
        out, lse = fwd(q, k, v, mask, scale, dropout_rate=rate, dropout_seed=7, need_lse=True)
        tail = att._backward_args(q, k, v, scale, causal, rate, 7, None, None)
        dq = torch.empty_like(q)
        dk, dv = (torch.empty((b, t, h, d), dtype=torch.float32, device=device) for _ in range(2))
        delta = torch.empty((b, h, t), dtype=torch.float32, device=device)
        ptr = [x.data_ptr() for x in (q, k, v, mask)]
        grad_in = [out.data_ptr(), dout.data_ptr(), lse.data_ptr()]
        calls = {"fwd": [("aat_flash_fwd_mma", ptr + [out.data_ptr(), lse.data_ptr()])],
                 "dq": [("aat_flash_bwd_dq_mma", ptr + grad_in + [dq.data_ptr()])],
                 "dkv": [("aat_flash_bwd_dkv_mma", ptr + grad_in + [
                     dk.data_ptr(), dv.data_ptr(), delta.data_ptr()])]}
        calls["bwd"] = calls["dq"] + calls["dkv"]

        def run(lib, keys, widths):
            def go():
                for name, head in calls[kind]:
                    args = list(tail if widths else tail[:6] + tail[7:])
                    args = head + (args if keys else args[:-2])
                    err = getattr(lib, name)(*args, kernels.stream_handle(device))
                    check(err == 0, f"{name}: CUDA error {err}")
            return go

        times = {label: [] for label in libs}
        with torch.cuda.device(device):
            for _ in range(rounds):
                for label in order:
                    times[label].append(cuda_ms(torch, run(*libs[label]), iters, 2))
        results[row] = times
        del q, k, v, dout, out, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    return results


# (B, T, H), causal, of phase 20: DeepSeek-V2-Lite's 16 heads at the
# long-form LM's length (the split backward) and at a short one (fused)
MLA_CASES = ((1, 8540, 16), (2, 999, 16))
MLA_WIDTHS = (192, 128)
MLA_FWD_RATIO = 1.6  # the (192, 128) forward's time over the (128, 128) one's, at most


def mla_bound(torch, kind, tensors, q, v, mask):
    """The bound of a (DQK, DV) causal flash kernel: each allowed pair costs
    2·DQK flops a q·k-type product (q·k, ds·k, ds·q) and 2·DV a v-type one
    (dout·v, p·v, p·dout), one exponential; bytes as ``bound_ms``."""
    from aat_tpu_torch.ops import attention as att

    b, t, h, dqk = q.shape
    dv = v.shape[-1]
    pairs = h * float(att._allowed(mask, t, t, True, None).expand(b, 1, t, t).sum())
    flops = {"fwd": dqk + dv, "bwd": 3 * dqk + 2 * dv, "dq": 2 * dqk + dv,
             "dkv": 2 * dqk + 2 * dv}[kind]
    return bound_ms(tensors, [2.0 * flops * pairs / PEAK_FLOPS["bfloat16"], pairs / MUFU_PER_S])


def phase_mla_kernels(torch, device, rng):
    """Phase 20: the (192, 128) bf16 causal kernels against their plain
    versions (``MLA_CASES``), through the ``*_mma`` C entries, timed beside
    the (128, 128) causal kernels at the same shapes. Returns ``{case:
    {kind: {...}}}``."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime.kernels import library

    dqk, dv = MLA_WIDTHS
    results = {}
    for b, t, h in MLA_CASES:
        def gauss(width, dtype=torch.bfloat16):
            return torch.from_numpy(rng.normal(0, 1, (b, t, h, width)).astype(np.float32)).to(
                device=device, dtype=dtype)

        q, k, v, g = gauss(dqk), gauss(dqk), gauss(dv), gauss(dv)
        mask = torch.ones((b, t), dtype=torch.int32, device=device)
        mask[:, t - t // 10:] = 0
        scale = dqk ** -0.5
        split = t > att.FUSED_BWD_MAX_S
        kw = dict(causal=True, dropout_rate=0.0, dropout_seed=0)

        def plain(fn, residuals=None, q=q, k=k, v=v):
            if b == 1:
                return plain_by_heads(torch, fn, q, k, v, mask, residuals, scale, kw)
            return fn(q, k, v, mask, *(residuals or ()), scale, **kw)

        def backward(out, lse):
            args = (q, k, v, mask, out, lse, g, scale)
            if split:
                return (att.flash_backward_dq_long(*args, causal=True),
                        *att.flash_backward_dkv_long(*args, causal=True))
            return att.flash_backward_causal_kernel(*args)

        label = f"[{b},{t},{h},{dqk}/{dv}] causal bf16 ({'split' if split else 'fused'} backward)"
        before = dict(library().calls)
        out, lse = att.flash_forward_causal_kernel(q, k, v, mask, scale, need_lse=True)
        ref_out, ref_lse = plain(att.flash_forward_reference)
        grads = backward(ref_out, ref_lse)
        routed(before, "bfloat16", f"latent attention {label}")
        check(out.shape == (b, t, h, dv) and grads[2].shape == v.shape
              and grads[0].shape == q.shape and grads[1].shape == k.shape,
              f"latent attention {label}: output widths")
        refs = (plain(att.flash_backward_dq_reference, (ref_out, ref_lse, g)),
                *plain(att.flash_backward_dkv_reference, (ref_out, ref_lse, g)))
        torch.cuda.synchronize()
        out_err, out_rel = out_errors(out, ref_out)
        live = ref_lse > -1e29
        lse_err = float((lse - ref_lse)[live].abs().max())
        out_bound = FLASH_TOL["bfloat16"] * max(1.0, float(ref_out.float().abs().max()))
        rel = [float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())
               for a, r in zip(grads, refs)]
        grad_rel = [out_errors(a, r)[1] for a, r in zip(grads, refs)]
        fwd_ms = cuda_ms(torch, lambda: att.flash_forward_causal_kernel(
            q, k, v, mask, scale, need_lse=True), iters=20, warmup=2)
        bwd_ms = cuda_ms(torch, lambda: backward(ref_out, ref_lse), iters=10, warmup=2)
        fwd_plain_ms = cuda_ms(torch, lambda: plain(att.flash_forward_reference), iters=2,
                               warmup=1)
        bounds = {"fwd": mla_bound(torch, "fwd", (q, k, v, mask, out, lse), q, v, mask),
                  "bwd": mla_bound(torch, "dq" if split else "bwd",
                                   (q, k, v, mask, ref_out, ref_lse, g) + tuple(grads), q, v,
                                   mask)}
        if split:
            bounds["bwd"] = (bounds["bwd"][0] + mla_bound(torch, "dkv", (), q, v, mask)[0],
                             bounds["bwd"][1])
        # the (128, 128) causal kernels at the same shapes, in this call
        q2, k2, v2 = gauss(128), gauss(128), gauss(128)
        out2, lse2 = att.flash_forward_causal_kernel(q2, k2, v2, mask, 128 ** -0.5,
                                                     need_lse=True)
        fwd128_ms = cuda_ms(torch, lambda: att.flash_forward_causal_kernel(
            q2, k2, v2, mask, 128 ** -0.5, need_lse=True), iters=20, warmup=2)
        args2 = (q2, k2, v2, mask, out2, lse2, g, 128 ** -0.5)
        bwd128_ms = cuda_ms(torch, lambda: (
            (att.flash_backward_dq_long(*args2, causal=True),
             att.flash_backward_dkv_long(*args2, causal=True)) if split
            else att.flash_backward_causal_kernel(*args2)), iters=10, warmup=2)
        ratio = fwd_ms / fwd128_ms
        print(f"latent attention: {label} fwd out err {out_err:.3e} (bound {out_bound:.2e}) "
              f"norm ratio {out_rel:.3e} (bound {FLASH_REL_TOL['bfloat16']}) lse err "
              f"{lse_err:.3e} (bound {FLASH_TOL['bfloat16']}); bwd dq/dk/dv err/max|ref| "
              f"{'/'.join(f'{e:.2e}' for e in rel)} (bound {GRAD_REL_TOL['bfloat16']}) norm "
              f"ratios {'/'.join(f'{e:.2e}' for e in grad_rel)} (bound "
              f"{GRAD_NORM_TOL['bfloat16']}); fwd {fwd_ms:.4f} ms (bound {bounds['fwd'][0]:.4f} "
              f"ms, {bounds['fwd'][1]}; plain {fwd_plain_ms:.4f} ms), bwd {bwd_ms:.4f} ms "
              f"(bound {bounds['bwd'][0]:.4f} ms); (128, 128) at the same T: fwd "
              f"{fwd128_ms:.4f} ms, bwd {bwd128_ms:.4f} ms; fwd ratio {ratio:.3f} (at most "
              f"{MLA_FWD_RATIO})", flush=True)
        check(all(bool(torch.isfinite(x.float()).all()) for x in (out, *grads)),
              f"latent attention {label}: non-finite output or gradient")
        check(out_err <= out_bound and out_rel <= FLASH_REL_TOL["bfloat16"]
              and lse_err <= FLASH_TOL["bfloat16"],
              f"latent attention {label}: forward differs by {out_err} (norm ratio {out_rel}, "
              f"lse {lse_err})")
        check(max(rel) <= GRAD_REL_TOL["bfloat16"]
              and max(grad_rel) <= GRAD_NORM_TOL["bfloat16"],
              f"latent attention {label}: gradients differ by {rel} (norm ratios {grad_rel})")
        check(ratio <= MLA_FWD_RATIO, f"latent attention {label}: forward {ratio:.3f}x the "
              f"(128, 128) kernel's")
        results[label] = {"fwd": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                                  "bound_ms": bounds["fwd"][0], "ms_128": fwd128_ms,
                                  "max_abs_err": out_err, "norm_ratio": out_rel},
                          "bwd": {"ms": bwd_ms, "bound_ms": bounds["bwd"][0],
                                  "ms_128": bwd128_ms, "norm_ratio": max(grad_rel)}}
        del q, k, v, g, out, lse, ref_out, ref_lse, grads, refs, q2, k2, v2, out2, lse2
        torch.cuda.empty_cache()
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


def reset_entry_calls():
    """Zero the kernel library's launch counts by C entry; returns them."""
    from aat_tpu_torch.runtime.kernels import library

    calls = library().calls
    for name in calls:
        calls[name] = 0
    return calls


# the flash kernels' C entries by dtype: forward, dq, dk/dv
FLASH_ENTRIES = {"bfloat16": ("aat_flash_fwd_mma", "aat_flash_bwd_dq_mma", "aat_flash_bwd_dkv_mma"),
                 "float32": ("aat_flash_fwd_tf32x3", "aat_flash_bwd_dq_tf32x3",
                             "aat_flash_bwd_dkv_tf32x3")}


def flash_entry_calls(calls, path, dtype_name, backward=True):
    """A path's flash launches all went through the C entries of its dtype
    (``FLASH_ENTRIES``: the tensor-core kernels, bf16 or 3xTF32), the
    backward's too unless ``backward``
    is False (serving), and
    none through the other dtype's. Returns a copy of the path's launches by
    C entry."""
    entries = [e for names in FLASH_ENTRIES.values() for e in names]
    want = FLASH_ENTRIES[dtype_name][:3 if backward else 1]
    print(f"{path}: flash launches by C entry: "
          + ", ".join(f"{e} {calls[e]}" for e in entries), flush=True)
    check(all((calls[e] > 0) == (e in want) for e in entries),
          f"{path}: the flash launches did not all go through {want}")
    return dict(calls)


def routed(before, dtype_name, label, backward=True):
    """The flash launches since the copy ``before`` of the library's counts
    went through each C entry of ``dtype_name`` (only its forward's unless
    ``backward``) and no other."""
    from aat_tpu_torch.runtime.kernels import library

    calls = library().calls
    moved = {e for e in calls if calls[e] != before.get(e, 0)}
    want = FLASH_ENTRIES[dtype_name][:3 if backward else 1]
    check(moved == set(want), f"{label}: launches went through {sorted(moved)}, not {want}")


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


def phase_training(torch, model, params, rng, smi_line):
    """3 optimizer steps at full width through the kernels, then one f32
    gradient step through the kernel and plain routes. Returns the launch
    counts of the 3 steps by wrapper and by C entry."""
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
    calls = reset_entry_calls()
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
    entry_calls = flash_entry_calls(calls, "training", "bfloat16")
    del lm_before, before
    print_mfu("phase 8 (whole-utterance, SmolLM-135M)", model, cfg, batches[-1], walls[-1],
              smi_line)

    profile_training_step(torch, trainer, batches[-1])

    # one f32 gradient step, kernel route vs plain route, same seeds
    plain_model = AslmModel(
        model.config, dataclasses.replace(model.audio_encoder_config, attention_impl="xla"),
        dataclasses.replace(model.lm_config, attention_impl="xla"))
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    routes = {}
    calls = reset_entry_calls()
    for label, m in (("kernel", model), ("plain", plain_model)):
        t = AATTrainer(m, params, f32)
        grads, metrics, _ = t._grad_step(params, batches[0][0], t.dropout_seed(0, 0))
        routes[label] = (metrics["train/loss"].item(), optim.global_norm(grads).item(),
                         grads["audio_encoder"]["feature_projection"]["projection"]["kernel"])
        del t, grads
        torch.cuda.empty_cache()
    flash_entry_calls(calls, "training f32 step", "float32")
    (loss_k, norm_k, fp_k), (loss_p, norm_p, fp_p) = routes["kernel"], routes["plain"]
    fp_err = float((fp_k - fp_p).abs().max())
    fp_scale = float(fp_p.abs().max())
    print(f"train f32 routes: loss kernel {loss_k:.6f} plain {loss_p:.6f}; grad norm kernel "
          f"{norm_k:.6e} plain {norm_p:.6e}; feature_projection grad max err {fp_err:.3e} "
          f"(max|ref| {fp_scale:.3e})", flush=True)
    check(abs(loss_k - loss_p) <= TRAIN_REL_TOL * abs(loss_p), "f32 loss differs between routes")
    check(abs(norm_k - norm_p) <= TRAIN_REL_TOL * norm_p, "f32 grad norm differs between routes")
    check(fp_err <= TRAIN_REL_TOL * fp_scale, "f32 feature_projection grads differ between routes")
    return launches, entry_calls


def profile_training_step(torch, trainer, micro, name="train"):
    """One torch.profiler pass over a warm training step: device busy time
    (the union of kernel intervals), the idle share of the step's wall, and
    device time by kernel, to ``<name>_profile.txt`` in the kernels' build
    directory. The dropout kernel's forward launches must equal the step's
    ``ops.dropout`` spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aat_tpu_torch.runtime.kernels import BUILD_DIR, library
    from aat_tpu_torch.utils import timing

    path = os.path.join(BUILD_DIR, f"{name}_profile.txt")
    calls = library().calls

    def dropout_counts():
        return (calls["aat_dropout_fwd"], calls["aat_dropout_bwd"],
                timing.counters().get("span.ops.dropout.calls", 0))

    torch.cuda.synchronize()
    before = dropout_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        trainer.training_step(micro)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    fwd, bwd, spans = (a - b for a, b in zip(dropout_counts(), before))
    print(f"profile: {name} dropout kernel launches {fwd} forward, {bwd} backward; "
          f"{spans} ops.dropout spans", flush=True)
    check(fwd == spans, f"{name}: {fwd} dropout forward launches against {spans} spans")
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
    for kind, tag in (("forward", "flash_fwd"), ("backward", "flash_bwd")):
        found = {short_name(kernel): v for kernel, v in by_name.items() if tag in kernel}
        print(f"profile: {name} {kind} kernels {sum(t for t, _ in found.values()) / 1e6:.4f} s "
              f"device time: " + "; ".join(f"{kernel} {t / 1e3:.3f} ms, {c} launches"
                                           for kernel, (t, c) in sorted(found.items())),
              flush=True)


class WordIds:
    """Decode-only tokenizer of phase 12 (the card's machine has no
    tokenizer files): id i → the word ``w<i>``; pad (0) and eos skipped as
    special tokens."""

    eos_token_id = EVAL_EOS

    def batch_decode(self, ids, skip_special_tokens=True):
        special = (0, self.eos_token_id) if skip_special_tokens else ()
        return [" ".join(f"w{int(i)}" for i in row if int(i) not in special)
                for row in np.asarray(ids)]


def trainer_state(torch, trainer, clone=False):
    """``(step, {name: tensor})`` of every tensor of a trainer's state:
    params, the moments and the optimizer's counts."""
    from aat_tpu_torch.training.checkpoint import flatten

    s = trainer.state
    flat = {f"params.{k}": v for k, v in flatten(s.params).items()}
    flat.update({f"mu.{k}": v for k, v in flatten(s.opt_state.mu).items()})
    flat.update({f"nu.{k}": v for k, v in flatten(s.opt_state.nu).items()})
    flat.update(count=s.opt_state.count, total_notfinite=s.opt_state.total_notfinite)
    return s.step, ({k: v.detach().clone() for k, v in flat.items()} if clone else flat)


def assert_state_equal(torch, label, trainer, want, prefixes=("params.", "mu.", "nu.", "count",
                                                               "total_notfinite")):
    """The trainer's state equals the copy ``want`` bit for bit, on the
    names with the given prefixes; otherwise the differing names and their
    largest differences are printed, and the check fails."""
    step, got = trainer_state(torch, trainer)
    names = [k for k in want[1] if k.startswith(prefixes)]
    differ = [k for k in names if k not in got or not torch.equal(got[k], want[1][k])]
    for k in differ[:8]:
        d = (got[k].double() - want[1][k].double()).abs().max().item() if k in got else None
        print(f"{label}: {k} differs (max abs {d})", flush=True)
    check(not differ, f"{label}: {len(differ)} of {len(names)} tensors differ")
    return step, len(names)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def eval_batches(torch, device, rng, n):
    """``n`` batches of 2 whole utterances (phase 8's ``training_batches``)
    with a text prefix: each caption's first two ids."""
    out = []
    for (b,) in training_batches(torch, device, rng, n_steps=n, accum=1):
        ids = b["input_ids"]
        out.append({**b, "prefix_input_ids": ids[:, :2],
                    "prefix_attention_mask": torch.ones_like(ids[:, :2])})
    return out


def beam_choices(run):
    """``run()``'s result, and each of its beam search's top-k selections in
    call order (per step: the 2K candidates, the pool merge, the running
    beams): the scores ranked and the indices picked."""
    from aat_tpu_torch.training import generate

    real, calls = generate.top_k_lowest_first, []

    def record(x, k):
        values, idx = real(x, k)
        calls.append((x.clone(), idx.clone()))
        return values, idx

    generate.top_k_lowest_first = record
    try:
        return run(), calls
    finally:
        generate.top_k_lowest_first = real


def first_split(kernel_calls, plain_calls, row):
    """The first beam selection where the two routes pick differently for
    ``row``: (step, which selection, the plain route's score of its own pick
    minus its score of the kernel route's pick, the phase-9 near-tie margin
    1e-4 * max(1, |score|)), or None where every selection agrees."""
    which = ("candidates", "pool merge", "running beams")
    for i, ((_, got), (scores, want)) in enumerate(zip(kernel_calls, plain_calls)):
        differ = (got[row] != want[row]).nonzero()
        if len(differ):
            j = int(differ[0])
            best = float(scores[row, want[row, j]])
            gap = best - float(scores[row, got[row, j]])
            return i // 3, which[i % 3], gap, 1e-4 * max(1.0, abs(best))
    return None


def phase_checkpoint(torch, model, params, rng, smi_line):
    """12. train → evaluate → save → resume → finalize at full width (phase
    8's model and weights), in a temporary directory under the build
    directory, with cuDNN's deterministic algorithms (the conv backward's
    may sum in a varying order, and the resumed run must equal the
    uninterrupted one bit for bit). Returns the path's launches by wrapper
    and by C entry: the bf16 part (training steps, eval loss) and the
    generation prefix's f32 part."""
    import shutil
    import tempfile

    from aat_tpu_torch.runtime.kernels import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=BUILD_DIR)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return checkpoint_path(torch, model, params, rng, smi_line, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_path(torch, model, params, rng, smi_line, tmp):
    import shutil

    from aat_tpu_torch.models.aslm import AslmModel
    from aat_tpu_torch.models.build import build_model
    from aat_tpu_torch.runtime.kernels import library
    from aat_tpu_torch.training.checkpoint import flatten
    from aat_tpu_torch.training.config import projection_training_config
    from aat_tpu_torch.training.metrics import ComputeMetrics
    from aat_tpu_torch.training.trainer import AATTrainer, read_checkpoint_meta

    device = params["lm_decoder"]["embed_tokens"]["embedding"].device
    # the larger eval loss counts as best, so that finalize rolls back for
    # real: on these seeds the loss falls and the best is checkpoint-2
    cfg = dataclasses.replace(projection_training_config(), per_device_train_batch_size=2,
                              gradient_accumulation_steps=1, eval_steps=2, save_steps=2,
                              max_steps=4, logging_steps=1, greater_is_better=True,
                              output_dir=os.path.join(tmp, "a"))
    train = [micro[0] for micro in training_batches(torch, device, rng, n_steps=4, accum=1)]
    evals = eval_batches(torch, device, rng, 2)
    tokenizer = WordIds()
    logged = []
    ta = AATTrainer(model, params, cfg, compute_metrics=ComputeMetrics(tokenizer),
                    log_fn=logged.append, tokenizer=tokenizer)
    wrappers = kernel_wrappers()
    walls = {"eval": [], "generate": [], "tokens": [], "save": [], "bytes": [], "restore": []}
    snaps = {}
    prefix_launches = dict.fromkeys(wrappers, 0)
    prefix_calls = dict.fromkeys(library().calls, 0)

    def timed(trainer, name, after):
        real = getattr(trainer, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            after(time.perf_counter() - start, out)
            return out

        setattr(trainer, name, run)

    def prefix_routed(trainer):
        real = trainer._prefix_inputs

        def run(*args, **kw):
            calls = dict(library().calls)
            launches = {n: w.launches for n, w in wrappers.items()}
            out = real(*args, **kw)
            routed(calls, "float32", "generation prefix", backward=False)
            for n, w in wrappers.items():
                prefix_launches[n] += w.launches - launches[n]
            for e, c in library().calls.items():
                prefix_calls[e] += c - calls[e]
            return out

        trainer._prefix_inputs = run

    def saved(seconds, path):
        walls["save"].append(seconds)
        walls["bytes"].append(dir_bytes(path))
        snaps[ta.state.step] = trainer_state(torch, ta, clone=True)

    def generated(seconds, ids):
        walls["generate"].append(seconds)
        walls["tokens"].append(ids.shape[0] * ids.shape[1])

    timed(ta, "evaluate", lambda seconds, out: walls["eval"].append(seconds))
    timed(ta, "generate_for_batch", generated)
    timed(ta, "save_checkpoint", saved)
    prefix_routed(ta)

    for w in wrappers.values():
        w.launches = 0
    calls = reset_entry_calls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    ta.train(train, eval_batches=lambda: evals)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - start
    losses = [m["train/loss"] for m in logged if "train/loss" in m]
    eval_logs = [m for m in logged if "eval/loss" in m]
    ckpts = sorted(os.listdir(cfg.output_dir))
    metas = {c: read_checkpoint_meta(os.path.join(cfg.output_dir, c)) for c in ckpts}
    print(f"checkpoint path, run A: 4 steps of 2 utterances, eval and save every 2, wall "
          f"{a_s:.3f} s; losses {[round(x, 5) for x in losses]}; evals "
          + "; ".join(f"eval/loss {m['eval/loss']:.5f} wer {m['wer']:.4f} bleu "
                      f"{m['evaluate_bleu']:.4f} meteor {m['evaluate_meteor']:.4f}"
                      for m in eval_logs) + f"; checkpoints {ckpts}, metas {metas}", flush=True)
    check(ta.state.step == 4 and len(losses) == 4 and all(np.isfinite(losses)),
          f"run A: step {ta.state.step}, losses {losses}")
    check(ckpts == ["checkpoint-2", "checkpoint-4"], f"run A wrote {ckpts}")
    check(all(metas[c]["step"] == int(c.split("-")[1]) and "eval/loss" in metas[c]
              for c in ckpts), f"trainer_meta.json {metas}")
    metric_keys = ("wer", "evaluate_bleu", "evaluate_rouge1", "evaluate_rouge2", "evaluate_rougeL",
                   "evaluate_rougeLsum", "evaluate_meteor")
    check(len(eval_logs) == 2 and all(np.isfinite(m["eval/loss"])
                                      and all(k in m for k in metric_keys) for m in eval_logs),
          f"run A's evals {eval_logs}")
    max_new = int(-(-evals[0]["input_ids"].shape[1] // 16) * 16)

    # finalize: checkpoint-2's weights, the step-4 step and moments
    best = ta._best_checkpoint
    check(os.path.basename(best) == "checkpoint-2",
          f"the best checkpoint is {best}: finalize would not roll back")
    ta.finalize()
    check(ta.state.step == 4, "finalize moved the step")
    assert_state_equal(torch, "finalize weights", ta, snaps[2], ("params.",))
    _, now = trainer_state(torch, ta)
    check(any(not torch.equal(now[k], v) for k, v in snaps[4][1].items()
              if k.startswith("params.")), "checkpoint-2's weights equal step 4's")
    assert_state_equal(torch, "finalize moments", ta, snaps[4], ("mu.", "nu.", "count",
                                                                  "total_notfinite"))

    # export round trip, into run B's fresh build
    export = ta.save_pretrained(os.path.join(tmp, "export"))
    start = time.perf_counter()
    model_b, params_b = build_model(cfg, pretrained=False, from_pretrained_adapter=export,
                                    device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    adapter = flatten(ta.state.params["adapter"])
    check(all(torch.equal(v, adapter[k]) for k, v in flatten(params_b["adapter"]).items())
          and len(adapter) == len(flatten(params_b["adapter"])),
          "the exported adapter did not come back bit for bit")

    # run B: a fresh trainer resumes from checkpoint-2
    tb = AATTrainer(model_b, params_b, dataclasses.replace(
        cfg, output_dir=os.path.join(tmp, "b"), save_steps=0), log_fn=lambda m: None)
    del params_b
    consumed = []
    real_step = tb.training_step

    def resumed_step(micro, **kw):
        if not consumed:  # the restored state, before the first resumed step
            assert_state_equal(torch, "restored state", tb, snaps[2])
            check(tb.state.step == 2, f"restored step {tb.state.step}")
        consumed.append([id(m) for m in micro])
        return real_step(micro, **kw)

    tb.training_step = resumed_step
    timed(tb, "restore_checkpoint", lambda s, out: walls["restore"].append(s))
    tb.train(train, resume_from_checkpoint=os.path.join(cfg.output_dir, "checkpoint-2"))
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    calls = dict(calls)
    check(consumed == [[id(train[2])], [id(train[3])]],
          "the fast-forward did not skip exactly the step 1-2 microbatches")
    step, n = assert_state_equal(torch, "resumed run", tb, snaps[4])
    check(step == 4, f"resumed run ended at step {step}")
    print(f"checkpoint path, run B: resumed from checkpoint-2 in a fresh trainer (fresh build "
          f"with the exported adapter, equal bit for bit), skipped 2 microbatches; restored state "
          f"and step-4 state equal to run A's bit for bit ({n} tensors: params, mu, nu, count, "
          f"total_notfinite); finalize kept step 4 and the step-4 moments, weights of "
          f"{os.path.basename(best)}; build_model with the adapter {build_s:.1f} s", flush=True)

    bf16_launches = {k: launches[k] - prefix_launches[k] for k in launches}
    bf16_calls = {e: calls[e] - prefix_calls[e] for e in calls}
    print(f"checkpoint path launches: training and eval loss {bf16_launches}; generation prefix "
          f"{prefix_launches}", flush=True)
    flash_entry_calls(bf16_calls, "checkpoint path (training, eval loss)", "bfloat16")
    flash_entry_calls(prefix_calls, "checkpoint path (generation prefix)", "float32",
                      backward=False)
    for name in TRAIN_KERNELS:
        check(bf16_launches[name] > 0, f"the checkpoint path never launched {name}")
    check(prefix_launches["flash_fwd"] > 0, "the generation prefix never launched flash_fwd")

    # generation, kernel route against plain route, on A's weights after
    # finalize; where the ids differ, the routes' first differing beam
    # selection must be a near tie in the plain route's own scores
    for name in ("evaluate", "generate_for_batch", "save_checkpoint", "_prefix_inputs"):
        delattr(ta, name)  # the trainer's own methods again
    plain_model = AslmModel(
        model.config, dataclasses.replace(model.audio_encoder_config, attention_impl="xla"),
        dataclasses.replace(model.lm_config, attention_impl="xla"))
    near, rows, splits = 0, 0, []
    for b in evals:
        got, kernel_calls = beam_choices(lambda: ta.generate_for_batch(b))
        ta.model = plain_model
        try:
            want, plain_calls = beam_choices(lambda: ta.generate_for_batch(b))
        finally:
            ta.model = model
        for r in range(got.shape[0]):
            rows += 1
            if np.array_equal(got[r], want[r]):
                continue
            split = first_split(kernel_calls, plain_calls, r)
            check(split is not None, "generation: the ids differ but no beam selection does")
            splits.append(split)
            near += 1
            step, which, gap, margin = split
            check(gap < margin, f"generation: kernel and plain ids differ; the routes first "
                                f"part at step {step}'s {which}, where the plain route's gap "
                                f"is {gap}, above {margin}")
    print(f"generation kernel vs plain route: {rows - near} of {rows} rows equal, {near} near-tie "
          f"rows (first differing beam selection: step, selection, gap, margin: {splits})",
          flush=True)

    tokens, gen_s = sum(walls["tokens"]), sum(walls["generate"])
    print(f"checkpoint path numbers ({smi_line}): eval walls {[round(x, 3) for x in walls['eval']]} "
          f"s (2 batches of 2 utterances, loss and beam-3 generation of "
          f"{max_new} tokens); generation {tokens} tokens in {gen_s:.3f} s, "
          f"{tokens / gen_s:.1f} tokens/s (3 beams a row); checkpoint save "
          f"{[round(x, 3) for x in walls['save']]} s for {walls['bytes']} bytes; restore "
          f"{[round(x, 3) for x in walls['restore']]} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; free disk "
          f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB", flush=True)
    del ta, tb, snaps
    return bf16_launches, bf16_calls, prefix_launches, prefix_calls



# ---------------------------------------------------------------------------
# 13. the command lines at full width
# ---------------------------------------------------------------------------

CLI_TRAIN_SECONDS = (8.0, 10.0, 12.0, 14.0, 16.0, 18.0, 20.0, 9.0)
CLI_VALID_SECONDS = (8.0, 12.0, 16.0, 20.0)
WORDS_PER_SECOND = 3.5
POS_CONV_TOL = 1e-6  # ||pos conv - g v / ||v|| (f64)||_F / ||.||_F
SAFETENSORS_DTYPES = {"float32": "F32", "bfloat16": "BF16"}


def write_safetensors(torch, path, tensors):
    """A ``model.safetensors`` file (scaffolding for phase 13): an 8-byte
    little-endian header length, the JSON header, the tensors' bytes."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.contiguous()
            f.write((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return os.path.getsize(path)


def write_hf_dir(torch, path, config, tensors):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return write_safetensors(torch, os.path.join(path, "model.safetensors"), tensors)


def hf_hubert_dir(torch, path, rng):
    """hubert-large in the ``HubertForCTC`` layout from seeded weights (the
    port's numpy init): the ``hubert.`` prefix, the positional conv as
    ``weight_g`` / ``weight_v``, and ``lm_head.*`` and ``masked_spec_embed``
    as keys the model does not have; f32. Returns (bytes, the tree the
    reader must give apart from the positional conv, g, v)."""
    from aat_tpu_torch.models import hubert

    cfg = hubert.hubert_large_config()
    tree = hubert.init_hubert_numpy(7, cfg)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sd = {}

    def dense(name, p):
        sd[f"hubert.{name}.weight"], sd[f"hubert.{name}.bias"] = t(p["kernel"].T), t(p["bias"])

    def norm(name, p):
        sd[f"hubert.{name}.weight"], sd[f"hubert.{name}.bias"] = t(p["scale"]), t(p["bias"])

    for i, layer in enumerate(tree["feature_extractor"]):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"hubert.{base}.conv.weight"] = t(layer["conv"]["kernel"].transpose(2, 1, 0))
        sd[f"hubert.{base}.conv.bias"] = t(layer["conv"]["bias"])
        norm(f"{base}.layer_norm", layer["layer_norm"])
    norm("feature_projection.layer_norm", tree["feature_projection"]["layer_norm"])
    dense("feature_projection.projection", tree["feature_projection"]["projection"])
    v = t(tree["pos_conv"]["kernel"].transpose(2, 1, 0))
    g = torch.from_numpy(rng.uniform(0.5, 2.0, (1, 1, cfg.num_conv_pos_embeddings))
                         .astype(np.float32))
    sd["hubert.encoder.pos_conv_embed.conv.weight_g"] = g
    sd["hubert.encoder.pos_conv_embed.conv.weight_v"] = v
    sd["hubert.encoder.pos_conv_embed.conv.bias"] = t(tree["pos_conv"]["bias"])
    for i, layer in enumerate(tree["layers"]):
        base = f"encoder.layers.{i}"
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            dense(f"{base}.attention.{theirs}", layer["attention"][ours])
        norm(f"{base}.layer_norm", layer["layer_norm"])
        dense(f"{base}.feed_forward.intermediate_dense", layer["feed_forward"]["intermediate"])
        dense(f"{base}.feed_forward.output_dense", layer["feed_forward"]["output"])
        norm(f"{base}.final_layer_norm", layer["final_layer_norm"])
    norm("encoder.layer_norm", tree["encoder_layer_norm"])
    sd["hubert.masked_spec_embed"] = torch.from_numpy(rng.uniform(0, 1, cfg.hidden_size)
                                                      .astype(np.float32))
    sd["lm_head.weight"] = torch.zeros(32, cfg.hidden_size)
    sd["lm_head.bias"] = torch.zeros(32)
    config = {"architectures": ["HubertForCTC"], "model_type": "hubert",
              "conv_dim": list(cfg.conv_dim), "conv_kernel": list(cfg.conv_kernel),
              "conv_stride": list(cfg.conv_stride), "conv_bias": cfg.conv_bias,
              "feat_extract_norm": cfg.feat_extract_norm, "hidden_size": cfg.hidden_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "intermediate_size": cfg.intermediate_size, "layer_norm_eps": cfg.layer_norm_eps,
              "do_stable_layer_norm": cfg.do_stable_layer_norm,
              "num_conv_pos_embeddings": cfg.num_conv_pos_embeddings,
              "num_conv_pos_embedding_groups": cfg.num_conv_pos_embedding_groups,
              "feat_proj_dropout": cfg.feature_projection_dropout,
              "hidden_dropout": cfg.hidden_dropout, "attention_dropout": cfg.attention_dropout,
              "activation_dropout": cfg.activation_dropout, "layerdrop": cfg.layerdrop,
              "vocab_size": 32, "torch_dtype": "float32"}
    size = write_hf_dir(torch, path, config, sd)
    tree["pos_conv"]["kernel"] = None  # checked apart, against g v / ||v||
    return size, tree, g, v


def hf_smollm_dir(torch, path):
    """SmolLM-135M (``LlamaForCausalLM``, tied embeddings, so no
    ``lm_head``) from seeded weights, stored in bf16. Returns (bytes, the
    written tensors by name)."""
    from aat_tpu_torch.models import llama

    cfg = llama.smollm_135m_config()
    tree = llama.init_llama_numpy(8, cfg)
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)  # noqa: E731
    sd = {"model.embed_tokens.weight": bf(tree["embed_tokens"]["embedding"]),
          "model.norm.weight": bf(tree["final_norm"]["scale"])}
    for i, layer in enumerate(tree["layers"]):
        base = f"model.layers.{i}"
        sd[f"{base}.input_layernorm.weight"] = bf(layer["input_norm"]["scale"])
        sd[f"{base}.post_attention_layernorm.weight"] = bf(layer["post_attention_norm"]["scale"])
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "o_proj")):
            sd[f"{base}.self_attn.{theirs}.weight"] = bf(layer["attention"][ours]["kernel"].T)
        for name in ("gate", "up", "down"):
            sd[f"{base}.mlp.{name}_proj.weight"] = bf(layer["mlp"][name]["kernel"].T)
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_hidden_layers,
              "num_attention_heads": cfg.num_attention_heads,
              "num_key_value_heads": cfg.num_key_value_heads, "rms_norm_eps": cfg.rms_norm_eps,
              "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings,
              "tie_word_embeddings": True, "torch_dtype": "bfloat16"}
    return write_hf_dir(torch, path, config, sd), sd


def check_read_weights(torch, params, hubert_tree, g, v, smollm):
    """The trees ``build_model(pretrained=True)`` read equal what was
    written: bitwise, the bf16 LM after its upcast, and the positional conv
    within ``POS_CONV_TOL`` of g v / ||v|| in f64. Returns (tensors checked,
    the conv's norm ratio)."""
    from aat_tpu_torch.training.checkpoint import flatten
    from aat_tpu_torch.utils.port import encoder_from_jax

    want = flatten(encoder_from_jax(hubert_tree))
    got = flatten(params["audio_encoder"])
    check(set(got) == set(want) | {"pos_conv.kernel"}, "the encoder tree's paths differ")
    differ = [k for k, w in want.items() if not torch.equal(got[k].cpu(), w)]
    check(not differ, f"encoder tensors differ from the file: {differ[:5]}")
    w64 = (g.double() * v.double() / v.double().norm(dim=(0, 1), keepdim=True))
    conv = got["pos_conv.kernel"].cpu().double()
    ratio = float((conv - w64).norm() / w64.norm())
    check(ratio <= POS_CONV_TOL, f"positional conv norm ratio {ratio:.3e} > {POS_CONV_TOL}")

    lm = flatten(params["lm_decoder"])
    names = {"embed_tokens.embedding": "model.embed_tokens.weight",
             "final_norm.scale": "model.norm.weight"}
    for i in range(len(params["lm_decoder"]["layers"])):
        names[f"layers.{i}.input_norm.scale"] = f"model.layers.{i}.input_layernorm.weight"
        names[f"layers.{i}.post_attention_norm.scale"] = (
            f"model.layers.{i}.post_attention_layernorm.weight")
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "o_proj")):
            names[f"layers.{i}.attention.{ours}.kernel"] = f"model.layers.{i}.self_attn.{theirs}.weight"
        for name in ("gate", "up", "down"):
            names[f"layers.{i}.mlp.{name}.kernel"] = f"model.layers.{i}.mlp.{name}_proj.weight"
    check(set(lm) == set(names), f"the LM tree's paths differ: {sorted(set(lm) ^ set(names))[:5]}")
    differ = []
    for ours, theirs in names.items():
        w = smollm[theirs].float()
        w = w.t() if ours.endswith("kernel") else w
        if lm[ours].dtype != torch.float32 or not torch.equal(lm[ours].cpu(), w):
            differ.append(ours)
    check(not differ, f"LM tensors differ from the file: {differ[:5]}")
    return len(want) + 1 + len(names), ratio


class CliWords(WordIds):
    """Word-level tokenizer of phase 13 (the card's machine has no
    tokenizer files): a fixed vocabulary of ``<pad>`` 0, ``<s>`` 1,
    ``</s>`` 2, the prompt prefixes' words and the captions' words, with
    ``__call__(texts, padding=True)``, ``decode`` and ``batch_decode``; it
    reads its own bos and eos strings inside a text."""

    bos_token_id = 1

    def __init__(self, words):
        from aat_tpu_torch.data.collate import PREFIXES

        self.vocab = {"<pad>": 0, "<s>": 1, "</s>": 2}
        for w in " ".join(PREFIXES).split() + sorted(words):
            self.vocab.setdefault(w, len(self.vocab))
        self.words = {i: w for w, i in self.vocab.items()}

    def __call__(self, texts, padding=True):
        seqs = [[self.vocab[w] for w in t.replace("<s>", " <s> ").replace("</s>", " </s> ").split()]
                for t in texts]
        ids = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}

    def decode(self, ids, skip_special_tokens=False):
        special = (0, 1, 2) if skip_special_tokens else ()
        # a generated id outside the vocabulary reads as id<i>
        return " ".join(self.words.get(int(i), f"id{int(i)}") for i in ids
                        if int(i) not in special)

    def batch_decode(self, ids, skip_special_tokens=True):
        return [self.decode(row, skip_special_tokens) for row in np.asarray(ids)]


class Split(list):
    """A dataset stand-in for ``load_hf_dataset``: ``select``,
    ``shuffle(seed)`` and ``len``."""

    def select(self, indices):
        return Split(self[int(i)] for i in indices)

    def shuffle(self, seed):
        return self.select(np.random.default_rng(seed).permutation(len(self)))


def cli_items(rng, durations, tag):
    """Speech-like utterances with ``words`` (3.5 a second), their start
    and end times, and an ``id``."""
    items = Split()
    for i, d in enumerate(durations):
        n = int(d * WORDS_PER_SECOND)
        start = np.linspace(0.0, 0.9 * d, n)
        items.append({"id": f"{tag}{i}", "audio": {"array": speechlike_waveform(rng, d),
                                                   "sampling_rate": 16000},
                      "words": [f"w{int(k)}" for k in rng.integers(3, 3000, n)],
                      "word_start": start.tolist(), "word_end": (start + 0.2).tolist()})
    return items


def phase_cli(torch, device, rng, smi_line):
    """13. the command lines at full width, in a temporary directory under
    the build directory, with cuDNN's deterministic algorithms (the resumed
    run must equal the uninterrupted one bit for bit) and wandb disabled.
    Returns the train CLI's launches by wrapper and by C entry (its bf16
    part and its generation prefixes') and serve's, then phase 14's,
    phase 15's unfreeze command line's and phase 16c's (run in the same
    directory)."""
    import shutil
    import tempfile

    from aat_tpu_torch.runtime.kernels import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=BUILD_DIR)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    wandb_mode = os.environ.get("WANDB_MODE")
    os.environ["WANDB_MODE"] = "disabled"
    try:
        result = cli_path(torch, device, rng, smi_line, tmp)
        # 14. the dataset utilities, and 15's LM unfreeze through the train
        # command line, on the directories written here
        dataset = phase_dataset(torch, device, rng, smi_line, tmp)
        unfreeze = phase_unfreeze_cli(torch, device, rng, smi_line, tmp)
        # 16c. the EfficientNet and transformer_encoder command line
        start = time.perf_counter()
        projections = phase_projection_cli(torch, device, np.random.default_rng(161), smi_line,
                                           tmp)
        print(f"phase 16c wall {time.perf_counter() - start:.1f} s", flush=True)
        return result + (dataset, unfreeze, projections)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if wandb_mode is None:
            os.environ.pop("WANDB_MODE", None)
        else:
            os.environ["WANDB_MODE"] = wandb_mode
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_tensors(torch, path):
    """Every tensor of a checkpoint's ``params.pt`` and ``optimizer.pt``."""
    out = {}
    for name in ("params", "optimizer"):
        saved = torch.load(os.path.join(path, f"{name}.pt"), weights_only=True)
        for key, value in saved.items():
            if isinstance(value, dict):
                out.update({f"{name}.{key}.{k}": v for k, v in value.items()})
            else:
                out[f"{name}.{key}"] = value if torch.is_tensor(value) else torch.tensor(value)
    return out


def cli_path(torch, device, rng, smi_line, tmp):
    import contextlib
    import io
    import shutil

    from aat_tpu_torch.models.build import build_model
    from aat_tpu_torch.ops import mel
    from aat_tpu_torch.runtime.kernels import library
    from aat_tpu_torch.scripts import serve as serve_cli
    from aat_tpu_torch.scripts import train, validate
    from aat_tpu_torch.serving import serve
    from aat_tpu_torch.training.config import projection_training_config
    from aat_tpu_torch.training.trainer import AATTrainer

    phase_start = time.perf_counter()
    print(f"cli phase: free disk {shutil.disk_usage(tmp).free / 2**30:.1f} GiB", flush=True)
    # 1. the readers at full width
    enc_dir, lm_dir = os.path.join(tmp, "hubert-large"), os.path.join(tmp, "smollm-135m")
    start = time.perf_counter()
    enc_bytes, hubert_tree, g, v = hf_hubert_dir(torch, enc_dir, rng)
    lm_bytes, smollm = hf_smollm_dir(torch, lm_dir)
    write_s = time.perf_counter() - start
    cfg = dataclasses.replace(projection_training_config(), audio_encoder_checkpoint=enc_dir,
                              lm_pretrained_model=lm_dir)
    torch.cuda.synchronize()
    start = time.perf_counter()
    model, params = build_model(cfg, pretrained=True, device=device)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - start
    n_checked, ratio = check_read_weights(torch, params, hubert_tree, g, v, smollm)
    check(model.audio_encoder_config.attention_impl == "pallas"
          and model.lm_config.attention_impl == "pallas", "the read models are not on flash")
    print(f"cli readers: hubert-large (HubertForCTC layout, weight_g/weight_v, lm_head and "
          f"masked_spec_embed skipped) {enc_bytes} bytes f32, SmolLM-135M (tied, bf16) "
          f"{lm_bytes} bytes, written in {write_s:.2f} s; build_model(pretrained=True) "
          f"{read_s:.2f} s ({(enc_bytes + lm_bytes) / read_s / 1e9:.2f} GB/s); {n_checked} "
          f"tensors equal to the file bit for bit (the LM after its bf16 upcast), the "
          f"positional conv's norm ratio to g v / ||v|| (f64) {ratio:.3e}", flush=True)
    del model, params, hubert_tree, smollm

    # the seams a run on this machine replaces: the dataset and the tokenizer
    train_items = cli_items(rng, CLI_TRAIN_SECONDS, "train")
    valid_items = cli_items(rng, CLI_VALID_SECONDS, "valid")
    tokenizer = CliWords({w for it in train_items + valid_items for w in it["words"]})
    splits = {"train": train_items, "valid": valid_items}
    seams = {(mod, "load_hf_dataset"): lambda name, split=None: splits[split]
             for mod in (train, validate)}
    seams.update({(mod, "build_tokenizer"): lambda config: tokenizer for mod in (train, validate)})
    real = {key: getattr(*key) for key in seams}

    wrappers = kernel_wrappers()
    walls = {"training_step": [], "evaluate": [], "save_checkpoint": []}
    prefix_launches = dict.fromkeys(wrappers, 0)
    prefix_calls = dict.fromkeys(library().calls, 0)
    methods = {name: getattr(AATTrainer, name) for name in list(walls) + ["_prefix_inputs"]}

    def timed(name):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = methods[name](self, *args, **kw)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - start)
            return out
        return run

    def prefix_routed(self, *args, **kw):
        calls = dict(library().calls)
        launches = {n: w.launches for n, w in wrappers.items()}
        out = methods["_prefix_inputs"](self, *args, **kw)
        routed(calls, "float32", "cli generation prefix", backward=False)
        for n, w in wrappers.items():
            prefix_launches[n] += w.launches - launches[n]
        for e, c in library().calls.items():
            prefix_calls[e] += c - calls[e]
        return out

    argv = ["--pretrained", "--audio-encoder-checkpoint", enc_dir, "--lm-pretrained-model",
            lm_dir, "--per-device-train-batch-size", "2", "--gradient-accumulation-steps", "1",
            "--num-train-epochs", "2", "--eval-steps", "3", "--save-steps", "3",
            "--logging-steps", "1", "--no-load-best-model-at-end"]
    out_a = os.path.join(tmp, "a_1_linear_none")
    try:
        for (mod, name), fn in seams.items():
            setattr(mod, name, fn)
        for name in walls:
            setattr(AATTrainer, name, timed(name))
        AATTrainer._prefix_inputs = prefix_routed

        # 2. run A: the default preset for 2 epochs of 4 steps
        for w in wrappers.values():
            w.launches = 0
        calls = reset_entry_calls()
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer = train.main(argv + ["--output-dir", os.path.join(tmp, "a")], device=device)
        torch.cuda.synchronize()
        a_s = time.perf_counter() - start
        launches = {n: w.launches for n, w in wrappers.items()}
        calls = dict(calls)
        a_walls = {k: list(x) for k, x in walls.items()}
        with open(os.path.join(out_a, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        losses = [m["train/loss"] for m in lines if "train/loss" in m]
        evals = [m for m in lines if "eval/loss" in m]
        ckpts = sorted(d for d in os.listdir(out_a) if d.startswith("checkpoint-"))
        print(f"cli train, run A (python -m aat_tpu_torch.scripts.train, default preset, "
              f"--pretrained): wall {a_s:.3f} s; steps {[round(x, 3) for x in a_walls['training_step']]} "
              f"s; evals {[round(x, 3) for x in a_walls['evaluate']]} s; saves "
              f"{[round(x, 3) for x in a_walls['save_checkpoint']]} s; losses "
              f"{[round(x, 5) for x in losses]}; evals "
              + "; ".join(f"eval/loss {m['eval/loss']:.5f} wer {m['wer']:.4f}" for m in evals)
              + f"; checkpoints {ckpts}", flush=True)
        check(trainer.state.step == 8 and len(losses) == 8 and all(np.isfinite(losses)),
              f"run A: step {trainer.state.step}, losses {losses}")
        check(len(evals) == 2 and all(np.isfinite(m["eval/loss"]) for m in evals),
              f"run A's metrics.jsonl evals {evals}")
        check({"checkpoint-6", "checkpoint-8"} <= set(ckpts), f"run A wrote {ckpts}")
        for stale in set(ckpts) - {"checkpoint-6", "checkpoint-8"}:
            shutil.rmtree(os.path.join(out_a, stale))  # disk: run B needs only these two
        bf16_launches = {k: launches[k] - prefix_launches[k] for k in launches}
        bf16_calls = {e: calls[e] - prefix_calls[e] for e in calls}
        print(f"cli train launches: steps and eval losses {bf16_launches}; generation prefixes "
              f"{prefix_launches}", flush=True)
        flash_entry_calls(bf16_calls, "cli train (steps, eval losses)", "bfloat16")
        flash_entry_calls(prefix_calls, "cli train (generation prefixes)", "float32",
                          backward=False)
        for name in TRAIN_KERNELS:
            check(bf16_launches[name] > 0, f"the train CLI never launched {name}")

        # 3. run B: resume from checkpoint-6 into epoch 1, 2 batches skipped
        start = time.perf_counter()
        train.main(argv + ["--output-dir", os.path.join(tmp, "b"), "--resume-from-checkpoint",
                           os.path.join(out_a, "checkpoint-6")], device=device)
        torch.cuda.synchronize()
        b_s = time.perf_counter() - start
        want = checkpoint_tensors(torch, os.path.join(out_a, "checkpoint-8"))
        got = checkpoint_tensors(torch, os.path.join(tmp, "b_1_linear_none", "checkpoint-8"))
        differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        check(set(got) == set(want) and not differ,
              f"run B's checkpoint-8 differs from run A's on {len(differ)} tensors: {differ[:5]}")
        with open(os.path.join(tmp, "b_1_linear_none", "metrics.jsonl")) as f:
            b_losses = [m["train/loss"] for m in map(json.loads, f) if "train/loss" in m]
        check(b_losses == losses[6:], f"run B's losses {b_losses}, run A's {losses[6:]}")
        print(f"cli train, run B (--resume-from-checkpoint checkpoint-6: epoch 1, 2 batches "
              f"fast-forwarded): wall {b_s:.3f} s; checkpoint-8 equal to run A's on all "
              f"{len(want)} tensors of params.pt and optimizer.pt, bit for bit; losses of steps "
              f"7-8 equal", flush=True)
        shutil.rmtree(os.path.join(tmp, "b_1_linear_none"))

        # 4. segmented training: adaptive boundaries and the n_words crop
        for w in wrappers.values():
            w.launches = 0
        seg_calls = reset_entry_calls()
        start = time.perf_counter()
        seg = train.main(["--pretrained", "--audio-encoder-checkpoint", enc_dir,
                          "--lm-pretrained-model", lm_dir, "--segmentation", "adaptive",
                          "--few-train-samples", "4", "--per-device-train-batch-size", "2",
                          "--gradient-accumulation-steps", "1", "--num-train-epochs", "1",
                          "--eval-steps", "0", "--save-steps", "0", "--logging-steps", "1",
                          "--output-dir", os.path.join(tmp, "seg")], device=device)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - start
        with open(os.path.join(tmp, "seg_1_linear_adaptive", "metrics.jsonl")) as f:
            seg_lines = [json.loads(line) for line in f]
        seg_losses = [m["train/loss"] for m in seg_lines if "train/loss" in m]
        seg_len = [m["debug/seq_len"] for m in seg_lines if "debug/seq_len" in m]
        print(f"cli train --segmentation adaptive (n_words 50 crop): wall {seg_s:.3f} s, losses "
              f"{[round(x, 5) for x in seg_losses]}, LM sequence lengths {seg_len}; launches "
              f"{ {n: w.launches for n, w in wrappers.items()} }; flash by C entry "
              f"{ {e: c for e, c in seg_calls.items() if c} }", flush=True)
        check(seg.state.step == 2 and len(seg_losses) == 2 and all(np.isfinite(seg_losses)),
              f"segmented run: step {seg.state.step}, losses {seg_losses}")
        del seg
        shutil.rmtree(os.path.join(tmp, "seg_1_linear_adaptive"))

        # 5. validate and serve on run A's export, with the trainer's own
        # methods (validate's segmented prefixes launch no flash kernel)
        for name, fn in methods.items():
            setattr(AATTrainer, name, fn)
        export = trainer.save_pretrained(os.path.join(tmp, "export"))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = validate.main(["--checkpoint", export, "--items", "4", "--batch", "2",
                                     "--no-pretrained"], device=device)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - start
        print(f"cli validate (--no-pretrained, adaptive, 4 items): wall {val_s:.3f} s; "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())), flush=True)
        check(np.isfinite(metrics["eval/loss"]) and "wer" in metrics, f"validate: {metrics}")
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
        for name, fn in methods.items():
            setattr(AATTrainer, name, fn)

    loaded = {}
    real_load = serve_cli.load_pretrained

    def keep(*args, **kw):
        loaded["model"], loaded["params"] = real_load(*args, **kw)
        return loaded["model"], loaded["params"]

    serve_argv = ["--model-dir", export, "--random-demo", "4"]
    serve_cli.load_pretrained = keep
    # the ids are what is compared: no tokenizer decodes them (the export's
    # LM directory has none)
    real_tokenizer = serve_cli.local_tokenizer
    serve_cli.local_tokenizer = lambda name: None
    for w in wrappers.values():
        w.launches = 0
    serve_calls = reset_entry_calls()
    out = io.StringIO()
    try:
        start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = serve_cli.main(serve_argv, device=device)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - start
    finally:
        serve_cli.load_pretrained = real_load
        serve_cli.local_tokenizer = real_tokenizer
    serve_launches = {n: w.launches for n, w in wrappers.items()}
    serve_calls = dict(serve_calls)
    lines = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    want_ids = serve.serve(loaded["model"], loaded["params"], serve_cli.demo_waves(4),
                           serve_cli.serve_config(serve_cli.parse_args(serve_argv), EVAL_EOS))
    check(code == 0 and [line["audio"] for line in lines] == [f"demo-{i}" for i in range(4)],
          f"serve --model-dir printed {lines}")
    check(all(line["ids"] == ids.tolist() for line, ids in zip(lines, want_ids)),
          "serve --model-dir ids differ from serving.serve on the model it loaded")
    check(serve_launches["mel"] > 0, "serve --model-dir never launched the mel kernel")
    print(f"cli serve --model-dir (4 demo requests): wall {serve_s:.3f} s (load_pretrained "
          f"included); ids equal to serving.serve on the loaded model on 4 of 4 requests; "
          f"launches {serve_launches}; first ids {lines[0]['ids'][:8]}", flush=True)
    del loaded
    for done in (out_a, export):  # disk for phases 14 and 15 in this directory
        shutil.rmtree(done, ignore_errors=True)
    print(f"cli phase numbers ({smi_line}): wall {time.perf_counter() - phase_start:.1f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; free disk "
          f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB", flush=True)
    return bf16_launches, bf16_calls, prefix_launches, prefix_calls, serve_launches, serve_calls


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


def corpus_codebook(torch, x, k, seed):
    """K codes drawn from the corpus rows x (so about its mixture centres)
    plus noise at 0.1, with exact duplicates: the last 24 codes and code K/2
    repeat codes 5 and 7."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    n, d = x.shape
    cb = x[torch.randperm(n, generator=g, device=x.device)[:k]] + 0.1 * torch.randn(
        (k, d), generator=g, device=x.device)
    cb[k - 24:] = cb[5]  # exact duplicates of code 5
    cb[k // 2] = cb[7]  # and of code 7, between the two
    return cb


def planted_near_ties(torch, cb, rows, seed, gap=NEAR_TIE_GAP):
    """``rows`` near-tie rows ``[rows, D]`` f32 against the codebook ``cb``
    and the ids that must win, ``(x, want)``. Each row lies between a code a
    and its nearest other code b (two codes of one mixture centre):
    x = (c_a + c_b)/2 + e·(c_a − c_b)/‖c_a − c_b‖, so a is nearer than b by
    2e‖c_a − c_b‖, set to ``gap`` (a uniform draw) times the near-tie margin
    1e-4·max(1, |best|) of ``assert_ids_near``. Codes with exact duplicates,
    and codes with no other code of their centre, are left out. Raises
    unless, in f64 on the f32 rows, a is the nearest code, b the second (no
    third code nearer) and the gap lies within ``gap`` margins (to 0.01)."""
    g = torch.Generator(device=cb.device)
    g.manual_seed(seed)
    c = cb.double()
    norms = (c * c).sum(-1)
    d2 = norms[:, None] + norms[None, :] - 2.0 * c @ c.t()
    d2.fill_diagonal_(float("inf"))
    typical = d2[torch.isfinite(d2)].median()  # two codes of different centres
    dup = (d2 < 1e-9 * typical).any(1)
    d2[dup] = float("inf")
    d2[:, dup] = float("inf")
    # a code whose nearest other code is far closer than typical shares its
    # mixture centre with it
    usable = torch.nonzero(d2.min(1).values < 0.5 * typical)[:, 0]
    check(len(usable) > 0, "no two codes share a mixture centre")
    a = usable[torch.randint(0, len(usable), (rows,), generator=g, device=cb.device)]
    b = d2[a].argmin(1)
    length = d2[a, b].sqrt()[:, None]
    ca, cb_ = c[a], c[b]
    best0 = -(ca * cb_).sum(-1, keepdim=True)  # a's distance at the midpoint
    f = gap[0] + (gap[1] - gap[0]) * torch.rand((rows, 1), generator=g, device=cb.device,
                                                 dtype=torch.float64)
    eps = f * 1e-4 * best0.abs().clamp_min(1.0) / (2.0 * length)
    x = ((ca + cb_) / 2 + eps * (ca - cb_) / length).float()
    dist = norms[None, :] - 2.0 * x.double() @ c.t()
    three = torch.topk(dist, 3, dim=1, largest=False)
    margin = 1e-4 * three.values[:, 0].abs().clamp_min(1.0)
    ratio = (three.values[:, 1] - three.values[:, 0]) / margin
    check(bool((three.indices[:, 0] == a).all()), "a planted near-tie's code is not the nearest")
    check(bool((three.indices[:, 1] == b).all()), "a third code is nearer than a planted pair")
    check(bool(((ratio >= gap[0] - 0.01) & (ratio <= gap[1] + 0.01)).all()),
          f"planted gaps span {float(ratio.min())}-{float(ratio.max())} margins, not {gap}")
    return x, a.int()


def phase_vq_corpus(torch, device):
    """Kernel 8 against its plain version at corpus scale (N = 262,144,
    D = 1024), K = 1024 and the overhanging K = 1000, with exact duplicate
    codes and 4,096 planted near-ties (:func:`planted_near_ties`, which must
    resolve as the f64 argmin does); a ragged N, K and D under the same
    rules; then 10 EMA iterations of the quantize command line's loop.
    Returns the K = 1024 result for the kernels line."""
    from aat_tpu_torch.ops import vq
    from aat_tpu_torch.scripts.quantize_embeddings import train_codebook

    n, d, sizes = VQ_CORPUS
    x = corpus_embeddings(torch, device, n, d, seed=10)
    result = None
    for k in sizes:
        cb = corpus_codebook(torch, x, k, seed=k)
        x[:64] = cb[5]  # rows sitting exactly on a duplicated code
        x[64:128] = cb[7]
        ties, want = planted_near_ties(torch, cb, NEAR_TIES, seed=k + 1)
        x[128:128 + NEAR_TIES] = ties
        cbn = vq.codebook_norms(cb)
        got = vq.nearest_codebook_kernel(x, cb, cbn)
        ref, clear, differ, excess = assert_ids_near(torch, f"vq K={k}", got, x, cb)
        planted_wrong = int((got[128:128 + NEAR_TIES] != want).sum())
        planted_plain_wrong = int((ref[128:128 + NEAR_TIES] != want).sum())
        ms = cuda_ms(torch, lambda: vq.nearest_codebook_kernel(x, cb, cbn), iters=5, warmup=1)
        plain_ms = cuda_ms(torch, lambda: vq.nearest_codebook_reference(x, cb, cbn), iters=5,
                           warmup=1)
        gflop = 2.0 * n * k * d / 1e9
        print(f"vq: N {n} D {d} K {k}: {clear} rows with a clear gap equal, {differ} ids "
              f"differ from the plain route (near-ties), worst excess {excess:.3e}; exact "
              f"duplicates -> {sorted(set(got[:128].tolist()))}; planted near-ties (gap "
              f"{NEAR_TIE_GAP} margins): kernel {planted_wrong} of {NEAR_TIES} off the f64 argmin, "
              f"plain route {planted_plain_wrong}; kernel {ms:.4f} ms "
              f"({gflop / ms:.1f} TFLOP/s) plain {plain_ms:.4f} ms", flush=True)
        check(bool((got[:64] == 5).all() and (got[64:128] == 7).all()),
              f"vq K={k}: an exact tie did not go to the lowest id")
        check(bool((ref[:64] == 5).all() and (ref[64:128] == 7).all()),
              f"vq K={k}: the plain route broke an exact tie")
        check(planted_wrong == 0, f"vq K={k}: {planted_wrong} planted near-ties off the f64 argmin")
        if result is None:
            # ids that differ count as the error: an id is right or wrong. The
            # bound: the f32-accurate product x.c at PEAK_FLOPS (3xTF32); no
            # single PyTorch call computes an argmin of distances
            bound = bound_ms((x, cb, cbn, got), [2.0 * n * k * d / PEAK_FLOPS["float32"]])
            result = {"max_abs_err": float(differ), "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
        del ref

    # a ragged case: N, K and D off every tile, D off 4 (4-byte copies)
    rn, rk, rd = VQ_RAGGED
    xr = corpus_embeddings(torch, device, rn, rd, seed=11)
    cbr = corpus_codebook(torch, xr, rk, seed=12)
    xr[:8] = cbr[5]
    got = vq.nearest_codebook_kernel(xr, cbr, vq.codebook_norms(cbr))
    _, clear, differ, excess = assert_ids_near(torch, f"vq ragged N {rn} K {rk} D {rd}", got, xr,
                                               cbr)
    print(f"vq: ragged N {rn} K {rk} D {rd}: {clear} rows with a clear gap equal, {differ} "
          f"differ on near-ties, worst excess {excess:.3e}", flush=True)
    check(bool((got[:8] == 5).all()), "vq ragged: an exact tie did not go to the lowest id")

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


def planted_faults(torch, q, k, v, mask, scale, causal, rate, seed, out, ref_out):
    """The bf16 forward's out checks, held against faults planted through
    the tensor-core kernel's own arguments: the kept probabilities left
    unscaled (``inv_keep`` 1 in place of 1/(1 - rate), with dropout), and
    the key tile ``FAULT_TILE`` left out of the key loop (its keys masked in
    the kernel's mask, not the reference's). A control launch with the
    wrapper's own arguments must reproduce ``out`` bit for bit. Returns
    ``{fault: (max abs err, norm ratio)}`` against ``ref_out``."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime import kernels

    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    seed32, rate32, inv_keep, *head_keys = att._dropout_args(rate, seed, h, None)

    def launch(key_mask, inv):
        result = torch.empty_like(q)
        kernels.launch("aat_flash_fwd_mma", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       key_mask.data_ptr(), result.data_ptr(), None, b, t, s, h, kvh,
                       *att._widths(q, v), *att._strides(q, k, v), float(scale), int(causal), 0,
                       seed32, rate32, inv, *head_keys)
        return result

    check(torch.equal(launch(mask, inv_keep), out),
          "a launch with the wrapper's arguments does not reproduce its output")
    tile_out = mask.clone()
    tile_out[:, FAULT_TILE[0]:FAULT_TILE[1]] = 0
    faults = {f"keys {FAULT_TILE[0]}-{FAULT_TILE[1] - 1} left out": launch(tile_out, inv_keep)}
    if rate > 0.0:
        faults["no 1/(1-rate) rescale"] = launch(mask, 1.0)
    torch.cuda.synchronize()
    return {name: out_errors(x, ref_out) for name, x in faults.items()}


def planted_backward_faults(torch, args, kw, grads, refs):
    """The backward's gradient checks, held against faults planted through
    the C entries of q's dtype (``FLASH_ENTRIES``: bf16 or 3xTF32), with
    their own arguments: the kept probabilities
    and dp left unscaled (``inv_keep`` 1 in place of 1/(1 - rate), with
    dropout), and the key tile ``FAULT_TILE`` masked in the kernels' key mask
    (not in the reference's). A control launch of both entries with the
    wrappers' own arguments must reproduce ``grads`` (dq, dk, dv) bit for
    bit. Returns ``{fault: (dq norm ratio, max of the dk and dv norm
    ratios)}`` against ``refs``."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime import kernels

    q, k, v, mask, out, lse, dout, scale = args
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    base = att._backward_args(q, k, v, scale, kw["causal"], kw["dropout_rate"],
                              kw["dropout_seed"], None, None)
    inv_keep = base[-3]  # then heads_total and head_offset

    def launch(key_mask, inv):
        rest = (*base[:-3], inv, *base[-2:])
        dq = torch.empty_like(out)
        dk, dv = (torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
                  for _ in range(2))
        delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr())
        _, dq_entry, dkv_entry = FLASH_ENTRIES[str(q.dtype)[6:]]
        kernels.launch(dq_entry, q.device, *inputs, dq.data_ptr(), *rest)
        kernels.launch(dkv_entry, q.device, *inputs, dk.data_ptr(), dv.data_ptr(),
                       delta.data_ptr(), *rest)
        rep = h // kvh
        return (dq, *(x.reshape(b, s, kvh, rep, d).sum(3).to(k.dtype) for x in (dk, dv)))

    check(all(torch.equal(x, y) for x, y in zip(launch(mask, inv_keep), grads)),
          "a backward launch with the wrappers' arguments does not reproduce their gradients")
    tile_out = mask.clone()
    tile_out[:, FAULT_TILE[0]:FAULT_TILE[1]] = 0
    faults = {f"keys {FAULT_TILE[0]}-{FAULT_TILE[1] - 1} left out": launch(tile_out, inv_keep)}
    if kw["dropout_rate"] > 0.0:
        faults["no 1/(1-rate) rescale"] = launch(mask, 1.0)
    torch.cuda.synchronize()
    ratios = {}
    for name, got in faults.items():
        rel = [out_errors(x, r)[1] for x, r in zip(got, refs)]
        ratios[name] = (rel[0], max(rel[1:]))
    return ratios


def phase_split_backward(torch, device, rng):
    """The long-form path's kernels at its shapes (``SPLIT_CASES``, key
    lengths above 8192) against their plain versions, f32 and bf16, at
    phase 7's tolerances: the forward kernel (out, lse), then the split
    route's dq and dk/dv kernels fed the plain forward's out and lse, each
    through the C entries of its dtype. The plain versions run through
    :func:`plain_by_heads`. Faults are planted in the bf16 forward
    (:func:`planted_faults`) and in the backward of both dtypes
    (:func:`planted_backward_faults`). Returns the results for the kernels
    line: bf16 with SDPA's times and the bounds, the f32 results under
    ``f32_`` keys."""
    from aat_tpu_torch.ops import attention as att
    from aat_tpu_torch.runtime.kernels import library

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

            label = (f"{'causal' if causal else 'dense'} [{b},{t},{h},{d}] {dtype_name}"
                     f"{f' dropout {rate}' if rate else ''}")
            before = dict(library().calls)
            out, lse = fwd(q, k, v, mask, scale, **fkw)
            ref_out, ref_lse = plain(att.flash_forward_reference)
            args = (q, k, v, mask, ref_out, ref_lse, g, scale)
            dq = att.flash_backward_dq_long(*args, **kw)
            dk, dv = att.flash_backward_dkv_long(*args, **kw)
            routed(before, dtype_name, f"long-form kernels {label}")
            ref_dq = plain(att.flash_backward_dq_reference, (ref_out, ref_lse, g))
            ref_dk, ref_dv = plain(att.flash_backward_dkv_reference, (ref_out, ref_lse, g))
            torch.cuda.synchronize()
            out_err, out_rel = out_errors(out, ref_out)
            live = ref_lse > -1e29
            lse_err = float((lse - ref_lse)[live].abs().max())
            out_bound = FLASH_TOL[dtype_name] * (
                max(1.0, float(ref_out.float().abs().max())) if dtype_name == "bfloat16" else 1.0)
            faults = {}
            refs = (ref_dq, ref_dk, ref_dv)
            if dtype == torch.bfloat16:
                faults = planted_faults(torch, q, k, v, mask, scale, causal, rate, seed, out,
                                        ref_out)
            bwd_faults = planted_backward_faults(torch, args, kw, (dq, dk, dv), refs)
            errs = [float((a.float() - r.float()).abs().max()) for a, r in zip((dq, dk, dv), refs)]
            rel = [e / float(r.float().abs().max()) for e, r in zip(errs, refs)]
            grad_rel = [out_errors(a, r)[1] for a, r in zip((dq, dk, dv), refs)]
            del ref_dq, ref_dk, ref_dv, refs
            torch.cuda.empty_cache()
            fwd_ms = cuda_ms(torch, lambda: fwd(q, k, v, mask, scale, **fkw),
                             iters=20 if dtype == torch.bfloat16 else 3, warmup=1)
            # what the dropout hash costs: the same launch at rate 0
            nodrop_ms = (cuda_ms(torch, lambda: fwd(q, k, v, mask, scale, need_lse=True),
                                 iters=20, warmup=1)
                         if rate > 0.0 and dtype == torch.bfloat16 else None)
            bwd_iters = 20 if dtype == torch.bfloat16 else 3
            dq_ms = cuda_ms(torch, lambda: att.flash_backward_dq_long(*args, **kw),
                            iters=bwd_iters, warmup=1)
            dkv_ms = cuda_ms(torch, lambda: att.flash_backward_dkv_long(*args, **kw),
                             iters=bwd_iters, warmup=1)
            fwd_plain_ms = cuda_ms(torch, lambda: plain(att.flash_forward_reference), iters=2,
                                   warmup=1)
            dq_plain_ms = cuda_ms(torch, lambda: plain(att.flash_backward_dq_reference,
                                                       (ref_out, ref_lse, g)), iters=2, warmup=1)
            dkv_plain_ms = cuda_ms(torch, lambda: plain(att.flash_backward_dkv_reference,
                                                        (ref_out, ref_lse, g)), iters=2, warmup=1)
            torch.cuda.empty_cache()
            print(f"long-form kernels: {label} fwd out err {out_err:.3e} (bound {out_bound:.2e}, "
                  f"max|ref| {float(ref_out.float().abs().max()):.3e}) norm ratio {out_rel:.3e} "
                  f"(bound {FLASH_REL_TOL[dtype_name]}) "
                  f"lse err {lse_err:.3e} (bound {FLASH_TOL[dtype_name]}); split bwd dq/dk/dv "
                  f"err/max|ref| {'/'.join(f'{e:.2e}' for e in rel)} (bound "
                  f"{GRAD_REL_TOL[dtype_name]}) norm ratios "
                  f"{'/'.join(f'{e:.2e}' for e in grad_rel)} (bound {GRAD_NORM_TOL[dtype_name]}); "
                  f"fwd {fwd_ms:.4f} ms plain {fwd_plain_ms:.4f} ms"
                  f"{f' (at rate 0 {nodrop_ms:.4f} ms)' if nodrop_ms else ''}, "
                  f"dq {dq_ms:.4f} ms plain {dq_plain_ms:.4f} ms, dkv {dkv_ms:.4f} ms plain "
                  f"{dkv_plain_ms:.4f} ms", flush=True)
            for fault, (f_err, f_rel) in faults.items():
                print(f"long-form kernels: {label} planted fault '{fault}': out err {f_err:.3e} "
                      f"({'inside' if f_err <= out_bound else 'outside'} the max bound "
                      f"{out_bound:.2e}) norm ratio {f_rel:.3e} (bound "
                      f"{FLASH_REL_TOL[dtype_name]})", flush=True)
                check(f_rel > FLASH_REL_TOL[dtype_name],
                      f"long-form kernels {label}: the out checks pass the planted fault '{fault}'")
            for fault, (dq_rel, dkv_rel) in bwd_faults.items():
                print(f"long-form kernels: {label} planted backward fault '{fault}': norm ratio "
                      f"dq {dq_rel:.3e}, dk/dv {dkv_rel:.3e} (bound {GRAD_NORM_TOL[dtype_name]})",
                      flush=True)
                check(min(dq_rel, dkv_rel) > GRAD_NORM_TOL[dtype_name],
                      f"long-form kernels {label}: the gradient checks pass the planted fault "
                      f"'{fault}'")
            check(all(bool(torch.isfinite(x.float()).all()) for x in (out, dq, dk, dv)),
                  f"long-form kernels {label}: non-finite output or gradient")
            check(out_err <= out_bound and out_rel <= FLASH_REL_TOL[dtype_name]
                  and lse_err <= FLASH_TOL[dtype_name],
                  f"long-form kernels {label}: forward differs by {out_err} (norm ratio "
                  f"{out_rel}, lse {lse_err})")
            check(max(rel) <= GRAD_REL_TOL[dtype_name]
                  and max(grad_rel) <= GRAD_NORM_TOL[dtype_name],
                  f"long-form kernels {label}: gradients differ by {rel} of max|ref| "
                  f"(norm ratios {grad_rel})")
            name = "causal" if causal else "dense"
            measured = {"fwd": (out_err, out_rel, fwd_ms, fwd_plain_ms),
                        "dq": (errs[0], grad_rel[0], dq_ms, dq_plain_ms),
                        "dkv": (max(errs[1:]), max(grad_rel[1:]), dkv_ms, dkv_plain_ms)}
            lib = sdpa_ms(torch, q, k, v, causal, rate)
            inputs = (q, k, v, mask, ref_out, ref_lse, g)
            bounds = {"fwd": attention_bound(torch, "fwd", (q, k, v, mask, out, lse), q,
                                             mask, causal, None, rate),
                      "dq": attention_bound(torch, "dq", inputs + (dq,), q, mask, causal,
                                            None, rate),
                      "dkv": attention_bound(torch, "dkv", inputs + (dk, dv), q, mask,
                                             causal, None, rate)}
            pre = "f32_" if dtype_name == "float32" else ""
            for kind, (err, ratio, ms, plain_ms) in measured.items():
                # SDPA's backward computes dq, dk and dv in one call: the
                # yardstick of each half of the split backward
                r = results.setdefault(f"{kind}_{name}", {})
                r.update({f"{pre}max_abs_err": err, f"{pre}norm_ratio": ratio, f"{pre}ms": ms,
                          f"{pre}plain_ms": plain_ms,
                          f"{pre}library_ms": lib["fwd_ms" if kind == "fwd" else "bwd_ms"],
                          f"{pre}bound_ms": bounds[kind][0], f"{pre}bound_by": bounds[kind][1]})
                if pre:
                    r["f32_source"] = F32_SOURCE["fwd" if kind == "fwd" else "bwd"]
            print(f"long-form kernels: {label}: SDPA ({SDPA_BACKEND[dtype_name]} backend, no key "
                  f"mask) fwd {lib['fwd_ms']:.4f} ms bwd {lib['bwd_ms']:.4f} ms; bounds fwd "
                  f"{bounds['fwd'][0]:.4f} ms ({bounds['fwd'][1]}), dq "
                  f"{bounds['dq'][0]:.4f} ms, dkv {bounds['dkv'][0]:.4f} ms", flush=True)
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


def phase_longform(torch, device, rng, smi_line):
    """2 optimizer steps of ``projection_training_config()`` with the
    Qwen-1.5-1.8B LM at full width (random weights through ``build_model``),
    one utterance of 170 s and one of 180 s: every attention's key length
    exceeds 8192, so the backward takes the split route; the warm step's
    MFU; then (phase 15) the 170 s step without remat and with encoder
    remat "full" and "dots". Returns the launch counts of the 2 steps, and
    of the remat steps, by wrapper and by C entry."""
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
    calls = reset_entry_calls()
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
    entry_calls = flash_entry_calls(calls, "long-form training", "bfloat16")
    del lm_before
    print_mfu("phase 11 (long-form, Qwen-1.5-1.8B)", model, cfg, [batches[-1]], walls[-1],
              smi_line)
    profile_training_step(torch, trainer, [batches[-1]], name="longform")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_compare(torch, model, params, cfg, [batches[0]], "long-form", smi_line)
    return launches, entry_calls, remat


# ---------------------------------------------------------------------------
# 14. the dataset utilities at full width
# ---------------------------------------------------------------------------

DATASET_SECONDS = tuple(float(s) for s in np.linspace(4.0, 30.0, 16).round(2))


def run_quietly(torch, fn):
    """``(fn()'s result, what it printed, its wall in seconds)``, the wall
    ending in a device sync."""
    import contextlib
    import io

    out = io.StringIO()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn()
    torch.cuda.synchronize()
    return result, out.getvalue(), time.perf_counter() - start


def segment_frames_of(torch, table):
    """Each row's segment lengths from a device segment table."""
    counts = table["num_segments"].cpu().tolist()
    lens = table["out_lens"].cpu().numpy()
    return [lens[i, :n].tolist() for i, n in enumerate(counts)]


def explain_route_mismatch(torch, device, waves, host_frames, dev_frames):
    """For each utterance whose device segment lengths differ from the host
    route's: print the first differing segment, its boundary frame and
    whether the plain mel route on the card gives the kernel route's
    lengths. Returns the utterances where it does: there the device route's
    float32 mel and the host's float64 mel fall on two sides of a near tie
    (tests/test_torch_dataset_scripts.py has one, in JAX too), which no
    kernel fault explains."""
    from aat_tpu_torch.ops import mel, segmentation
    from aat_tpu_torch.ops.mel import normalize_waveform

    shared = []
    for i, (h, d) in enumerate(zip(host_frames, dev_frames)):
        if h == d:
            continue
        j = next((k for k, (a, b) in enumerate(zip(h, d)) if a != b), min(len(h), len(d)))
        w = normalize_waveform(np.asarray(waves[i])).astype(np.float32)
        x = torch.from_numpy(w[None]).to(device)
        lengths = torch.tensor([w.size], device=device)
        plain_mel = mel.melspec_frames_reference(
            mel.frame_waveform_ragged(x, lengths)).transpose(-1, -2)
        plain = segment_frames_of(torch, segmentation.segment_table_from_melspec(
            plain_mel, lengths, segmentation.TokenizerConfig()))[0]
        print(f"dataset: utterance {i} ({w.size / 16000:.2f} s): first differing segment {j}, "
              f"boundary frame {sum(h[:j + 1]) // 160} (host) / {sum(d[:j + 1]) // 160} "
              f"(device), lengths host {h[j:j + 2]} device {d[j:j + 2]}; the plain mel route "
              f"on the card {'agrees with the kernel route' if plain == d else 'differs'}",
              flush=True)
        if plain == d:
            shared.append(i)
    return shared


def phase_dataset(torch, device, rng, smi_line, tmp):
    """14. the dataset utilities at full width, in phase 13's temporary
    directory (its hubert-large and SmolLM-135M directories): a
    ``datasets`` dataset of 16 seeded speech-like utterances of 4-30 s,
    then ``melspec_precompute``, ``audio_tokenization`` on the host route
    and with ``--device-batch 8`` (segment lengths equal on every
    utterance, mel kernel launched), ``tokenize_dense`` chunked (8) against
    flat, ``reduce_seq_len`` against a local alignment dataset,
    ``merge_datasets``, ``dataset_info``, ``inspect_embeddings``,
    ``parity_check --clips 8`` and ``parity_check --weights`` /
    ``--lm-weights`` on phase 13's directories; and the native host
    library: built, the route the tokenizer and the collator took, and one
    collated batch bitwise equal to the numpy route's. Returns the phase's
    launches by wrapper and by C entry."""
    import shutil

    import datasets

    from aat_tpu_torch.data.collate import TokenizedAudioWaveformCollator
    from aat_tpu_torch.ops.mel import normalize_waveform
    from aat_tpu_torch.runtime import host_ops, native
    from aat_tpu_torch.scripts import (audio_tokenization, dataset_info, inspect_embeddings,
                                       melspec_precompute, merge_datasets, parity_check,
                                       reduce_seq_len)
    from aat_tpu_torch.tokenizer import AdaptiveAudioTokenizer, tokenize_dense

    phase_start = time.perf_counter()
    datasets.disable_progress_bars()
    ids = [f"utt{i:02d}" for i in range(len(DATASET_SECONDS))]
    waves = [speechlike_waveform(rng, d) for d in DATASET_SECONDS]
    corpus = os.path.join(tmp, "corpus.dataset")
    datasets.Dataset.from_dict({"id": ids, "audio": [
        {"array": w, "sampling_rate": 16000} for w in waves]}).save_to_disk(corpus)
    walls = {}

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    calls = reset_entry_calls()
    host_ops.reset_calls()

    # melspec_precompute: the host float64 mel, one .npy per id
    mel_dir = os.path.join(tmp, "melspec")
    _, _, walls["melspec_precompute"] = run_quietly(
        torch, lambda: melspec_precompute.main(["--dataset", corpus, "--out", mel_dir]))
    check(sorted(os.listdir(mel_dir)) == [f"{i}.npy" for i in ids], "melspec_precompute files")
    first = np.load(os.path.join(mel_dir, f"{ids[0]}.npy"))
    check(first.shape == (64, waves[0].size // 160 + 1) and np.isfinite(first).all(),
          f"melspec {first.shape}")

    # audio_tokenization: host route, then the device route
    host_out, dev_out = os.path.join(tmp, "host.dataset"), os.path.join(tmp, "device.dataset")
    _, _, walls["audio_tokenization"] = run_quietly(
        torch, lambda: audio_tokenization.main(["--dataset", corpus, "--out", host_out]))
    tokenizer_calls = {r: dict(c) for r, c in host_ops.calls.items()}
    mel_before = wrappers["mel"].launches
    _, _, walls["audio_tokenization --device-batch 8"] = run_quietly(
        torch, lambda: audio_tokenization.main(
            ["--dataset", corpus, "--out", dev_out, "--device-batch", "8"], device=device))
    mel_tokenize = wrappers["mel"].launches - mel_before
    host_frames = datasets.load_from_disk(host_out)["segment_frames"]
    dev_frames = datasets.load_from_disk(dev_out)["segment_frames"]
    differ = [i for i, (h, d) in enumerate(zip(host_frames, dev_frames)) if h != d]
    print(f"dataset audio_tokenization: {len(ids)} utterances of {DATASET_SECONDS[0]}-"
          f"{DATASET_SECONDS[-1]} s, segments per utterance {[len(f) for f in dev_frames]}; "
          f"the device route's segment_frames equal the host route's on "
          f"{len(ids) - len(differ)} of {len(ids)}; mel kernel launches of --device-batch 8: "
          f"{mel_tokenize}", flush=True)
    # a difference passes only where the plain mel route on the card gives
    # the kernel route's lengths too (a float32-vs-float64 near tie)
    shared = explain_route_mismatch(torch, device, waves, host_frames, dev_frames)
    check(shared == differ, f"the device tokenizer's segment lengths differ from the host's on "
          f"utterances {differ}, and the plain mel route on the card does not share "
          f"{sorted(set(differ) - set(shared))}")
    check(mel_tokenize > 0, "audio_tokenization --device-batch never launched the mel kernel")

    # tokenize_dense on the card: chunks of 8 against one flat call
    normed = [normalize_waveform(np.asarray(w)).astype(np.float32) for w in waves]
    x = np.zeros((len(normed), max(w.size for w in normed)), np.float32)
    for i, w in enumerate(normed):
        x[i, : w.size] = w
    xs = torch.from_numpy(x).to(device)
    lengths = torch.tensor([w.size for w in normed], device=device)
    mel_before = wrappers["mel"].launches
    (chunked, flat), _, walls["tokenize_dense"] = run_quietly(torch, lambda: (
        tokenize_dense(xs, lengths, batch_chunk=8), tokenize_dense(xs, lengths, batch_chunk=16)))
    for key in ("starts", "ends", "out_lens", "segment_mask", "num_segments"):
        check(torch.equal(chunked[0][key], flat[0][key]), f"tokenize_dense chunked {key} differs")
    check(torch.equal(chunked[1], flat[1]) and torch.equal(chunked[2], flat[2]),
          "tokenize_dense chunked segments differ from flat")
    check(segment_frames_of(torch, flat[0]) == dev_frames,
          "tokenize_dense's table differs from audio_tokenization's device route")
    print(f"dataset tokenize_dense: [{x.shape[0]}, {x.shape[1]}] -> segments "
          f"{list(flat[1].shape)}, chunked (8) equal to flat (16) on the table and the segments; "
          f"mel launches {wrappers['mel'].launches - mel_before}", flush=True)
    del xs, chunked, flat

    # reduce_seq_len against a local alignment dataset, then merge and info
    words = [[f"w{int(k)}" for k in rng.integers(3, 3000, int(d * WORDS_PER_SECOND))]
             for d in DATASET_SECONDS]
    starts = [np.linspace(0.0, 0.9 * d, len(wd)).tolist() for d, wd in zip(DATASET_SECONDS, words)]
    align_dir = os.path.join(tmp, "alignments")
    datasets.DatasetDict({"train": datasets.Dataset.from_dict({
        "id": ids, "words": words, "word_start": starts,
        "word_end": [[s + 0.2 for s in st] for st in starts]})}).save_to_disk(align_dir)
    aligned = os.path.join(tmp, "aligned.dataset")
    _, _, walls["reduce_seq_len"] = run_quietly(torch, lambda: reduce_seq_len.main(
        ["--segments", host_out, "--alignments", align_dir, "--out", aligned]))
    aligned_ds = datasets.load_from_disk(aligned)
    check(aligned_ds["words"] == words and aligned_ds["segment_frames"] == host_frames,
          "reduce_seq_len's columns")
    merged = os.path.join(tmp, "merged.dataset")
    _, _, walls["merge_datasets"] = run_quietly(torch, lambda: merge_datasets.main(
        ["--shards", host_out, dev_out, "--out", merged]))
    check(len(datasets.load_from_disk(merged)) == 2 * len(ids), "merge_datasets' length")
    _, info, walls["dataset_info"] = run_quietly(
        torch, lambda: dataset_info.main(["--dataset", merged]))
    check(info.startswith(f"items: {2 * len(ids)}"), f"dataset_info printed {info!r}")
    _, shown, walls["inspect_embeddings"] = run_quietly(torch, lambda: inspect_embeddings.main(
        ["--embeddings", mel_dir, "--limit", "4"]))
    check(shown.count("shape (64,") == 4, f"inspect_embeddings printed {shown!r}")
    print("dataset dataset_info: " + " | ".join(info.strip().splitlines()), flush=True)

    # the native host library: built, and the route the tokenizer and the
    # collator took; one collated batch equal to the numpy route's
    lib = native.library()
    check(lib is not None, "the native host library did not build")
    items = [{**aligned_ds[i], "audio": {"array": waves[i], "sampling_rate": 16000}}
             for i in range(4)]
    text = CliWords({w for it in items for w in it["words"]})

    def collated():  # the train command line's adaptive collator
        return TokenizedAudioWaveformCollator(
            "hubert", "adaptive", AdaptiveAudioTokenizer.create(
                min_segment_duration_milliseconds=500, max_segment_duration_milliseconds=250),
            text, n_words=50, uniform_segmentation_frames_per_segment=4000, seed=3)(items)

    host_ops.reset_calls()
    native_batch = collated()
    collator_calls = {r: dict(c) for r, c in host_ops.calls.items()}
    real_library = native.library
    native.library = lambda: None
    try:
        numpy_batch = collated()
    finally:
        native.library = real_library
    differ = [k for k, v in native_batch.items() if isinstance(v, np.ndarray)
              and not np.array_equal(v, numpy_batch[k])]
    print(f"dataset native host route: {os.path.relpath(lib.path, REPO)} (built in this run: "
          f"{lib.built}); the host tokenizer's calls {tokenizer_calls}; one adaptive collator "
          f"batch {collator_calls['native']}, every field bitwise equal to the numpy route's: "
          f"{not differ}", flush=True)
    for entry in ("smoothed_amplitude", "find_minima"):
        check(tokenizer_calls["native"][entry] > 0 and tokenizer_calls["numpy"][entry] == 0,
              f"the host tokenizer did not take the native {entry}")
    for entry in ("normalize_pad", "assemble_segments"):
        check(collator_calls["native"][entry] > 0 and sum(collator_calls["numpy"].values()) == 0,
              f"the collator did not take the native {entry}")
    check(not differ, f"the native and numpy collator routes differ on {differ}")

    # parity_check: the boundary checks, then the read checkpoints
    enc_dir, lm_dir = os.path.join(tmp, "hubert-large"), os.path.join(tmp, "smollm-135m")
    for label, argv in (("--clips 8", ["--clips", "8"]),
                        ("--weights --lm-weights", ["--clips", "0", "--weights", enc_dir,
                                                    "--lm-weights", lm_dir])):
        code, out, walls[f"parity_check {label}"] = run_quietly(
            torch, lambda: parity_check.main(argv, device=device))
        for line in out.strip().splitlines():
            if not line.startswith("ported"):
                print(f"dataset parity_check {label}: {line}", flush=True)
        check(code == 0 and "PARITY: PASS" in out, f"parity_check {label} failed")
    launches = {n: w.launches for n, w in wrappers.items()}
    calls = dict(calls)
    print(f"dataset walls ({smi_line}): " + "; ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; phase {time.perf_counter() - phase_start:.1f} s; launches {launches}", flush=True)
    for path in (corpus, mel_dir, host_out, dev_out, align_dir, aligned, merged):
        shutil.rmtree(path, ignore_errors=True)
    return launches, calls


# ---------------------------------------------------------------------------
# 15. the trainer's pieces at full width: remat, unfreeze, Adafactor, the
#     unfused AdamW chain, MFU
# ---------------------------------------------------------------------------


def step_flops(model, cfg, micro):
    """Model FLOPs of one optimizer step over the microbatches ``micro``
    (``utils/flops``: padded samples, whole utterances)."""
    from aat_tpu_torch.utils import flops

    return sum(flops.aslm_train_step_flops(
        model.audio_encoder_config, model.lm_config, model.config, int(b["waveforms"].shape[0]),
        None, int(b["waveforms"].shape[1]), int(b["input_ids"].shape[1]),
        cfg.train_audio_encoder, cfg.train_lm_decoder)["total"] for b in micro)


def print_mfu(label, model, cfg, micro, wall, smi_line):
    from aat_tpu_torch.utils import flops

    total = step_flops(model, cfg, micro)
    print(f"mfu: {label} warm step {total / 1e12:.3f} TFLOP (utils/flops, model FLOPs) in "
          f"{wall:.3f} s: MFU {flops.mfu(total, wall):.4f} of {flops.H100_BF16_PEAK / 1e12:.0f} "
          f"TFLOP/s ({smi_line})", flush=True)


class DeterministicCudnn:
    """cuDNN's deterministic algorithms inside a ``with`` block (the runs
    compared bit for bit)."""

    def __init__(self, torch):
        self.backends = torch.backends.cudnn

    def __enter__(self):
        self.saved = self.backends.deterministic
        self.backends.deterministic = True

    def __exit__(self, *exc):
        self.backends.deterministic = self.saved
        return False


def remat_compare(torch, model, params, cfg, micro, label, smi_line,
                  policies=("none", "full", "dots"), flash=True):
    """One optimizer step from the same state without remat and with
    encoder remat under ``policies`` (fresh trainers; the LM frozen): the
    losses and the updated parameters must be equal bit for bit, and, on a
    ``flash`` path, the encoder's flash forwards twice as many under remat
    (the recompute). Prints the peak memory and wall of each. Returns the
    remat steps' launches by wrapper and by C entry."""
    from aat_tpu_torch.models.aslm import AslmModel
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.checkpoint import flatten
    from aat_tpu_torch.training.trainer import AATTrainer

    trained = {k: params[k] for k in ("audio_encoder", "adapter")}
    # the starting state and the first step's result wait on the host, so
    # each step's peak counts only what the step itself holds on the card
    initial = optim.tree_map(lambda x: x.detach().to("cpu", copy=True), trained)
    wrappers = kernel_wrappers()
    remat_launches = dict.fromkeys(wrappers, 0)
    remat_calls = None
    runs, want = {}, None
    with DeterministicCudnn(torch):
        for policy in policies:
            with torch.no_grad():
                optim.tree_map(lambda p, x: p.copy_(x), trained, initial)
            enc_cfg = dataclasses.replace(model.audio_encoder_config, remat=policy != "none",
                                          remat_policy="full" if policy == "none" else policy)
            trainer = AATTrainer(AslmModel(model.config, enc_cfg, model.lm_config,
                                           model.audio_encoder_type), params, cfg)
            for w in wrappers.values():
                w.launches = 0
            calls = reset_entry_calls()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            loss = trainer.training_step(micro)["train/loss"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = {n: w.launches for n, w in wrappers.items()}
            if policy != "none":
                if flash:
                    flash_entry_calls(calls, f"{label} remat {policy}", "bfloat16")
                for n in remat_launches:
                    remat_launches[n] += launches[n]
                remat_calls = {e: (remat_calls or {}).get(e, 0) + c for e, c in calls.items()}
            state = {k: v.cpu() for k, v in flatten(trained).items()}
            if want is None:
                want = state
                differ, worst = [], 0.0
            else:
                differ = [k for k, v in state.items() if not torch.equal(v, want[k])]
                worst = max((float((state[k] - want[k]).abs().max()) for k in differ), default=0.0)
            del state
            runs[policy] = (loss, peak, wall, launches["flash_fwd"], len(differ), worst)
            del trainer
    with torch.no_grad():
        optim.tree_map(lambda p, x: p.copy_(x), trained, initial)
    del initial, want
    base = runs["none"]
    print(f"remat {label} ({smi_line}): " + "; ".join(
        f"{p}: loss {r[0]:.6f}, peak {r[1]:.2f} GiB, wall {r[2]:.3f} s, encoder flash forwards "
        f"{r[3]}, params differing from no remat {r[4]} (max abs {r[5]:.3e})"
        for p, r in runs.items()), flush=True)
    for policy in policies[1:]:
        loss, peak, wall, fwd, n_differ, _ = runs[policy]
        check(loss == base[0] and n_differ == 0,
              f"{label} remat {policy}: the step differs from no remat")
        check(fwd == 2 * base[3] if flash else fwd == base[3] == 0,
              f"{label} remat {policy}: {fwd} flash forwards, no remat {base[3]}")
    return remat_launches, remat_calls


def optimizer_steps(torch, model, params, cfg, steps, tmp, smi_line):
    """3 whole-utterance steps with Adafactor (relative step, under the
    guard), a save, one more step, and a fresh trainer restored from the
    save taking the same step bit for bit; then 3 steps of the unfused
    AdamW chain. Finite losses, the frozen LM unchanged. Returns the
    launches by wrapper and by C entry."""
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.checkpoint import flatten
    from aat_tpu_torch.training.trainer import AATTrainer

    trained = {k: params[k] for k in ("audio_encoder", "adapter")}
    initial = optim.tree_map(lambda x: x.detach().clone(), trained)
    lm_before = [x.clone() for x in optim.tree_leaves(params["lm_decoder"])]
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    calls = reset_entry_calls()

    def state_of(trainer):
        return {**{f"params.{k}": v for k, v in flatten(trainer.state.params).items()},
                **{f"opt.{k}": v for k, v in flatten(trainer.state.opt_state).items()}}

    with DeterministicCudnn(torch):
        # Adafactor, learning_rate=None
        ada_cfg = dataclasses.replace(cfg, optimizer="adafactor", learning_rate=None,
                                      output_dir=os.path.join(tmp, "adafactor"))
        a = AATTrainer(model, params, ada_cfg)
        start = time.perf_counter()
        losses = [a.training_step(micro)["train/loss"] for micro in steps]
        torch.cuda.synchronize()
        ada_s = time.perf_counter() - start
        path = a.save_checkpoint()
        a.training_step(steps[0])
        want = {k: v.clone() for k, v in state_of(a).items()}
        b = AATTrainer(model, params, ada_cfg)
        b.restore_checkpoint(path)
        b.training_step(steps[0])
        got = state_of(b)
        differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        print(f"adafactor ({smi_line}): 3 steps (relative step, guarded), losses "
              f"{[round(x, 5) for x in losses]}, {ada_s:.3f} s; state "
              f"{sorted({'.'.join(k.split('.')[1:3]) for k in want if k.startswith('opt.')})}; "
              f"save, restore "
              f"in a fresh trainer and one more step: {len(want) - len(differ)} of {len(want)} "
              f"tensors equal bit for bit", flush=True)
        check(all(np.isfinite(losses)), f"non-finite Adafactor losses {losses}")
        check(not differ and set(got) == set(want), f"Adafactor resume differs on {differ[:5]}")
        del a, b, want, got
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            optim.tree_map(lambda p, x: p.copy_(x), trained, initial)

        # the unfused AdamW chain
        c = AATTrainer(model, params, dataclasses.replace(cfg, skip_nonfinite_updates=False))
        start = time.perf_counter()
        losses = [c.training_step(micro)["train/loss"] for micro in steps]
        torch.cuda.synchronize()
        unfused_s = time.perf_counter() - start
        check(isinstance(c.state.opt_state, optim.ScaleByAdamState), "not the unfused chain")
        print(f"adamw unfused (skip_nonfinite_updates=False): 3 steps, losses "
              f"{[round(x, 5) for x in losses]}, {unfused_s:.3f} s", flush=True)
        check(all(np.isfinite(losses)), f"non-finite unfused AdamW losses {losses}")
        del c
    launches = {n: w.launches for n, w in wrappers.items()}
    calls = flash_entry_calls(calls, "optimizer steps", "bfloat16")
    check(all(torch.equal(a, b) for a, b in zip(lm_before, optim.tree_leaves(params["lm_decoder"]))),
          "a frozen LM weight changed under Adafactor or the unfused chain")
    with torch.no_grad():
        optim.tree_map(lambda p, x: p.copy_(x), trained, initial)
    import shutil

    shutil.rmtree(os.path.join(tmp, "adafactor"), ignore_errors=True)
    return launches, calls


def phase_trainer_pieces(torch, model, params, rng, smi_line):
    """15, on phase 8's model and weights: remat of the whole-utterance step
    (2 microbatches of 2 utterances), then Adafactor and the unfused chain.
    Returns {path: (launches, calls)}."""
    import shutil
    import tempfile

    from aat_tpu_torch.runtime.kernels import BUILD_DIR
    from aat_tpu_torch.training.config import projection_training_config

    device = params["lm_decoder"]["embed_tokens"]["embedding"].device
    cfg = dataclasses.replace(projection_training_config(), per_device_train_batch_size=2,
                              gradient_accumulation_steps=2)
    steps = training_batches(torch, device, rng, n_steps=3, accum=2)
    out = {"train_remat": remat_compare(torch, model, params, cfg, steps[0], "whole-utterance",
                                        smi_line)}
    tmp = tempfile.mkdtemp(prefix="optim_", dir=BUILD_DIR)
    try:
        out["train_optimizers"] = optimizer_steps(torch, model, params, cfg, steps, tmp, smi_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_unfreeze_cli(torch, device, rng, smi_line, tmp):
    """15, the LM unfreeze through the train command line on phase 13's
    directories: ``--unfreeze-lm-at-epoch 1``, 2 epochs of 4 steps of 2
    utterances, saves every 3 steps. SmolLM's weights must stay bit for bit
    the read ones through epoch 0 and move in epoch 1; a run resumed from
    ``checkpoint-6`` (after the unfreeze: it unfreezes before restoring)
    must end on run A's ``checkpoint-8`` bit for bit. Returns run A's
    launches by wrapper and by C entry."""
    import shutil

    from aat_tpu_torch.scripts import train
    from aat_tpu_torch.training.checkpoint import flatten
    from aat_tpu_torch.training.trainer import AATTrainer

    enc_dir, lm_dir = os.path.join(tmp, "hubert-large"), os.path.join(tmp, "smollm-135m")
    items = cli_items(rng, CLI_TRAIN_SECONDS, "unfreeze")
    valid = cli_items(rng, CLI_VALID_SECONDS[:2], "unfreeze-valid")
    tokenizer = CliWords({w for it in items + valid for w in it["words"]})
    splits = {"train": items, "valid": valid}
    real = {name: getattr(train, name) for name in ("load_hf_dataset", "build_tokenizer")}
    methods = {name: getattr(AATTrainer, name) for name in ("training_step", "unfreeze_lm_decoder")}
    seen = {}

    def lm_copy(trainer):
        return {k: v.detach().cpu().clone() for k, v in flatten(
            trainer.state.params["lm_decoder"]).items()}

    def first_step(self, *args, **kw):
        seen.setdefault("start", (self.state.step, lm_copy(self)))
        return methods["training_step"](self, *args, **kw)

    def unfreeze(self):
        seen["unfreeze"] = (self.state.step, lm_copy(self))
        return methods["unfreeze_lm_decoder"](self)

    argv = ["--pretrained", "--audio-encoder-checkpoint", enc_dir, "--lm-pretrained-model",
            lm_dir, "--per-device-train-batch-size", "2", "--gradient-accumulation-steps", "1",
            "--num-train-epochs", "2", "--unfreeze-lm-at-epoch", "1", "--eval-steps", "0",
            "--save-steps", "3", "--logging-steps", "1", "--no-load-best-model-at-end"]
    out_a, out_b = (os.path.join(tmp, f"u{x}_1_linear_none") for x in "ab")
    wrappers = kernel_wrappers()
    try:
        train.load_hf_dataset = lambda name, split=None: splits[split]
        train.build_tokenizer = lambda config: tokenizer
        AATTrainer.training_step = first_step
        AATTrainer.unfreeze_lm_decoder = unfreeze
        for w in wrappers.values():
            w.launches = 0
        calls = reset_entry_calls()
        with DeterministicCudnn(torch):
            start = time.perf_counter()
            trainer = train.main(argv + ["--output-dir", os.path.join(tmp, "ua")], device=device)
            torch.cuda.synchronize()
            a_s = time.perf_counter() - start
            launches = {n: w.launches for n, w in wrappers.items()}
            calls = flash_entry_calls(calls, "unfreeze cli run A", "bfloat16")
            final = lm_copy(trainer)
            del trainer
            step0, lm_start = seen["start"]
            step_u, lm_unfreeze = seen.pop("unfreeze")
            frozen_ok = all(torch.equal(lm_start[k], v) for k, v in lm_unfreeze.items())
            moved = sum(not torch.equal(final[k], v) for k, v in lm_unfreeze.items())
            with open(os.path.join(out_a, "metrics.jsonl")) as f:
                losses = [m["train/loss"] for m in map(json.loads, f) if "train/loss" in m]
            print(f"unfreeze cli run A (--unfreeze-lm-at-epoch 1, 2 epochs of 4 steps): wall "
                  f"{a_s:.3f} s; unfrozen at step {step_u}; SmolLM through epoch 0 bit for bit "
                  f"the read weights: {frozen_ok}; moved in epoch 1: {moved} of {len(final)} "
                  f"tensors; losses {[round(x, 5) for x in losses]}; launches {launches}",
                  flush=True)
            check(step0 == 0 and step_u == 4 and frozen_ok, "the LM moved before its unfreeze")
            check(moved > 0 and all(np.isfinite(losses)) and len(losses) == 8,
                  f"unfreeze run A: {moved} LM tensors moved, losses {losses}")
            check(launches["flash_bwd_causal"] > 0, "no causal backward after the unfreeze")
            resume = os.path.join(out_a, "checkpoint-6")
            with open(os.path.join(resume, "trainer_meta.json")) as f:
                check(json.load(f)["train_lm_decoder"] is True, "checkpoint-6 has a frozen LM")
            start = time.perf_counter()
            train.main(argv + ["--output-dir", os.path.join(tmp, "ub"),
                               "--resume-from-checkpoint", resume], device=device)
            torch.cuda.synchronize()
            b_s = time.perf_counter() - start
        want = checkpoint_tensors(torch, os.path.join(out_a, "checkpoint-8"))
        got = checkpoint_tensors(torch, os.path.join(out_b, "checkpoint-8"))
        differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        lm_moments = sum(k.startswith("optimizer.mu.lm_decoder") for k in want)
        print(f"unfreeze cli run B (resumed from checkpoint-6, after the unfreeze): wall "
              f"{b_s:.3f} s; checkpoint-8 equal to run A's on {len(want) - len(differ)} of "
              f"{len(want)} tensors ({lm_moments} LM first moments among them), bit for bit",
              flush=True)
        check(set(got) == set(want) and not differ and lm_moments > 0,
              f"the resumed unfreeze run differs on {differ[:5]}")
    finally:
        for name, fn in real.items():
            setattr(train, name, fn)
        for name, fn in methods.items():
            setattr(AATTrainer, name, fn)
        for out in (out_a, out_b):
            shutil.rmtree(out, ignore_errors=True)
    return launches, calls



# ---------------------------------------------------------------------------
# 16. the transformer_encoder projection and EfficientNet-b0 at full width
# ---------------------------------------------------------------------------

# 3 steps of 2 microbatches of 2 raw-waveform utterances in phase 5's range
POOLING_SECONDS = (2.0, 4.5, 12.0, 7.0, 3.2, 9.5, 5.5, 10.5, 2.6, 8.0, 6.2, 11.0)
# LibriSpeech-long utterances for EfficientNet: with captions at 3.5 words a
# second and no n_words crop every LM row passes MIN_PALLAS_SEQ_LEN (256)
EFFNET_SECONDS = (28.0, 35.0, 31.5, 33.0, 29.5, 34.5, 30.5, 32.0, 30.0, 33.5, 28.5, 34.0)
# the train command line of phase 16c, in phase 13's directory
PROJECTION_CLI_SECONDS = (8.0, 10.0, 12.0, 9.0)


def raw_waveform_batches(torch, device, rng, seconds, accum=2, per_batch=2):
    """Steps of ``accum`` microbatches of ``per_batch`` raw speech-like
    utterances (``raw_waveforms`` / ``raw_lengths``, padded as serving
    pads them), random caption ids of 32-48 tokens and a 4-token text
    prefix; and the utterances of each microbatch."""
    steps, waves_by_batch = [], []
    durations = iter(seconds)
    for _ in range(len(seconds) // (accum * per_batch)):
        micro = []
        for _ in range(accum):
            waves = [speechlike_waveform(rng, next(durations)) for _ in range(per_batch)]
            x, lengths = padded_batch(torch, waves, device)
            cap_lens = rng.integers(32, 49, per_batch)
            ids = np.zeros((per_batch, int(cap_lens.max())), np.int64)
            cmask = np.zeros(ids.shape, np.int32)
            for i, c in enumerate(cap_lens):
                ids[i, :c], cmask[i, :c] = rng.integers(3, 49152, c), 1
            ids[:, 0] = 1
            micro.append({"raw_waveforms": x, "raw_lengths": lengths, **{
                k: torch.from_numpy(v).to(device) for k, v in (
                    ("input_ids", ids), ("attention_mask", cmask),
                    ("input_ids_attention_mask", cmask), ("prefix_input_ids", ids[:, :4]),
                    ("prefix_attention_mask", np.ones((per_batch, 4), np.int32)))}})
            waves_by_batch.append(waves)
        steps.append(micro)
    return steps, waves_by_batch


def plain_mel_segmentation():
    """``segment_waveforms`` through mel's plain version (phase 5's plain
    route), for a trainer's on-device segmentation."""
    from aat_tpu_torch.ops import mel, segmentation

    def segment(norm, lengths, cfg):
        plain = mel.melspec_frames_reference(mel.frame_waveform_ragged(norm, lengths))
        return segmentation.segment_table_from_melspec(plain.transpose(-1, -2), lengths, cfg)

    return segment


def run_steps(torch, trainer, steps):
    """The optimizer steps with counts set to 0 first: (losses, walls,
    launches by wrapper, launches by C entry, last metrics)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    calls = reset_entry_calls()
    torch.cuda.synchronize()
    losses, walls = [], []
    for micro in steps:
        start = time.perf_counter()
        metrics = trainer.training_step(micro)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        losses.append(metrics["train/loss"])
    return losses, walls, {n: w.launches for n, w in wrappers.items()}, dict(calls), metrics


def f32_routes(torch, kernel_model, plain_model, params, cfg, micro, label, segment=None):
    """One f32 gradient step through the kernel route and the plain route
    (``plain_model``; ``segment`` replaces the on-device segmentation),
    same seeds: loss and gradient norm within ``TRAIN_REL_TOL``. Returns
    the kernel route's launches by wrapper."""
    from aat_tpu_torch.data import ondevice
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.trainer import AATTrainerSegmentation

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    wrappers = kernel_wrappers()
    routes, launches = {}, {}
    real = ondevice.segment_waveforms
    for name, m in (("kernel", kernel_model), ("plain", plain_model)):
        for w in wrappers.values():
            w.launches = 0
        reset_entry_calls()
        if name == "plain" and segment is not None:
            ondevice.segment_waveforms = segment
        try:
            t = AATTrainerSegmentation(m, params, f32)
            grads, metrics, _ = t._grad_step(params, t._to_device(micro), t.dropout_seed(0, 0))
            routes[name] = (metrics["train/loss"].item(), optim.global_norm(grads).item())
        finally:
            ondevice.segment_waveforms = real
        launches[name] = {n: w.launches for n, w in wrappers.items()}
        del t, grads
        torch.cuda.empty_cache()
    (loss_k, norm_k), (loss_p, norm_p) = routes["kernel"], routes["plain"]
    print(f"{label} f32 routes: loss kernel {loss_k:.6f} plain {loss_p:.6f}; grad norm kernel "
          f"{norm_k:.6e} plain {norm_p:.6e}; launches kernel route {launches['kernel']}, plain "
          f"route {sum(launches['plain'].values())}", flush=True)
    check(abs(loss_k - loss_p) <= TRAIN_REL_TOL * abs(loss_p), f"{label}: f32 losses differ")
    check(abs(norm_k - norm_p) <= TRAIN_REL_TOL * norm_p, f"{label}: f32 grad norms differ")
    check(sum(launches["plain"].values()) == 0, f"{label}: the plain route launched a kernel")
    return launches["kernel"]


def evaluate_once(torch, trainer, batch, label, vocab):
    """``evaluate(with_generation=True)`` on one batch, then its beam ids."""
    start = time.perf_counter()
    metrics = trainer.evaluate([batch], with_generation=True)
    ids = trainer.generate_for_batch(batch)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - start
    print(f"{label} evaluate(with_generation=True), 1 batch: eval/loss {metrics['eval/loss']:.5f}; "
          f"beam ids {ids.shape}, first {ids[0][:8].tolist()}; {eval_s:.3f} s", flush=True)
    check(np.isfinite(metrics["eval/loss"]), f"{label}: eval loss {metrics['eval/loss']}")
    check(ids.ndim == 2 and bool(((ids >= 0) & (ids < vocab)).all()), f"{label}: beam ids")


def phase_pooling(torch, model, params, rng, smi_line):
    """16a, ``train_pooling``: the transformer_encoder projection on phase
    8's hubert-large and SmolLM-135M, a fresh pooling adapter (the default
    PoolingConfig, dropout 0.1), adaptive segmentation on the device, bf16
    over f32 masters: 3 steps of 2 microbatches of 2 raw-waveform
    utterances of 2-12 s; then an f32 step through the kernel and plain
    routes, the step under remat "dots" against no remat (bit for bit, the
    plain attention route the repair changed), evaluate with generation,
    and the warm step's MFU. Returns the steps' launches by wrapper and by
    C entry."""
    import types

    from aat_tpu_torch.models.aslm import AslmModel, init_aslm_params
    from aat_tpu_torch.ops import attention
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.config import projection_training_config
    from aat_tpu_torch.training.trainer import AATTrainerSegmentation
    from aat_tpu_torch.utils import flops

    device = params["lm_decoder"]["embed_tokens"]["embedding"].device
    aslm_cfg = dataclasses.replace(model.config, projection_type="transformer_encoder")
    pmodel = AslmModel(aslm_cfg, model.audio_encoder_config, model.lm_config)
    start = time.perf_counter()
    adapter = init_aslm_params((0, 16), aslm_cfg, device)
    pparams = {"audio_encoder": params["audio_encoder"], "adapter": adapter,
               "lm_decoder": params["lm_decoder"]}
    n_adapter = sum(x.numel() for x in optim.tree_leaves(adapter))
    cfg = dataclasses.replace(projection_training_config(), projection_type="transformer_encoder",
                              segmentation="adaptive", per_device_train_batch_size=2,
                              gradient_accumulation_steps=2)
    steps, waves = raw_waveform_batches(torch, device, rng, POOLING_SECONDS)
    # the settings phase_segment_tables reads, as the trainer segments
    slots = types.SimpleNamespace(max_segments=cfg.max_on_device_segments,
                                  max_segment_frames=cfg.max_segment_frames)
    counts = [phase_segment_tables(torch, device, w, slots) for w in waves]
    print(f"pooling: transformer_encoder adapter {n_adapter} parameters ({aslm_cfg.pooling}, "
          f"dropout {aslm_cfg.dropout}), init {time.perf_counter() - start:.1f} s; segments per "
          f"utterance {counts} (capped at {slots.max_segments}), kernel and plain mel routes' "
          f"segment tables equal", flush=True)
    check(all(0 < c <= slots.max_segments for cs in counts for c in cs), f"segments {counts}")

    trainer = AATTrainerSegmentation(pmodel, pparams, cfg)
    lm_before = [x.clone() for x in optim.tree_leaves(pparams["lm_decoder"])]
    watched = {"adapter/pooling/layers/0/attention/in_proj/kernel":
               adapter["pooling"]["layers"][0]["attention"]["in_proj"]["kernel"],
               "audio_encoder/feature_projection/projection/kernel":
               pparams["audio_encoder"]["feature_projection"]["projection"]["kernel"]}
    before = {k: v.clone() for k, v in watched.items()}
    losses, walls, launches, calls, metrics = run_steps(torch, trainer, steps)
    print(f"train_pooling ({smi_line}): 3 steps x 2 microbatches x 2 utterances, bf16, losses "
          f"{[round(x, 5) for x in losses]}, LM sequence length {metrics['debug/seq_len']:.0f}, "
          f"step walls {[round(x, 3) for x in walls]} s (warm {walls[-1]:.3f} s), skipped "
          f"{metrics['train/skipped_nonfinite_total']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {launches}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite pooling losses {losses}")
    check(metrics["train/skipped_nonfinite_total"] == 0.0, "a pooling update was dropped")
    check(all(torch.equal(a, b) for a, b in zip(lm_before, optim.tree_leaves(pparams["lm_decoder"]))),
          "a frozen LM weight changed under the pooling projection")
    for name, old in before.items():
        check(not torch.equal(old, watched[name]), f"trained weight {name} did not move")
    check(launches["mel"] > 0, "pooling training never launched the mel kernel")
    check(metrics["debug/seq_len"] < attention.MIN_PALLAS_SEQ_LEN,
          "the pooling rows reach the flash gate; the path is meant to be the plain one")
    del lm_before, before
    total = sum(flops.aslm_train_step_flops(
        pmodel.audio_encoder_config, pmodel.lm_config, aslm_cfg, 2, cfg.max_on_device_segments,
        cfg.max_segment_frames, int(b["input_ids"].shape[1]), cfg.train_audio_encoder,
        cfg.train_lm_decoder)["total"] for b in steps[-1])
    print(f"mfu: phase 16a (segmented, transformer_encoder, {cfg.max_on_device_segments} segment "
          f"slots of {cfg.max_segment_frames} samples a row, as the step computes them) warm step "
          f"{total / 1e12:.3f} TFLOP (utils/flops) in {walls[-1]:.3f} s: MFU "
          f"{flops.mfu(total, walls[-1]):.4f} of {flops.H100_BF16_PEAK / 1e12:.0f} TFLOP/s "
          f"({smi_line})", flush=True)

    plain = AslmModel(aslm_cfg,
                      dataclasses.replace(pmodel.audio_encoder_config, attention_impl="xla"),
                      dataclasses.replace(pmodel.lm_config, attention_impl="xla"))
    kernel_launches = f32_routes(torch, pmodel, plain, pparams, cfg, steps[0][0], "train_pooling",
                                 segment=plain_mel_segmentation())
    check(kernel_launches["mel"] > 0, "the f32 kernel route never launched the mel kernel")
    # the repaired "dots": attention's bmm products recomputed, no others
    remat_compare(torch, pmodel, pparams, cfg, steps[0], "segmented pooling", smi_line,
                  policies=("none", "dots"), flash=False)
    evaluate_once(torch, trainer, steps[0][0], "train_pooling", pmodel.lm_config.vocab_size)
    del trainer, adapter, pparams
    gc.collect()
    torch.cuda.empty_cache()
    return launches, calls


def phase_efficientnet(torch, lm_params, lm_cfg, device, rng, smi_line):
    """16b, ``train_efficientnet``: EfficientNet-b0 (seeded random init),
    the linear projection (1280 wide) and phase 8's SmolLM-135M, on melspec
    batches of the train command line's adaptive collator from seeded
    utterances of 28-35 s with no n_words crop, so every LM row reaches the
    flash gate: 3 steps of 2 microbatches of 2 utterances with the encoder
    trained (the causal flash kernels through the bf16 entries; the stem's
    BN running mean the EMA of its 6 folds); one more
    step with it frozen, which moves the BN running statistics and nothing
    else of the encoder; an f32 step through the kernel and plain routes;
    evaluate with generation (eval-mode BN). Returns the 3 steps' launches
    by wrapper and by C entry."""
    from aat_tpu_torch.models.aslm import AslmConfig, AslmModel, init_aslm_params
    from aat_tpu_torch.models.efficientnet import (
        BN_MOMENTUM, EfficientNetConfig, init_efficientnet_params,
    )
    from aat_tpu_torch.ops import attention
    from aat_tpu_torch.scripts import train
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.checkpoint import flatten
    from aat_tpu_torch.training.config import projection_training_config
    from aat_tpu_torch.training.trainer import AATTrainerSegmentation

    aslm_cfg = AslmConfig(projection_type="linear", audio_encoder_hidden=1280,
                          lm_hidden=lm_cfg.hidden_size)
    emodel = AslmModel(aslm_cfg, EfficientNetConfig(), lm_cfg, audio_encoder_type="efficient_net")
    eparams = {"audio_encoder": init_efficientnet_params(0, device),
               "adapter": init_aslm_params((0, 17), aslm_cfg, device), "lm_decoder": lm_params}
    cfg = dataclasses.replace(projection_training_config(), audio_encoder_type="efficient_net",
                              segmentation="adaptive", n_words=None,
                              per_device_train_batch_size=2, gradient_accumulation_steps=2)
    items = cli_items(rng, EFFNET_SECONDS, "effnet")
    tokenizer = CliWords({w for it in items for w in it["words"]})
    collate, _ = train.make_collator(cfg, tokenizer)
    start = time.perf_counter()
    steps = [[collate(items[4 * s + 2 * m: 4 * s + 2 * m + 2]) for m in range(2)]
             for s in range(3)]
    collate_s = time.perf_counter() - start
    rows = [2 + b["batched_segments_melspectrograms"].shape[1] + b["input_ids"].shape[1]
            for micro in steps for b in micro]
    shapes = [tuple(b["batched_segments_melspectrograms"].shape) for micro in steps for b in micro]
    print(f"efficientnet: melspec batches {shapes} from the train command line's adaptive "
          f"collator ({collate_s:.2f} s); LM rows T {rows} (flash gate "
          f"{attention.MIN_PALLAS_SEQ_LEN})", flush=True)
    check(min(rows) >= attention.MIN_PALLAS_SEQ_LEN, f"LM rows {rows} below the flash gate")

    encoder = eparams["audio_encoder"]
    stem_bn = encoder["stem"]["bn"]
    mean0 = stem_bn["mean"].clone()
    lm_before = [x.clone() for x in optim.tree_leaves(lm_params)]
    watched = {"audio_encoder/blocks/5/dw_conv/kernel": encoder["blocks"][5]["dw_conv"]["kernel"],
               "adapter/projection/in/kernel": eparams["adapter"]["projection"]["in"]["kernel"]}
    before = {k: v.clone() for k, v in watched.items()}
    trainer = AATTrainerSegmentation(emodel, eparams, cfg)
    folded = []  # each microbatch's stem statistics, in the order they fold
    fold = trainer._fold_bn_stats

    def record(stats_seq):
        folded.extend(s["stem"]["bn"]["mean"].clone() for s in stats_seq)
        return fold(stats_seq)

    trainer._fold_bn_stats = record
    losses, walls, launches, calls, metrics = run_steps(torch, trainer, steps)
    trainer._fold_bn_stats = fold
    shift = float((stem_bn["mean"] - mean0).abs().max())
    # the running mean, folded again here from the recorded statistics
    ema = mean0.clone()
    for batch_mean in folded:
        ema = (1.0 - BN_MOMENTUM) * ema + BN_MOMENTUM * batch_mean
    ema_err = float((ema - stem_bn["mean"]).abs().max())
    # k EMAs move a running value by at most 1 - (1 - m)^k of its distance
    # to the farthest batch value
    reach = (1.0 - (1.0 - BN_MOMENTUM) ** len(folded)) * max(
        float((b - mean0).abs().max()) for b in folded)
    print(f"train_efficientnet ({smi_line}): 3 steps x 2 microbatches x 2 utterances, encoder "
          f"trained, bf16, losses {[round(x, 5) for x in losses]}, step walls "
          f"{[round(x, 3) for x in walls]} s (warm {walls[-1]:.3f} s), stem BN running mean "
          f"moved by {shift:.3e} ({len(folded)} folds, at most {reach:.3e}; the recorded "
          f"statistics folded again differ by {ema_err:.3e}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {launches}", flush=True)
    check(all(np.isfinite(losses)), f"non-finite EfficientNet losses {losses}")
    check(metrics["train/skipped_nonfinite_total"] == 0.0, "an EfficientNet update was dropped")
    check(all(torch.equal(a, b) for a, b in zip(lm_before, optim.tree_leaves(lm_params))),
          "a frozen LM weight changed under EfficientNet")
    for name, old in before.items():
        check(not torch.equal(old, watched[name]), f"trained weight {name} did not move")
    # two EMAs of momentum 0.01 a step, in microbatch order
    check(len(folded) == 6 and 0.0 < shift <= reach * (1 + 1e-6),
          f"the stem BN running mean moved by {shift} in {len(folded)} folds (reach {reach})")
    check(ema_err <= 1e-6 * max(1.0, float(ema.abs().max())),
          f"the stem BN running mean is not the EMA of its folds ({ema_err})")
    for name in ("flash_fwd_causal", "flash_bwd_causal"):
        check(launches[name] > 0, f"EfficientNet training never launched {name}")
    flash_entry_calls(calls, "train_efficientnet", "bfloat16")
    del lm_before, before

    # the fold moves the running statistics and nothing else: one more step
    # with the encoder frozen leaves every other encoder leaf bit for bit
    held = {k: v.clone() for k, v in flatten(encoder).items()}
    frozen = AATTrainerSegmentation(emodel, eparams,
                                    dataclasses.replace(cfg, train_audio_encoder=False))
    frozen.training_step(steps[0])
    stats = {k for k in held if k.endswith((".mean", ".var"))}
    moved = {k for k, v in flatten(encoder).items() if not torch.equal(v, held[k])}
    print(f"efficientnet, one step with the encoder frozen: {len(moved)} of {len(held)} encoder "
          f"tensors moved, all of them among the {len(stats)} BN running statistics", flush=True)
    check(moved and moved <= stats, f"frozen encoder: {sorted(moved - stats)[:5]} moved")
    del frozen, held

    plain = AslmModel(aslm_cfg, EfficientNetConfig(),
                      dataclasses.replace(lm_cfg, attention_impl="xla"),
                      audio_encoder_type="efficient_net")
    reset_entry_calls()
    kernel_launches = f32_routes(torch, emodel, plain, eparams, cfg, steps[0][0],
                                 "train_efficientnet")
    check(kernel_launches["flash_fwd_causal"] > 0 and kernel_launches["flash_bwd_causal"] > 0,
          "the f32 kernel route never launched the causal flash kernels")
    evaluate_once(torch, trainer, steps[0][0], "train_efficientnet", lm_cfg.vocab_size)
    del trainer, eparams, encoder
    gc.collect()
    torch.cuda.empty_cache()
    return launches, calls


def phase_projection_cli(torch, device, rng, smi_line, tmp):
    """16c, in phase 13's directory: ``python -m aat_tpu_torch.scripts.train
    --audio-encoder-type efficient_net --projection-type transformer_encoder
    --segmentation adaptive`` with SmolLM read from its seeded directory
    and EfficientNet's random init after JAX's warning, 1 epoch of 2 steps;
    ``scripts.validate`` on its export; the export's ``config.json`` read
    back by ``load_pretrained``, its params bit for bit. Returns the run's
    launches by wrapper and by C entry."""
    import contextlib
    import io
    import logging
    import shutil

    from aat_tpu_torch.models.aslm import PoolingConfig
    from aat_tpu_torch.models.build import load_pretrained
    from aat_tpu_torch.models.efficientnet import EfficientNetConfig
    from aat_tpu_torch.scripts import train, validate
    from aat_tpu_torch.training.checkpoint import flatten

    lm_dir = os.path.join(tmp, "smollm-135m")
    items = cli_items(rng, PROJECTION_CLI_SECONDS, "projections")
    valid = cli_items(rng, PROJECTION_CLI_SECONDS[:2], "projections-valid")
    tokenizer = CliWords({w for it in items + valid for w in it["words"]})
    splits = {"train": items, "valid": valid}
    seams = {(mod, "load_hf_dataset"): lambda name, split=None: splits[split]
             for mod in (train, validate)}
    seams.update({(mod, "build_tokenizer"): lambda config: tokenizer for mod in (train, validate)})
    real = {key: getattr(*key) for key in seams}
    warnings = []

    class Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    catch = Catch(logging.WARNING)
    logger = logging.getLogger("aat_tpu_torch.models.efficientnet")
    out_dir = os.path.join(tmp, "proj")
    wrappers = kernel_wrappers()
    try:
        for key, fn in seams.items():
            setattr(*key, fn)
        logger.addHandler(catch)
        for w in wrappers.values():
            w.launches = 0
        calls = reset_entry_calls()
        start = time.perf_counter()
        trainer = train.main(["--pretrained", "--lm-pretrained-model", lm_dir,
                              "--audio-encoder-type", "efficient_net",
                              "--projection-type", "transformer_encoder",
                              "--segmentation", "adaptive", "--per-device-train-batch-size", "2",
                              "--gradient-accumulation-steps", "1", "--num-train-epochs", "1",
                              "--eval-steps", "0", "--save-steps", "0", "--logging-steps", "1",
                              "--no-load-best-model-at-end", "--output-dir", out_dir],
                             device=device)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - start
        launches = {n: w.launches for n, w in wrappers.items()}
        calls = dict(calls)
        run_dir = f"{out_dir}_1_transformer_encoder_adaptive"
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            losses = [m["train/loss"] for m in map(json.loads, f) if "train/loss" in m]
        print(f"cli train --audio-encoder-type efficient_net --projection-type "
              f"transformer_encoder --segmentation adaptive ({smi_line}): wall {train_s:.3f} s; "
              f"losses {[round(x, 5) for x in losses]}; EfficientNet warnings {warnings}; "
              f"launches {launches}", flush=True)
        check(trainer.state.step == 2 and len(losses) == 2 and all(np.isfinite(losses)),
              f"the projections run: step {trainer.state.step}, losses {losses}")
        check(any("efficientnet_pytorch unavailable" in w for w in warnings),
              "no warning before EfficientNet's random init")
        export = trainer.save_pretrained(os.path.join(tmp, "proj-export"))
        saved = {name: {k: v.detach().cpu().clone()
                        for k, v in flatten(trainer.state.params[name]).items()}
                 for name in ("adapter", "audio_encoder")}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = validate.main(["--checkpoint", export, "--items", "2", "--batch", "2",
                                     "--projection-type", "transformer_encoder",
                                     "--no-pretrained"], device=device)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - start
        check(np.isfinite(metrics["eval/loss"]) and "wer" in metrics, f"validate: {metrics}")
    finally:
        logger.removeHandler(catch)
        for key, fn in real.items():
            setattr(*key, fn)
    model, params = load_pretrained(export, device=device)
    differ = [f"{name}.{k}" for name, tree in saved.items()
              for k, v in flatten(params[name]).items() if not torch.equal(v.cpu(), tree[k])]
    n_saved = sum(len(tree) for tree in saved.values())
    print(f"cli validate on the export (--no-pretrained, efficient_net from its config.json): "
          f"wall {val_s:.3f} s, eval/loss {metrics['eval/loss']:.5f}; load_pretrained: "
          f"audio_encoder_type {model.audio_encoder_type}, "
          f"{type(model.audio_encoder_config).__name__}, {model.config.pooling}; "
          f"{n_saved - len(differ)} of {n_saved} saved tensors equal bit for bit", flush=True)
    check(model.audio_encoder_type == "efficient_net"
          and isinstance(model.audio_encoder_config, EfficientNetConfig)
          and isinstance(model.config.pooling, PoolingConfig), "the export read back wrongly")
    check(not differ, f"the export's params differ on {differ[:5]}")
    del model, params, saved
    for done in (run_dir, export):
        shutil.rmtree(done, ignore_errors=True)
    return launches, calls



# phase 17: multi-device training, ranks sharing cuda:0 over gloo
MESH_RUNS = (
    # name, mesh, the encoder's dropout and LayerDrop, the fault planted in a second run
    ("dp4", {"dp": 4}, 0.1, "unshifted_dropout"),
    ("dp2_fsdp2", {"dp": 2, "fsdp": 2}, 0.0, "no_reduce"),
    ("dp2_tp2", {"dp": 2, "tp": 2}, 0.1, "tp_local_heads"),
    ("dp2_sp2", {"dp": 2, "sp": 2}, 0.0, None),
)
MESH_RANKS = 4
MESH_SECONDS = (8.0, 12.0, 16.0, 20.0)  # the global batch's utterances
MESH_TIMEOUT = 600  # seconds a launch of the ranks may take
# the bounds against the one-process trainer after 2 steps (f32 compute on
# the 3xTF32 kernels, so rounding is reduction order only): the loss of each
# step within MESH_LOSS_TOL of the reference's, relative. AdamW's first
# update is sign-like (g / (|g| + 1e-8)), so a coordinate whose gradient is
# at rounding level may move a whole step (lr ~1e-5 here) the other way:
# such coordinates (|Δ| > MESH_FLIP) may be at most MESH_FLIP_SHARE of the
# trainable ones. JAX's parameter bar (1e-4) could not bind here, since 2
# steps move a coordinate by about 2e-6 at most: the flip share is the
# parameters' bound.
MESH_LOSS_TOL = 1e-5
MESH_FLIP = 1e-6
MESH_FLIP_SHARE = 1e-4


def mesh_model(dropout):
    """hubert-large (its dropout and LayerDrop at ``dropout``), the linear
    projection and SmolLM-135M: phase 8's model."""
    from aat_tpu_torch.models import aslm, hubert, llama

    audio_cfg = dataclasses.replace(hubert.hubert_large_config(), hidden_dropout=dropout,
                                    attention_dropout=dropout, activation_dropout=dropout,
                                    layerdrop=dropout)
    lm_cfg = llama.smollm_135m_config()
    return aslm.AslmModel(
        aslm.AslmConfig(projection_type="linear", audio_encoder_embeddings_seq_len=1,
                        audio_encoder_hidden=audio_cfg.hidden_size, lm_hidden=lm_cfg.hidden_size),
        audio_cfg, lm_cfg)


def mesh_config(mesh=None, **overrides):
    """``projection_training_config()`` at f32 compute, one microbatch a step
    (``overrides``: other fields, such as the pipeline's microbatches)."""
    from aat_tpu_torch.training.config import projection_training_config

    mesh = mesh or {}
    return dataclasses.replace(
        projection_training_config(), compute_dtype="float32", gradient_accumulation_steps=1,
        per_device_train_batch_size=4 // max(1, mesh.get("dp", 1) * mesh.get("fsdp", 1)),
        mesh_dp=mesh.get("dp", 1), mesh_fsdp=mesh.get("fsdp", 1), mesh_tp=mesh.get("tp", 1),
        mesh_sp=mesh.get("sp", 1), mesh_pp=mesh.get("pp", 1), **overrides)


def mesh_batch(torch, rng):
    """The global batch: 4 speech-like utterances of 8-20 s (normalized,
    padded to 20 s) and captions of 32-48 random ids, as CPU tensors."""
    waves = [speechlike_waveform(rng, d) for d in MESH_SECONDS]
    waves = [(w - w.mean()) / (w.std() + 1e-7) for w in waves]
    n, length = len(waves), max(w.size for w in waves)
    x = np.zeros((n, length), np.float32)
    wmask = np.zeros((n, length), np.int32)
    cap_lens = rng.integers(32, 49, n)
    ids = np.zeros((n, int(cap_lens.max())), np.int64)
    cmask = np.zeros(ids.shape, np.int32)
    for i, (w, c) in enumerate(zip(waves, cap_lens)):
        x[i, : w.size], wmask[i, : w.size] = w, 1
        ids[i, :c], cmask[i, :c] = rng.integers(3, 49152, c), 1
    return {"waveforms": torch.from_numpy(x), "waveforms_attention_mask": torch.from_numpy(wmask),
            "input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(cmask),
            "input_ids_attention_mask": torch.from_numpy(cmask)}


def trainable_flat(trainer):
    """The full (gathered) trainable parameters by dotted path, in the
    per-layer layout: the audio encoder and the adapter."""
    from aat_tpu_torch.parallel.pipeline import unstack_model_layers
    from aat_tpu_torch.training import checkpoint as ckpt_lib

    full = {k: unstack_model_layers(v) for k, v in
            trainer._full_state(trainer.state.params).items()}
    return {k: v for k, v in ckpt_lib.flatten(full).items() if not k.startswith("lm_decoder.")}


GRAD_NORM_METRICS = ("train/audio_tokens_emb_grad", "train/audio_encdoer_grad_norm")


def mesh_steps(torch, trainer, batch, steps=2):
    """``steps`` optimizer steps on ``batch`` with the launch counters reset
    first → (losses, step walls, peak memory in bytes, launches by wrapper,
    flash launches by C entry, each step's gradient-norm metrics)."""
    from aat_tpu_torch.parallel import comm

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    calls = reset_entry_calls()
    comm.calls.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, norms = [], [], []
    for _ in range(steps):
        start = time.perf_counter()
        metrics = trainer.training_step([batch])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        losses.append(metrics["train/loss"])
        norms.append([metrics[k] for k in GRAD_NORM_METRICS])
    return (losses, walls, torch.cuda.max_memory_allocated(),
            {name: w.launches for name, w in wrappers.items()},
            {e: calls[e] for e in FLASH_ENTRIES["float32"]}, norms)


def param_diffs(torch, got, ref):
    """max |Δ| over every coordinate, the coordinates beyond ``MESH_FLIP``
    (and the leaves, layer indices dropped, with the most of them) and the
    max |Δ| of the others, of two {path: tensor} maps."""
    worst = rest = 0.0
    flips = total = 0
    by_leaf = {}
    for k, want in ref.items():
        d = (got[k].float() - want.to(got[k].device).float()).abs()
        worst = max(worst, float(d.max()))
        beyond = d > MESH_FLIP
        n = int(beyond.sum())
        flips += n
        total += d.numel()
        rest = max(rest, float(torch.where(beyond, 0.0, d).max()))
        if n:
            leaf = ".".join(p for p in k.split(".") if not p.isdigit())
            by_leaf[leaf] = by_leaf.get(leaf, 0) + n
    top = dict(sorted(by_leaf.items(), key=lambda kv: -kv[1])[:4])
    return {"max_abs": worst, "flips": flips, "coords": total, "rest_max_abs": rest,
            "flips_by_leaf": top}


def mesh_rank(rank, world_size, port, run, paths):
    """One of the 4 ranks on cuda:0 (gloo): a trainer under ``run``'s mesh
    from the state the parent wrote, 2 steps on this rank's rows of the
    global batch, then its parameters (gathered) against the parent's
    one-process result; again with the run's fault planted, and in the
    fsdp run once more as a dp control with the same local rows (memory)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    from aat_tpu_torch.models import hubert
    from aat_tpu_torch.ops.dropout import ElementShard
    from aat_tpu_torch.parallel import comm
    from aat_tpu_torch.parallel.distributed import initialize
    from aat_tpu_torch.training.trainer import AATTrainer

    name, mesh, dropout, fault = run
    tp_head_keys = hubert.tp_head_keys
    device = initialize(rank, world_size, f"tcp://localhost:{port}", device="cuda:0",
                        backend="gloo")
    batch = {k: v.to(device) for k, v in torch.load(paths["batch"], weights_only=True).items()}
    ref = torch.load(paths[f"ref_{dropout}"], weights_only=True, mmap=True)
    reports = {}
    plans = [("sound", mesh, None)] + ([(fault, mesh, fault)] if fault else [])
    if "fsdp" in mesh:
        plans.append(("dp_control", {"dp": world_size}, None))
    for label, layout, planted in plans:
        init = torch.load(paths["init"], weights_only=True, mmap=True, map_location=device)
        trainer = AATTrainer(mesh_model(dropout), init, mesh_config(layout))
        del init
        gc.collect()
        torch.cuda.empty_cache()
        if planted == "no_reduce" and rank == 1:
            reduce = trainer._reduce_grads
            trainer._reduce_grads = lambda grads: (reduce(grads), grads)[1]
        if planted == "unshifted_dropout":
            trainer.mesh.element_shard = lambda time=None: ElementShard(0, time)
        # each tp rank keys its heads as a launch of its own (no salt either)
        hubert.tp_head_keys = ((lambda nh, mesh: (nh, 0)) if planted == "tp_local_heads"
                               else tp_head_keys)
        # the dp control feeds each rank the fsdp run's rows (memory only)
        local = (reports["sound"]["local"] if label == "dp_control"
                 else trainer.mesh.local_batch(batch))
        steps = 1 if label == "dp_control" else 2
        losses, walls, peak, launches, calls, _ = mesh_steps(torch, trainer, local, steps)
        report = {"losses": losses, "walls": walls, "peak": peak, "launches": launches,
                  "calls": calls, "collectives": dict(comm.calls), "local": local}
        if label != "dp_control":
            report.update(param_diffs(torch, trainable_flat(trainer), ref))
        reports[label] = report
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    hubert.tp_head_keys = tp_head_keys
    for report in reports.values():
        del report["local"]
    return reports


def nccl_world_one(torch, device, paths, batch):
    """One NCCL process group at world size 1 on cuda:0: a trainer step
    through the mesh code (every collective on NCCL, over one rank) equal
    bit for bit to the plain step."""
    import torch.distributed as dist

    from aat_tpu_torch.parallel import comm
    from aat_tpu_torch.parallel import mesh as mesh_lib
    from aat_tpu_torch.parallel.distributed import free_port, initialize
    from aat_tpu_torch.training import checkpoint as ckpt_lib
    from aat_tpu_torch.training.trainer import AATTrainer

    initialize(0, 1, f"tcp://localhost:{free_port()}", device=device)
    backend = dist.get_backend()
    # bit for bit needs cuDNN's deterministic algorithms (its conv backward
    # sums in a run-dependent order otherwise), as in phase 12
    torch.backends.cudnn.deterministic = True
    try:
        results = []
        for mesh in (None, mesh_lib.make_mesh()):
            init = torch.load(paths["init"], weights_only=True, map_location=device)
            trainer = AATTrainer(mesh_model(0.1), init, mesh_config(), mesh=mesh)
            comm.calls.clear()
            loss = trainer.training_step([{k: v.to(device) for k, v in batch.items()}])
            results.append((loss["train/loss"], ckpt_lib.flatten(trainer.state.params),
                            dict(comm.calls)))
            del trainer, init
        (loss_p, plain, _), (loss_m, meshed, collectives) = results
        differ = [k for k in plain if not torch.equal(plain[k], meshed[k])]
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    print(f"nccl world 1: backend {backend}, loss plain {loss_p!r} mesh {loss_m!r}, "
          f"{len(differ)} of {len(plain)} params differ {differ[:4]}, collectives "
          f"{collectives}", flush=True)
    check(backend == "nccl", f"the world-1 group ran {backend}, not nccl")
    check(loss_p == loss_m and not differ, "the NCCL world-1 mesh step differs from the plain step")
    check(any(k.endswith("(nccl)") for k in collectives), "no collective ran on NCCL")
    torch.cuda.empty_cache()


def phase_multidevice(torch, device, rng, smi_line):
    """Phases 17 and 18 (module docstring). Returns the paths
    ``train_multidevice`` (rank 0's launches by wrapper and by C entry in
    the dp4 run) and ``train_pipeline`` (phase 18's)."""
    import shutil
    import tempfile

    from aat_tpu_torch.parallel.distributed import launch
    from aat_tpu_torch.training.trainer import AATTrainer

    phase_start = time.perf_counter()
    held = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(dir=os.path.join(REPO, "aat_tpu_torch", "build"))
    try:
        model = mesh_model(0.0)
        init = model.init_params(0, device="cpu")  # phase 8's seeded weights
        paths = {"init": os.path.join(tmp, "init.pt"), "batch": os.path.join(tmp, "batch.pt")}
        torch.save(init, paths["init"])
        batch = mesh_batch(torch, rng)
        torch.save(batch, paths["batch"])
        del init
        nccl_world_one(torch, device, paths, batch)
        refs, norm_refs = {}, {}
        for dropout in sorted({run[2] for run in MESH_RUNS}):
            trainer = AATTrainer(mesh_model(dropout),
                                 torch.load(paths["init"], weights_only=True, map_location=device),
                                 mesh_config())
            dev_batch = {k: v.to(device) for k, v in batch.items()}
            losses, walls, peak, _, _, norms = mesh_steps(torch, trainer, dev_batch)
            paths[f"ref_{dropout}"] = os.path.join(tmp, f"ref_{dropout}.pt")
            torch.save({k: v.cpu() for k, v in trainable_flat(trainer).items()},
                       paths[f"ref_{dropout}"])
            refs[dropout], norm_refs[dropout] = losses, norms
            print(f"multidevice reference (one process, f32, dropout {dropout}): losses "
                  f"{losses}, step walls {[round(w, 3) for w in walls]} s, peak "
                  f"{peak / 2**30:.2f} GiB ({smi_line})", flush=True)
            del trainer, dev_batch
            gc.collect()
            torch.cuda.empty_cache()
        check(torch.cuda.memory_allocated() <= held + 2**28,
              "the parent did not free the card before the ranks start")
        results = {}
        for run in MESH_RUNS:
            name, mesh, dropout, fault = run
            start = time.perf_counter()
            reports = launch(mesh_rank, MESH_RANKS, (run, paths), timeout=MESH_TIMEOUT)
            results[name] = reports
            sound = [r["sound"] for r in reports]
            loss_err = max(abs(a - b) / max(1.0, abs(b)) for r in sound
                           for a, b in zip(r["losses"], refs[dropout]))
            flips = max(r["flips"] for r in sound)
            coords = sound[0]["coords"]
            print(f"multidevice {name} ({MESH_RANKS} ranks sharing one H100 over gloo, "
                  f"dropout {dropout}; launch {time.perf_counter() - start:.1f} s): losses "
                  f"{[r['losses'] for r in sound]} vs {refs[dropout]}, loss rel |d| "
                  f"{loss_err:.3e}; params max |d| {max(r['max_abs'] for r in sound):.3e}, "
                  f"beyond {MESH_FLIP:g}: {flips} of {coords} ({flips / coords:.2e}), the rest "
                  f"within {max(r['rest_max_abs'] for r in sound):.3e}; step walls "
                  f"{[[round(w, 3) for w in r['walls']] for r in sound]} s (4 ranks sharing "
                  f"one H100, not a scaling number); peak memory per rank "
                  f"{[round(r['peak'] / 2**30, 2) for r in sound]} GiB ({smi_line})",
                  flush=True)
            for rank, r in enumerate(sound):
                print(f"multidevice {name} rank {rank}: flash launches {r['launches']}, by C "
                      f"entry {r['calls']}; collectives {r['collectives']}", flush=True)
                for kernel in TRAIN_KERNELS:
                    check(r["launches"][kernel] > 0,
                          f"{name} rank {rank} never launched the {kernel} kernel")
                check(all(r["calls"][e] > 0 for e in FLASH_ENTRIES["float32"]),
                      f"{name} rank {rank}: the f32 step missed a 3xTF32 entry")
            check(loss_err <= MESH_LOSS_TOL, f"{name}: loss off the one-process run")
            check(flips <= MESH_FLIP_SHARE * coords, f"{name}: too many coordinates moved apart")
            if fault:
                planted = [r[fault] for r in reports]
                f_loss = max(abs(a - b) / max(1.0, abs(b)) for r in planted
                             for a, b in zip(r["losses"], refs[dropout]))
                f_flips = max(r["flips"] for r in planted)
                factor = max(f_loss / MESH_LOSS_TOL, f_flips / (MESH_FLIP_SHARE * coords))
                print(f"multidevice {name} with the fault {fault} planted: loss rel |d| "
                      f"{f_loss:.3e}, beyond {MESH_FLIP:g}: {f_flips} of {coords}, max |d| "
                      f"{max(r['max_abs'] for r in planted):.3e}; {factor:.3g} times past the "
                      "bounds", flush=True)
                check(f_loss > MESH_LOSS_TOL or f_flips > MESH_FLIP_SHARE * coords,
                      f"{name}: the bounds did not see the planted fault {fault}")
        fsdp_peak = max(r["sound"]["peak"] for r in results["dp2_fsdp2"])
        dp_peak = max(r["dp_control"]["peak"] for r in results["dp2_fsdp2"])
        print(f"multidevice memory: dp2 x fsdp2 peak {fsdp_peak / 2**30:.2f} GiB per rank, the "
              f"dp control with the same rows {dp_peak / 2**30:.2f} GiB ({smi_line})", flush=True)
        check(fsdp_peak < dp_peak, "fsdp's per-rank peak is not below dp's")
        collectives = sorted({k for reports in results.values() for r in reports
                              for k in r["sound"]["collectives"]})
        print(f"multidevice collectives (gloo; routes built from others named): {collectives}",
              flush=True)
        rank0 = results["dp4"][0]["sound"]
        print(f"phase 17 wall {time.perf_counter() - phase_start:.1f} s", flush=True)
        del results
        # 18. the pipeline axis, on the same references
        return {"train_multidevice": (
                    rank0["launches"], {**{e: 0 for names in FLASH_ENTRIES.values()
                                           for e in names}, **rank0["calls"]}),
                "train_pipeline": phase_pipeline_parallel(torch, device, tmp, paths, refs,
                                                          norm_refs, batch, smi_line)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 18: pipeline-parallel training, ranks sharing cuda:0 over gloo
PP_RUNS = (
    # name, mesh, the encoder's dropout and LayerDrop, the pipeline's
    # microbatches (0: 2·pp, clamped to the rank's rows), optimizer, steps,
    # and what else the launch runs
    ("dp2_pp2", {"dp": 2, "pp": 2}, 0.1, 2, "adamw", 2, ("faults", "eval", "checkpoint")),
    ("pp2_tp2", {"tp": 2, "pp": 2}, 0.1, 4, "adamw", 2, ()),
    ("fsdp2_pp2", {"fsdp": 2, "pp": 2}, 0.0, 0, "adamw", 2, ()),
    ("dp2_pp2_adafactor", {"dp": 2, "pp": 2}, 0.0, 0, "adafactor", 1, ()),
)
# the pipeline's two planted boundary faults: the result leaving through an
# all-reduce whose gradient is summed too (the gradients below it times pp),
# and the input entering without the sum of the stages' gradients (the
# gradients above it on stage 0 only)
PP_FAULTS = ("pipeline_exit_sum", "pipeline_entry_identity")
# the step's gradient-norm metrics against the one-process run's, relative:
# AdamW's update is blind to a gradient scaled as a whole, its norm is not
MESH_NORM_TOL = 1e-4
ADAFACTOR = dict(optimizer="adafactor", learning_rate=None)
# the Adafactor run's parameter bounds, in units of the one-process update's
# own spread over another batch split: Adafactor's update follows the
# gradient's rounding (on an H100, 62,846 of the 322 M coordinates of a
# sound dp2 x pp2 update moved apart by more than 1e-6, past the share bound
# of 1e-4, in the encoder's stacked kernels and its attention k bias, whose
# gradient is zero but for rounding)
ADAFACTOR_SPREAD = 4


SOUND_BOUNDARY = {}  # the pipeline's own boundary operators, kept by pp_faulty


def pp_faulty(fault):
    """Plant ``fault`` (None: none) in this process's pipeline, in place of
    any planted before (the ranks' only)."""
    from aat_tpu_torch.parallel import comm, pipeline

    SOUND_BOUNDARY.setdefault("ops", (pipeline._enter, pipeline._exit))
    pipeline._enter, pipeline._exit = SOUND_BOUNDARY["ops"]
    if fault == "pipeline_exit_sum":
        pipeline._exit = comm.all_reduce_sum
    elif fault == "pipeline_entry_identity":
        pipeline._enter = lambda x, group: x


def stacked_bytes(tree, stacks):
    """Bytes of the stacked ``layers`` of each of ``stacks`` in ``tree``
    (``None`` leaves, frozen moments, count nothing)."""
    from aat_tpu_torch.training import checkpoint as ckpt_lib

    return {k: sum(v.numel() * v.element_size()
                   for v in ckpt_lib.flatten(tree[k]["layers"]).values()) for k in stacks}


def capture_ids(store):
    """A ``compute_metrics`` that keeps the generated ids."""
    def compute(generated_ids, inputs_ids, prefix_ids):
        store["ids"] = generated_ids
        return {}

    return compute


def eval_batch(batch):
    """The global batch with a text prefix: each caption's first two ids."""
    ids = batch["input_ids"]
    return {**batch, "prefix_input_ids": ids[:, :2],
            "prefix_attention_mask": ids[:, :2].new_ones(ids[:, :2].shape)}


def pp_rank(rank, world_size, port, run, paths):
    """One of the 4 ranks on cuda:0 (gloo): a pp trainer under ``run``'s mesh
    from the state the parent wrote, ``steps`` steps on this rank's rows,
    its parameters (gathered) against the parent's one-process result,
    the step's gradient norms, ring permutes and stage residency; in the
    dp2 × pp2 run also an evaluation on the initial weights, a checkpoint
    each way and the two planted faults."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    from aat_tpu_torch.parallel import comm
    from aat_tpu_torch.parallel.distributed import initialize
    from aat_tpu_torch.parallel.pipeline import unstack_model_layers
    from aat_tpu_torch.training import checkpoint as ckpt_lib
    from aat_tpu_torch.training.trainer import AATTrainer

    name, mesh, dropout, microbatches, optimizer, steps, extras = run
    device = initialize(rank, world_size, f"tcp://localhost:{port}", device="cuda:0",
                        backend="gloo")
    batch = {k: v.to(device) for k, v in torch.load(paths["batch"], weights_only=True).items()}
    ref = torch.load(paths[f"ref_{name}"], weights_only=True, mmap=True)
    config = mesh_config(mesh, pp_microbatches=microbatches, output_dir=paths["dir"],
                         **(ADAFACTOR if optimizer == "adafactor" else {}))

    def trainer_of(cfg=config):
        init = torch.load(paths["init"], weights_only=True, mmap=True, map_location=device)
        trainer = AATTrainer(mesh_model(dropout), init, cfg)
        del init
        gc.collect()
        torch.cuda.empty_cache()
        return trainer

    def release(trainer):
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    reports = {}
    plans = [("sound", None)] + [(f, f) for f in (PP_FAULTS if "faults" in extras else ())]
    for label, fault in plans:
        pp_faulty(fault)
        trainer = trainer_of()
        local = trainer.mesh.local_batch(batch)
        report = {}
        if label == "sound" and "eval" in extras:
            seen = {}
            trainer.compute_metrics = capture_ids(seen)
            local_eval = trainer.mesh.local_batch(eval_batch(batch))
            start = time.perf_counter()
            report["eval_loss"] = trainer.evaluate([local_eval], with_generation=True)["eval/loss"]
            report["eval_wall"] = time.perf_counter() - start
            report["eval_ids"] = seen["ids"]
            prefix = trainer._prefix_inputs(trainer._use(trainer.state.params, grad=False),
                                            trainer._to_device(local_eval))
            report["prefix"] = {k: prefix[k].cpu() for k in ("inputs_embeds", "attention_mask")}
            trainer.compute_metrics = None
        comm.ring_bytes.clear()
        losses, walls, peak, launches, calls, norms = mesh_steps(torch, trainer, local, steps)
        report.update(losses=losses, walls=walls, peak=peak, launches=launches, calls=calls,
                      norms=norms, ring={k: v for k, v in comm.calls.items()
                                         if k.startswith("ring_permute")},
                      ring_bytes=dict(comm.ring_bytes), coords=dict(trainer.mesh.coords))
        report.update(param_diffs(torch, trainable_flat(trainer), ref))
        if label == "sound":
            stacks = ("audio_encoder", "lm_decoder")
            full = trainer._full_state(trainer.state.params)
            state = trainer.state.opt_state
            moments = getattr(state, "mu", None) or getattr(state, "inner_state").v_row
            full_moments = (trainer._full_state(state).mu if hasattr(state, "mu")
                            else trainer._full_state(state).inner_state.v_row)
            report["residency"] = {
                "params": (stacked_bytes(trainer.state.params, stacks), stacked_bytes(full, stacks)),
                "moments": (stacked_bytes(moments, ("audio_encoder",)),
                            stacked_bytes(full_moments, ("audio_encoder",)))}
            del full, full_moments
            if "checkpoint" in extras:
                start = time.perf_counter()
                trainer.save_checkpoint(paths["pp_checkpoint"])
                report["save_wall"] = time.perf_counter() - start
        reports[label] = report
        release(trainer)
    pp_faulty(None)
    if "checkpoint" in extras:
        # the parent's one-process checkpoint, restored under this mesh
        trainer = trainer_of()
        trainer.restore_checkpoint(paths["one_checkpoint"])
        saved = ckpt_lib.read_params(paths["one_checkpoint"], "cpu")["params"]
        full = ckpt_lib.flatten({k: unstack_model_layers(v) for k, v in
                                 trainer._full_state(trainer.state.params).items()})
        reports["sound"]["restored"] = (sorted(full) == sorted(saved)) and all(
            torch.equal(full[k].cpu(), saved[k]) for k in saved)
        release(trainer)
    return reports


def one_process_eval(torch, device, paths, batch):
    """The one-process evaluation of the initial weights on the global
    batch's eval loss, and generation on each data rank's 2 rows as the
    dp2 ranks generate them → (loss, ids by data rank, the trainer)."""
    from aat_tpu_torch.training.trainer import AATTrainer

    init = torch.load(paths["init"], weights_only=True, map_location=device)
    trainer = AATTrainer(mesh_model(0.1), init, mesh_config(output_dir=paths["dir"]))
    dev = {k: v.to(device) for k, v in eval_batch(batch).items()}
    loss = trainer.evaluate([dev])["eval/loss"]
    ids = [trainer.generate_for_batch({k: v[2 * d:2 * d + 2] for k, v in dev.items()})
           for d in range(2)]
    return loss, ids, trainer


def stacked_adafactor_reference(torch, device, paths, batch):
    """JAX's pp math in one process: ``optim.adafactor`` (relative step, the
    freeze mask, the guard as the trainer wraps it) applied to the stacked
    tree of the one-process trainer's first-step gradients, from the same
    initial parameters and batch → (the step's loss, its gradient norms,
    the trainable parameters after the update, per-layer layout, and the
    update's own spread: the same update from the gradients of the two
    half batches, weighted by their caption tokens, against it
    (:func:`param_diffs`)). Adafactor's update is proportional to the
    gradient, not sign-like as AdamW's first step, so rounding of the
    gradients' long sums moves coordinates where its factored scale is
    small; the spread measures how far in this process."""
    from aat_tpu_torch.parallel.pipeline import stack_model_layers, unstack_model_layers
    from aat_tpu_torch.training import checkpoint as ckpt_lib
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.trainer import AATTrainer
    from aat_tpu_torch.utils import port

    init = torch.load(paths["init"], weights_only=True, map_location=device)
    trainer = AATTrainer(mesh_model(0.0), init, mesh_config(**ADAFACTOR))
    dev = {k: v.to(device) for k, v in batch.items()}
    seed = trainer.dropout_seed(0, 0)
    grads, metrics, _ = trainer._grad_step(trainer.state.params, dev, seed)
    halves, tokens = None, 0.0
    for rows in (slice(0, 2), slice(2, 4)):
        part = {k: v[rows] for k, v in dev.items()}
        g, _, _ = trainer._grad_step(trainer.state.params, part, seed)
        n = float(part["input_ids_attention_mask"][:, 1:].sum())
        g = optim.tree_map(lambda x: None if x is None else x * n, g)
        halves = g if halves is None else optim.tree_map(
            lambda a, b: None if a is None else a + b, halves, g)
        tokens += n
    halves = optim.tree_map(lambda x: None if x is None else x / tokens, halves)
    stacks = ("audio_encoder", "lm_decoder")

    def stacked(tree):
        return {k: stack_model_layers(v) if k in stacks else v for k, v in tree.items()}

    start = stacked(trainer.state.params)
    freeze = optim.trainable_mask(start, train_audio_encoder=True, train_lm_decoder=False)
    axes = {path: optim.factored_dims(p.shape)
            for path, p in zip(optim.tree_leaves(optim.tree_paths(start)),
                               optim.tree_leaves(start)) if p.ndim >= 2}
    axes.update(port.adafactor_axes(start))
    tx = optim.guard_nonfinite(optim.adafactor(None, freeze=freeze, axes=axes))

    def updated(g):
        """The trainable params after the update from ``g``, per-layer layout."""
        params = optim.tree_map(torch.clone, start)
        # the frozen LM has no gradient: a tree of None in the stacked structure
        g = {**stacked({k: v for k, v in g.items() if k != "lm_decoder"}),
             "lm_decoder": optim.tree_map(lambda _: None, params["lm_decoder"])}
        with torch.no_grad():
            updates, _ = tx.update(g, tx.init(params), params)
            optim.apply_updates(params, updates)
        full = ckpt_lib.flatten({k: unstack_model_layers(v) for k, v in params.items()})
        return {k: v for k, v in full.items() if not k.startswith("lm_decoder.")}

    out = updated(grads)
    spread = param_diffs(torch, updated(halves), out)
    loss = float(metrics["train/loss"])
    norms = [float(metrics[k]) for k in GRAD_NORM_METRICS]
    out = {k: v.cpu() for k, v in out.items()}
    del trainer, start, grads, halves
    gc.collect()
    torch.cuda.empty_cache()
    return loss, norms, out, spread


def rel_err(got, want):
    return max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))


def phase_pipeline_parallel(torch, device, tmp, paths, refs, norm_refs, batch, smi_line):
    """Phase 18 (module docstring), in phase 17's directory with its
    one-process references. Returns rank 0's launches by wrapper and by C
    entry in the dp2 × pp2 run, the path ``train_pipeline``."""
    from aat_tpu_torch.parallel.distributed import launch
    from aat_tpu_torch.parallel.pipeline import flat_to_layout
    from aat_tpu_torch.training import checkpoint as ckpt_lib
    from aat_tpu_torch.training.trainer import AATTrainer

    phase_start = time.perf_counter()
    held = torch.cuda.memory_allocated()
    paths["dir"] = tmp
    # the references: phase 17's one-process runs, the stacked Adafactor
    # update, the one-process evaluation and a one-process checkpoint
    expected = {}
    for name, mesh, dropout, *_ in PP_RUNS:
        paths[f"ref_{name}"] = paths[f"ref_{dropout}"]
        expected[name] = (refs[dropout], norm_refs[dropout])
    loss, norms, ref, spread = stacked_adafactor_reference(torch, device, paths, batch)
    paths["ref_dp2_pp2_adafactor"] = os.path.join(tmp, "ref_adafactor.pt")
    torch.save(ref, paths["ref_dp2_pp2_adafactor"])
    expected["dp2_pp2_adafactor"] = ([loss], [norms])
    del ref
    eval_loss, eval_ids, one = one_process_eval(torch, device, paths, batch)
    paths["one_checkpoint"] = one.save_checkpoint(os.path.join(tmp, "one_checkpoint"))
    paths["pp_checkpoint"] = os.path.join(tmp, "pp_checkpoint")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pipeline references ({time.perf_counter() - phase_start:.1f} s): stacked Adafactor "
          f"loss {loss!r} norms {norms}, its own spread over two half batches: beyond "
          f"{MESH_FLIP:g} {spread['flips']} of {spread['coords']}, max |d| "
          f"{spread['max_abs']:.3e}, by leaf {spread['flips_by_leaf']}; one-process eval loss "
          f"{eval_loss!r}", flush=True)
    check(torch.cuda.memory_allocated() <= held + 2**28,
          "the parent did not free the card before the ranks start")

    results = {}
    for run in PP_RUNS:
        name, mesh, dropout, microbatches, optimizer, steps, extras = run
        start = time.perf_counter()
        reports = launch(pp_rank, MESH_RANKS, (run, paths), timeout=MESH_TIMEOUT)
        results[name] = reports
        want_losses, want_norms = expected[name]
        sound = [r["sound"] for r in reports]
        loss_err = max(rel_err(r["losses"], want_losses) for r in sound)
        norm_err = max(rel_err(a, b) for r in sound for a, b in zip(r["norms"], want_norms))
        flips, coords = max(r["flips"] for r in sound), sound[0]["coords"]
        m = microbatches or 2 * mesh["pp"]
        print(f"pipeline {name} ({MESH_RANKS} ranks sharing one H100 over gloo, dropout and "
              f"LayerDrop {dropout}, microbatches {m} requested, {optimizer}, {steps} steps; "
              f"launch {time.perf_counter() - start:.1f} s): losses "
              f"{[r['losses'] for r in sound]} vs {want_losses}, loss rel |d| {loss_err:.3e}; "
              f"grad-norm metrics rel |d| {norm_err:.3e}; params max |d| "
              f"{max(r['max_abs'] for r in sound):.3e}, beyond {MESH_FLIP:g}: {flips} of "
              f"{coords} ({flips / coords:.2e}), the rest within "
              f"{max(r['rest_max_abs'] for r in sound):.3e}; step walls "
              f"{[[round(w, 3) for w in r['walls']] for r in sound]} s (4 ranks sharing one "
              f"H100 through host memory, not a scaling number); peak memory per rank "
              f"{[round(r['peak'] / 2**30, 2) for r in sound]} GiB ({smi_line})", flush=True)
        for rank, r in enumerate(sound):
            print(f"pipeline {name} rank {rank} {r['coords']}: ring permutes {r['ring']}, bytes "
                  f"{r['ring_bytes']}; flash launches {r['launches']}, by C entry {r['calls']}; "
                  f"stacked bytes {r['residency']}", flush=True)
            for kernel in TRAIN_KERNELS:
                check(r["launches"][kernel] > 0,
                      f"{name} rank {rank} never launched the {kernel} kernel")
            check(all(r["calls"][e] > 0 for e in FLASH_ENTRIES["float32"]),
                  f"{name} rank {rank}: the f32 step missed a 3xTF32 entry")
            check(sum(r["ring"].values()) > 0, f"{name} rank {rank}: no ring permute ran")
            if set(mesh) == {"dp", "pp"}:  # the stacks sharded over pp alone
                for what, (local, whole) in r["residency"].items():
                    for stack, n in local.items():
                        check(2 * n == whole[stack] and n > 0,
                              f"{name} rank {rank}: {what} of {stack} not half the whole stack")
        check(loss_err <= MESH_LOSS_TOL, f"{name}: loss off the one-process run")
        check(norm_err <= MESH_NORM_TOL, f"{name}: gradient norms off the one-process run")
        # Adafactor's update follows the gradient's rounding: its bound is the
        # one-process update's own spread over another batch split
        allowed = max(MESH_FLIP_SHARE * coords,
                      ADAFACTOR_SPREAD * spread["flips"] if optimizer == "adafactor" else 0)
        print(f"pipeline {name}: coordinates beyond {MESH_FLIP:g} by leaf "
              f"{sound[0]['flips_by_leaf']}, at most {allowed:.0f} allowed", flush=True)
        check(flips <= allowed, f"{name}: too many coordinates moved apart")
        if optimizer == "adafactor":
            check(max(r["max_abs"] for r in sound) <= ADAFACTOR_SPREAD * spread["max_abs"],
                  f"{name}: a coordinate moved further than the one-process update's spread")
        for fault in PP_FAULTS if "faults" in extras else ():
            planted = [r[fault] for r in reports]
            f_loss = max(rel_err(r["losses"], want_losses) for r in planted)
            f_norm = max(rel_err(a, b) for r in planted for a, b in zip(r["norms"], want_norms))
            f_flips = max(r["flips"] for r in planted)
            ratio = max(f_loss / MESH_LOSS_TOL, f_norm / MESH_NORM_TOL,
                        f_flips / (MESH_FLIP_SHARE * coords))
            print(f"pipeline {name} with the fault {fault} planted: loss rel |d| {f_loss:.3e}, "
                  f"grad-norm metrics rel |d| {f_norm:.3e}, beyond {MESH_FLIP:g}: {f_flips} of "
                  f"{coords}, max |d| {max(r['max_abs'] for r in planted):.3e}; {ratio:.1f} times "
                  "the widest bound", flush=True)
            check(ratio >= 10, f"{name}: the bounds did not see the planted fault {fault} "
                               "by 10 times")
        if "eval" in extras:
            width = max(i.shape[1] for i in eval_ids + [r["eval_ids"] for r in sound])

            def padded(ids):
                return np.pad(ids, ((0, 0), (0, width - ids.shape[1])))

            want = np.concatenate([padded(i) for i in eval_ids])
            same = [bool(np.array_equal(padded(r["eval_ids"]), want)) for r in sound]
            e_err = max(abs(r["eval_loss"] - eval_loss) / max(1.0, abs(eval_loss))
                        for r in sound)
            print(f"pipeline {name} evaluate (initial weights, beam generation): eval loss rel "
                  f"|d| {e_err:.3e}, ids equal to one process on each rank {same}, walls "
                  f"{[round(r['eval_wall'], 2) for r in sound]} s", flush=True)
            check(e_err <= MESH_LOSS_TOL, f"{name}: eval loss off the one-process evaluation")
            if not all(same):
                explain_pp_ids(torch, device, paths, batch, sound, eval_ids)
        if "checkpoint" in extras:
            single = AATTrainer(mesh_model(0.1), torch.load(paths["init"], weights_only=True,
                                                            map_location=device),
                                mesh_config(output_dir=tmp))
            single.restore_checkpoint(paths["pp_checkpoint"])
            saved = ckpt_lib.read_params(paths["pp_checkpoint"], "cpu")["params"]
            want = flat_to_layout(saved, single.state.params)
            got = ckpt_lib.flatten(single.state.params)
            restored = sorted(got) == sorted(want) and all(torch.equal(got[k].cpu(), want[k])
                                                         for k in want)
            on_disk = tuple(saved["audio_encoder.layers.attention.q.kernel"].shape)
            print(f"pipeline {name} checkpoints: the pp save (stacked on disk, q kernel "
                  f"{on_disk}; {max(r['save_wall'] for r in sound):.1f} s) restored in one "
                  f"process bit for bit: {restored}; the one-process save restored under pp "
                  f"bit for bit on every rank: {[r['restored'] for r in sound]}", flush=True)
            check(on_disk[0] == single.model.audio_encoder_config.num_hidden_layers,
                  "the pp checkpoint is not stacked on disk")
            check(restored, "a one-process trainer did not restore the pp checkpoint")
            check(all(r["restored"] for r in sound), "a pp rank did not restore the "
                                                     "one-process checkpoint")
            del single, saved, want, got
            gc.collect()
            torch.cuda.empty_cache()
    rank0 = results["dp2_pp2"][0]["sound"]
    print(f"phase 18 wall {time.perf_counter() - phase_start:.1f} s", flush=True)
    return rank0["launches"], {**{e: 0 for names in FLASH_ENTRIES.values() for e in names},
                               **rank0["calls"]}


def explain_pp_ids(torch, device, paths, batch, sound, eval_ids):
    """Where the pp ranks' generated ids differ from one process's: both
    generations replayed in this process from each route's prefix
    embeddings, the first differing beam selection of each differing row
    must be a near tie of the one-process scores (phase 12's rule)."""
    _, _, trainer = one_process_eval(torch, device, paths, batch)
    dev = {k: v.to(device) for k, v in eval_batch(batch).items()}
    real_prefix = trainer._prefix_inputs
    for r in sound:
        if r["coords"]["pp"]:
            continue
        d = r["coords"]["dp"]
        rows = {k: v[2 * d:2 * d + 2] for k, v in dev.items()}
        want, plain_calls = beam_choices(lambda: trainer.generate_for_batch(rows))
        trainer._prefix_inputs = lambda params, b: {k: v.to(device) for k, v in r["prefix"].items()}
        try:
            got, pp_calls = beam_choices(lambda: trainer.generate_for_batch(rows))
        finally:
            trainer._prefix_inputs = real_prefix
        check(np.array_equal(got, r["eval_ids"][2 * d:2 * d + 2, :got.shape[1]]),
              "the replayed pp generation differs from the rank's")
        for row in range(2):
            if np.array_equal(got[row], want[row]):
                continue
            split = first_split(pp_calls, plain_calls, row)
            print(f"pipeline ids differ on data rank {d} row {row}: first split {split}",
                  flush=True)
            check(split is not None and split[2] <= split[3],
                  "the pp generation's first differing beam selection is not a near tie")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU route here", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
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
    print(f"optional packages (the port imports them only where the JAX package does): "
          f"{optional_packages()}", flush=True)

    # 2. build
    start = time.perf_counter()
    lib = kernels.library()
    with open(os.path.join(os.path.dirname(lib.path), "nvcc.log"), "w") as f:
        f.write(lib.build_log)  # nvcc and ptxas -v output, beside the library
    usage = ptxas_usage(lib.build_log)
    print(f"build: {time.perf_counter() - start:.1f} s (nvcc {lib.build_seconds:.1f} s) "
          f"{os.path.relpath(lib.path, REPO)}; ptxas: {' | '.join(usage)}", flush=True)
    # the kernels of the last two redesigns: 3xTF32 and the mel kernel
    for kernel in ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3",
                   "vq_nearest", "mel_kernel"):
        print(f"ptxas {kernel}: {' | '.join(u for u in usage if kernel in u)}", flush=True)

    if "--mla" in sys.argv[1:]:
        for kernel in ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma"):
            print(f"ptxas {kernel}: {' | '.join(u for u in usage if kernel in u)}", flush=True)
        print(json.dumps({"mla": phase_mla_kernels(torch, device, np.random.default_rng(20))}),
              flush=True)
        others = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
        if others:
            print(json.dumps({"ab_rows": ab_flash_entries(torch, device, others)}), flush=True)
        print(smi_line, flush=True)
        return 0
    rng = np.random.default_rng(0)
    # 3-4. kernels vs their plain versions
    mel_result = phase_mel(torch, device, rng)
    serve_fwd_result = phase_flash(torch, device, rng)
    # 7. training kernels vs their plain versions, and the bf16 kernels'
    # keep masks read through identity operands
    train_results = phase_flash_train(torch, device, rng)
    phase_keep_mask(torch, device, rng)
    phase_backward_keep_mask(torch, device, rng)
    # 19. the element dropout's kernel vs its plain version
    phase_dropout(torch, device)
    # 20. the latent-attention kernels vs their plain versions
    phase_mla_kernels(torch, device, np.random.default_rng(20))

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
    calls = reset_entry_calls()
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
    launches = {name: w.launches for name, w in kernel_wrappers().items()}
    serve_calls = flash_entry_calls(calls, "serving (f32)", "float32", backward=False)

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
    train_launches, train_calls = phase_training(torch, model, params, rng, smi_line)
    # 12. train → evaluate → save → resume → finalize on those weights
    eval_launches, eval_calls, prefix_launches, prefix_calls = phase_checkpoint(
        torch, model, params, rng, smi_line)
    # 15. remat of the whole-utterance step, Adafactor and the unfused chain
    pieces = phase_trainer_pieces(torch, model, params, rng, smi_line)
    # 16. the transformer_encoder projection and EfficientNet-b0 on the same
    # encoder and LM (a generator of its own: the later phases draw as before)
    start = time.perf_counter()
    rng16 = np.random.default_rng(16)
    pieces["train_pooling"] = phase_pooling(torch, model, params, rng16, smi_line)
    pieces["train_efficientnet"] = phase_efficientnet(
        torch, params["lm_decoder"], model.lm_config, device, rng16, smi_line)
    print(f"phase 16a-b wall {time.perf_counter() - start:.1f} s", flush=True)
    del model, params  # SmolLM and its encoder leave the card before Qwen comes
    gc.collect()
    torch.cuda.empty_cache()
    # 17-18. multi-device and pipeline-parallel training: 4 gloo ranks on the
    # card, NCCL at world 1
    pieces.update(phase_multidevice(torch, device, np.random.default_rng(17), smi_line))
    # 13. the command lines at full width: the readers, train (and resume),
    # validate and serve
    (cli_launches, cli_calls, cli_prefix_launches, cli_prefix_calls, serve_cli_launches,
     serve_cli_calls, pieces["dataset"], pieces["train_unfreeze_cli"],
     pieces["train_projections_cli"]) = phase_cli(torch, device, rng, smi_line)
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
    longform_launches, longform_calls, pieces["longform_remat"] = phase_longform(
        torch, device, rng, smi_line)

    # phases 12 and 13's training paths in two parts: training and eval loss
    # (bf16), and the generation prefix (f32)
    paths = {"serve": launches, "train": train_launches, "pipeline": pipeline_launches,
             "longform": longform_launches, "train_eval": eval_launches,
             "train_eval_prefix": prefix_launches, "train_cli": cli_launches,
             "train_cli_prefix": cli_prefix_launches, "serve_cli": serve_cli_launches,
             **{path: launches for path, (launches, _) in pieces.items()}}
    # the flash launches by C entry (the pipeline launches no flash kernel)
    path_calls = {"serve": serve_calls, "train": train_calls, "pipeline": {},
                  "longform": longform_calls, "train_eval": eval_calls,
                  "train_eval_prefix": prefix_calls, "train_cli": cli_calls,
                  "train_cli_prefix": cli_prefix_calls, "serve_cli": serve_cli_calls,
                  **{path: calls for path, (_, calls) in pieces.items()}}

    def entry(name, source, replaces, path, result, counter=None, c_entry=None):
        """``launches`` counts the run of ``path``, the path whose shapes the
        times are taken at; ``launches_by_path`` every main path's run. A
        flash entry reads the counter of its TPU kernel (``counter``) on the
        paths whose launches went through its C entry ``c_entry`` (a list
        where the wrapper launches two; each path goes through one dtype's
        entries only, as checked)."""
        counter = counter or name
        entries = [c_entry] if isinstance(c_entry, str) else c_entry or []
        by_path = {p: counts.get(counter, 0)
                   if all(path_calls[p].get(e, 0) for e in entries) else 0
                   for p, counts in paths.items()}
        return {"name": name, "route": "cuda", "source": f"aat_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": by_path[path], "launches_by_path": by_path,
                **({"c_entry": c_entry} if c_entry else {}), **result}

    # the flash kernels: bf16 on the tensor cores at the path's shapes, with
    # the f32 kernels' results there under f32_ keys; the 3xTF32 forward's
    # own entry carries serving's f32 launches at serving's shape
    both_bwd = ["aat_flash_bwd_dq_mma", "aat_flash_bwd_dkv_mma"]
    kernels_line = {"kernels": [
        entry("mel", "mel.cu", "aat_tpu/ops/mel_pallas.py:36", "serve", mel_result),
        entry("flash_fwd", "flash_fwd_mma.cu", "aat_tpu/ops/attention.py:186", "longform",
              split_results["fwd_dense"], c_entry="aat_flash_fwd_mma"),
        entry("flash_fwd_causal", "flash_fwd_mma.cu", "aat_tpu/ops/attention.py:245",
              "longform", split_results["fwd_causal"], c_entry="aat_flash_fwd_mma"),
        entry("flash_fwd_f32", "flash_fwd_tf32x3.cu", "aat_tpu/ops/attention.py:186", "serve",
              serve_fwd_result, counter="flash_fwd", c_entry="aat_flash_fwd_tf32x3"),
        entry("flash_bwd", "flash_bwd_mma.cu", "aat_tpu/ops/attention.py:764", "train",
              train_results["bwd_dense"], c_entry=both_bwd),
        entry("flash_bwd_causal", "flash_bwd_mma.cu", "aat_tpu/ops/attention.py:709", "train",
              train_results["bwd_causal"], c_entry=both_bwd),
        entry("flash_bwd_dq_long", "flash_bwd_mma.cu", "aat_tpu/ops/attention.py:562",
              "longform", split_results["dq_dense"], c_entry="aat_flash_bwd_dq_mma"),
        entry("flash_bwd_dkv_long", "flash_bwd_mma.cu", "aat_tpu/ops/attention.py:595",
              "longform", split_results["dkv_dense"], c_entry="aat_flash_bwd_dkv_mma"),
        entry("vq", "vq.cu", "aat_tpu/ops/vq.py:50", "pipeline", vq_result),
    ]}
    for k in kernels_line["kernels"]:
        check(all(key in k for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err")), f"kernel entry {k['name']} incomplete")
        check(k["launches"] > 0, f"kernel entry {k['name']}: no launch on its path")
        if k["name"].startswith("flash_bwd"):
            check(all(f"f32_{key}" in k for key in ("ms", "plain_ms", "bound_ms", "library_ms")),
                  f"kernel entry {k['name']}: f32 results incomplete")
    print(json.dumps(kernels_line), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
