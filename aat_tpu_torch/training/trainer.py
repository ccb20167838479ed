"""ASLM trainer (counterpart of ``aat_tpu/training/trainer.py``): audio
encoding → projection → input assembly → caption cross-entropy, gradient
accumulation over microbatches, and the fused
guarded AdamW update, through the same entry points as the JAX package
(``AATTrainer(model, params, config).training_step(microbatches)``,
``train(batches, eval_batches=..., resume_from_checkpoint=...)``,
``evaluate``, ``save_checkpoint`` / ``restore_checkpoint``,
``save_pretrained`` and ``finalize``).

Mixed precision as in JAX: the parameters are float32 masters; with
``compute_dtype="bfloat16"`` the forward runs on differentiable bf16
copies, so the gradients land on the masters in float32. Frozen subtrees
are detached (``_stop_grad_frozen``): no parameter gradient is formed for
them, while activation gradients still flow through them (through the
frozen LM to the audio embeddings, which runs the causal flash backward).
Evaluation's loss runs at the compute dtype; its generation prefix encodes
with the f32 masters, uncast, as JAX's does.

Train-mode dropout seeds derive from ``(config.seed, step, microbatch)``
alone (:func:`~aat_tpu_torch.ops.dropout.fold_seed`), so a resumed run
draws the same masks. The JAX package gets this from ``fold_in``; its
bits cannot be reproduced here, so the two trainers' dropout masks differ
by construction (parity tests run with dropout off or with explicit seeds).

Checkpoints are the port's own files (:mod:`~aat_tpu_torch.training.
checkpoint`) in JAX's ``checkpoint-{step}`` layout; a JAX run's orbax
state converts into them through :func:`aat_tpu_torch.utils.port.
checkpoint_from_jax`.

The optimizer is the JAX trainer's (``_build_tx``): the fused guarded
AdamW by default, the unfused ``adamw_grouped`` chain, or ``adafactor``
(``learning_rate=None``: its relative step), under ``guard_nonfinite``
when ``skip_nonfinite_updates``. :meth:`AATTrainer.unfreeze_lm_decoder`
starts training the LM mid-run. Encoder remat is the encoder config's
(``HubertConfig.remat``, set from ``encoder_remat`` by ``models/build``).

EfficientNet melspec batches (``batched_segments_melspectrograms``, ``[B,
S, n_mels, T]``) run the encoder's batch norm in train mode in the
training step, as the reference's ``.train()`` model does: after the
optimizer's update, each microbatch's batch statistics fold into the
running estimates in microbatch order (JAX ``_fold_bn_stats``), also with
the encoder frozen and also when the guard drops the update. The running
statistics get zero gradients, so the optimizer leaves them unmoved (they
are 1-D: no weight decay). Evaluation and the generation prefix normalize
with the running statistics.

Multi-device training (``mesh_dp/fsdp/tp/sp/pp`` or ``mesh=``, one process
per device in an initialized process group, :mod:`aat_tpu_torch.parallel`):
each rank keeps its shards of the parameters and of the optimizer state
(``parallel.mesh.shard_params``, the JAX rules) and reads its rows of the
global batch (``mesh.local_batch``; tp, sp and pp peers read the same
rows). The trainer sets the mesh on the model (and clears a stale one):
HuBERT and the LM run their layers as tensor-parallel bodies where their
``tp_partitionable`` holds, HuBERT its layer stack on a time slice under
sp, both stacks as a GPipe pipeline under pp (``pp_microbatches``;
sp with pp is refused, as in JAX), EfficientNet its batch norm over the
global batch, and every dropout mask is keyed on global positions. The
caption CE divides each rank's sum by the global token count (the counts
are all-reduced first), so the ranks' losses sum to the one-device loss
however captions pad; the gradients are summed over the ranks that
computed distinct parts of them (``Mesh.reduce_grads``), and the guard,
the clip and Adafactor's means read the whole sharded leaves and tree.
``evaluate`` gives the global batch's loss and generations on every rank.
``save_checkpoint`` gathers the full state and rank 0 writes today's
format, so a checkpoint restores under any layout; ``restore_checkpoint``
slices it again.

Under pp the encoder's and the LM's ``layers`` lists are stacked at
construction, before the freeze mask, the optimizer and placement (JAX's
stage-resident masters): parameters, gradients and moments live one
stage slice per rank, and Adafactor factors the stacked leaves (JAX's pp
math). A pp checkpoint keeps that layout on disk: ``params.pt`` holds
``audio_encoder.layers.attention.q.kernel`` as one ``[L, ...]`` tensor
where a one-process checkpoint holds ``audio_encoder.layers.<i>.…``, and
its moments follow. ``restore_checkpoint`` reads either layout into
either trainer, the params bit for bit; across layouts the optimizer state
is re-initialized with a warning, as in JAX. ``save_pretrained`` exports
the per-layer (interchange) layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from aat_tpu_torch.models import decoders
from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.models import llama as llm
from aat_tpu_torch.models.aslm import AslmModel
from aat_tpu_torch.ops.dropout import fold_seed
from aat_tpu_torch.parallel import comm
from aat_tpu_torch.parallel import mesh as mesh_lib
from aat_tpu_torch.parallel import pipeline
from aat_tpu_torch.training import checkpoint as ckpt_lib
from aat_tpu_torch.training import optim as optim_lib
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.lr_schedule import warmup_linear_schedule
from aat_tpu_torch.utils import port, timing

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def caption_ce_sum(logits: torch.Tensor, input_ids: torch.Tensor,
                   input_ids_attention_mask: torch.Tensor):
    """(sum of the shifted caption CE over unpadded targets, their count),
    in float32. Accepts full-sequence logits [B, T, V] or caption-presliced
    logits [B, C−1, V]."""
    caption_len = input_ids.shape[1]
    pred = logits if logits.shape[1] == caption_len - 1 else logits[:, -caption_len:-1, :]
    targets = input_ids[:, 1:].long()
    mask = input_ids_attention_mask[:, 1:].float()
    ce = F.cross_entropy(pred.float().reshape(-1, pred.shape[-1]), targets.reshape(-1),
                         reduction="none").reshape(targets.shape)
    return (ce * mask).sum(), mask.sum()


def caption_cross_entropy(logits: torch.Tensor, input_ids: torch.Tensor,
                          input_ids_attention_mask: torch.Tensor) -> torch.Tensor:
    """Shifted caption CE over the trailing caption positions, pad-masked,
    in float32 (the mean of :func:`caption_ce_sum`)."""
    total, count = caption_ce_sum(logits, input_ids, input_ids_attention_mask)
    return total / torch.clamp_min(count, 1.0)


class AATTrainer:
    """Audio-adaptive-tokenizer trainer (whole-utterance, segmented and
    raw-waveform batches)."""

    def __init__(self, model: AslmModel, params: Any, config: TrainingConfig, mesh=None,
                 compute_metrics: Optional[Callable] = None,
                 log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
                 tokenizer=None, generation_config=None):
        self.model = model
        self.config = config
        pp = mesh.size("pp") if mesh is not None else config.mesh_pp
        if decoders.decoder_type(model.lm_config) == decoders.DEEPSEEK_V2:
            sizes = {axis: mesh.size(axis) if mesh is not None else getattr(config, f"mesh_{axis}")
                     for axis in ("tp", "pp", "sp")}
            refused = [f"{axis}={n}" for axis, n in sizes.items() if n > 1]
            if refused:
                raise ValueError(f"the DeepSeek-V2 decoder trains under dp and fsdp only; "
                                 f"{', '.join(refused)} is not supported")
        if pp > 1:
            for cfg in (model.audio_encoder_config, model.lm_config):
                if isinstance(cfg, (hub.HubertConfig, llm.LlamaConfig)):
                    pipeline.check_layers(cfg.num_hidden_layers, pp)
        self.mesh = self._make_mesh(config, mesh)
        self._route_models()
        self.tokenizer = tokenizer
        self.generation_config = generation_config
        self.compute_metrics = compute_metrics
        self.log_fn = log_fn or (lambda metrics: logger.info("metrics %s", metrics))
        # learning_rate=None: Adafactor's relative step, no external schedule
        self.schedule = None if config.learning_rate is None else warmup_linear_schedule(
            config.learning_rate, config.warmup_steps, config.max_steps or 100000,
            config.start_lr_from)
        # stage-resident masters: the pipelined stacks are stacked before the
        # freeze mask, the optimizer and placement
        params = {k: pipeline.stack_model_layers(v) if k in self._pipelined else v
                  for k, v in params.items()}
        self.freeze = optim_lib.trainable_mask(
            params, train_audio_encoder=config.train_audio_encoder,
            train_lm_decoder=config.train_lm_decoder)
        # Adafactor's factored axes, from the whole (unsharded) shapes
        self._factor_axes = {
            path: optim_lib.factored_dims(p.shape)
            for path, p in zip(optim_lib.tree_leaves(optim_lib.tree_paths(params)),
                               optim_lib.tree_leaves(params)) if p.ndim >= 2}
        self._factor_axes.update(port.adafactor_axes(params))
        if self.mesh is not None:
            self.specs = mesh_lib.shard_params(params, self.mesh.shape, self._stacked_tp)
            params = mesh_lib.place_params(params, self.specs, self.mesh)
        self.tx = self._build_tx(params)
        self.device = optim_lib.tree_leaves(params)[0].device
        self.state = TrainState(0, params, self.tx.init(params))
        # load_best_model_at_end bookkeeping
        self._best_metric: Optional[float] = None
        self._best_checkpoint: Optional[str] = None

    @staticmethod
    def _make_mesh(config: TrainingConfig, mesh):
        """The mesh of ``mesh_*`` (JAX's refusal of sp with pp first), or the
        one given; None for one device."""
        sizes = dict(dp=config.mesh_dp, fsdp=config.mesh_fsdp, tp=config.mesh_tp,
                     sp=config.mesh_sp, pp=config.mesh_pp)
        sp_pp = (mesh.size("sp"), mesh.size("pp")) if mesh is not None else (sizes["sp"],
                                                                                sizes["pp"])
        if min(sp_pp) > 1:
            raise ValueError("mesh_sp and mesh_pp are mutually exclusive (as in the JAX "
                             "trainer)")
        if mesh is None and any(v != 1 for v in sizes.values()):
            mesh = mesh_lib.make_mesh(**sizes)
        return mesh

    def _route_models(self):
        """Set this trainer's mesh (or None) and pipeline microbatch count on
        the model, clearing any a previous trainer left."""
        model = self.model
        model.mesh = self.mesh
        model.pp_microbatches = 0
        self._pipelined, self._stacked_tp = (), None
        if self.mesh is None:
            self._tp_bodies = self._sp_paths = ()
            return
        tp = self.mesh.size("tp")
        enc_cfg = model.audio_encoder_config
        hubert_like = isinstance(enc_cfg, hub.HubertConfig)
        tp_on = {"audio_encoder": hubert_like and hub.tp_partitionable(enc_cfg, tp),
                 "lm_decoder": llm.tp_partitionable(model.lm_config, tp)}
        self._tp_bodies = tuple(f"{k}/layers/" for k, on in tp_on.items() if on)
        self._sp_paths = (("audio_encoder/layers/",)
                          if hubert_like and self.mesh.size("sp") > 1 else ())
        if self.mesh.size("pp") > 1:
            # the stacks whose widths divide tp are also tp-sharded (the same
            # predicate gates the tensor-parallel bodies)
            model.pp_microbatches = self.config.pp_microbatches
            self._pipelined = ("audio_encoder", "lm_decoder") if hubert_like else ("lm_decoder",)
            self._stacked_tp = tp_on

    def _norm(self, tree, specs=None):
        """The global norm of a gradient tree (or subtree, with its
        ``specs``), over every shard under a mesh."""
        if self.mesh is None:
            return optim_lib.global_norm(tree)
        return self.mesh.global_norm(tree, self.specs if specs is None else specs)

    def _build_tx(self, params):
        """The JAX trainer's choice: the fused guarded AdamW when the guard
        is on; else the unfused chain (the clip in the chain); Adafactor
        under the guard (no clip) or alone. The global norm is the mesh's
        over shards, or :func:`~aat_tpu_torch.training.optim.global_norm`
        (which the fused AdamW's kernel computes itself)."""
        cfg = self.config
        norm = optim_lib.global_norm if self.mesh is None else self._norm
        if cfg.optimizer == "adamw" and cfg.skip_nonfinite_updates:
            return optim_lib.fused_guarded_adamw(
                self.schedule, params, weight_decay=cfg.weight_decay,
                clip_norm=cfg.grad_clip_norm, freeze=self.freeze, norm=norm)
        if cfg.optimizer == "adamw":
            tx = optim_lib.adamw_grouped(self.schedule, params, weight_decay=cfg.weight_decay,
                                         grad_clip_norm=cfg.grad_clip_norm, freeze=self.freeze,
                                         norm=norm)
        elif cfg.optimizer == "adafactor":
            tx = optim_lib.adafactor(self.schedule, freeze=self.freeze, axes=self._factor_axes,
                                     mesh=self.mesh,
                                     specs=self.specs if self.mesh is not None else None)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer}")
        return (optim_lib.guard_nonfinite(tx, norm=norm) if cfg.skip_nonfinite_updates
                else tx)

    def _use(self, params, grad: bool = True):
        """The parameters the forward uses: under a mesh, the sharded leaves
        gathered (tp shards kept in the tensor-parallel bodies)."""
        if self.mesh is None:
            return params
        return self.mesh.use_params(params, self.specs, self._tp_bodies, grad=grad)

    def _data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks (no gradient; one device: ``x``)."""
        return x if self.mesh is None else comm.all_reduce(x, self.mesh.group("dp", "fsdp"))

    def _batch_ce(self, logits, batch) -> torch.Tensor:
        """This rank's share of the global batch's caption CE: its sum over
        the global count (the shares sum to the one-device loss)."""
        total, count = caption_ce_sum(logits, batch["input_ids"], batch["input_ids_attention_mask"])
        return total / torch.clamp_min(self._data_sum(count), 1.0)

    # ------------------------------------------------------------------
    # Forward assembly (segmented + whole-utterance)
    # ------------------------------------------------------------------

    def _cast_for_compute(self, params):
        """Mixed precision: differentiable bf16 copies of the f32 masters."""
        if self.config.compute_dtype != "bfloat16":
            return params
        return optim_lib.tree_map(
            lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x, params)

    def _stop_grad_frozen(self, params):
        """Frozen submodules get no parameter gradient (the reference's
        no_grad); activation gradients still flow through them."""
        p = dict(params)
        if not self.config.train_audio_encoder:
            p["audio_encoder"] = optim_lib.tree_map(torch.Tensor.detach, params["audio_encoder"])
        if not self.config.train_lm_decoder:
            p["lm_decoder"] = optim_lib.tree_map(torch.Tensor.detach, params["lm_decoder"])
        return p

    def _segment_on_device(self, batch):
        """Raw padded waveforms → segment batch on the device."""
        from aat_tpu_torch.data.ondevice import segment_raw_batch

        return segment_raw_batch(
            batch, segmentation=self.config.segmentation,
            max_segment_frames=self.config.max_segment_frames,
            max_segments=self.config.max_on_device_segments,
            sampling_rate=self.config.sampling_rate,
            tokenizer_config=getattr(self, "tokenizer_config", None))

    def _assemble_and_forward(self, params, batch, dropout_seed: Optional[int] = None,
                              train: bool = False):
        """→ (caption logits, assembled inputs, BN statistics). The
        statistics are ``{}`` except on EfficientNet melspec batches with
        ``train``, where the encoder's batch norm runs in train mode."""
        model = self.model
        compute_dtype = (torch.bfloat16 if self.config.compute_dtype == "bfloat16"
                         else torch.float32)
        params = self._cast_for_compute(self._stop_grad_frozen(params))
        s_enc = s_proj = None
        if dropout_seed is not None:
            s_enc, s_proj = fold_seed(dropout_seed, 0), fold_seed(dropout_seed, 1)
        bn_stats = {}
        if "raw_waveforms" in batch:
            batch = self._segment_on_device(batch)
        if "batched_segments_melspectrograms" in batch:
            # [B, S, n_mels, T] → [B*S, n_mels, T]
            mels = batch["batched_segments_melspectrograms"]
            b, s = mels.shape[:2]
            encoded = model.encode_audio_melspec(
                params, mels.reshape(b * s, *mels.shape[2:]).to(compute_dtype),
                batch["segments_boarders_attention_mask"].reshape(b * s), train=train)
            audio_embeds, frame_mask = encoded[:2]
            if train:
                bn_stats = encoded[2]
            segments_count = s
        elif "batched_segments" in batch:
            seg = batch["batched_segments"]
            b, s, f = seg.shape
            audio_embeds, frame_mask = model.encode_audio(
                params, seg.reshape(b * s, f).to(compute_dtype),
                batch["segments_waveforms_mask"].reshape(b * s, f),
                batch["segments_boarders_attention_mask"].reshape(b * s),
                dropout_seed=s_enc)
            segments_count = s
        else:  # whole utterance
            audio_embeds, frame_mask = model.encode_audio(
                params, batch["waveforms"].to(compute_dtype), batch["waveforms_attention_mask"],
                None, dropout_seed=s_enc)
            segments_count = None
        inputs = model.prepare_audio_inputs(
            params, audio_embeds=audio_embeds, frame_mask=frame_mask,
            input_ids=batch["input_ids"], attention_mask=batch["attention_mask"],
            segments_count=segments_count, dropout_seed=s_proj)
        logits = model.forward(params, inputs["inputs_embeds"], inputs["attention_mask"],
                               pack=self.config.lm_pack,
                               caption_len=batch["input_ids"].shape[1])
        return logits, inputs, bn_stats

    def _debug_metrics(self, params, batch, inputs) -> Dict[str, torch.Tensor]:
        """The reference's compute_loss debug block, on the device, over the
        global batch (``params`` whole: the adapter's embedding is read)."""
        with torch.no_grad():
            embeds = inputs["inputs_embeds"]
            am = inputs["audio_embeds_attention_mask"]
            audio_len = am.shape[-1]
            flat_audio = inputs["audio_embeds"].reshape(-1, embeds.shape[-1]).float()
            audio_m = am.reshape(-1).float()
            audio_norms = torch.linalg.norm(flat_audio, dim=-1)
            denom_a = torch.clamp_min(self._data_sum(audio_m.sum()), 1.0)
            text_embeds = embeds[:, audio_len + 2:, :].float()
            text_m = batch["attention_mask"].float()
            text_norms = torch.linalg.norm(text_embeds, dim=-1)
            denom_t = torch.clamp_min(self._data_sum(text_m.sum()), 1.0)
            emb = params["adapter"]["audio_tokens_embeddings"]["embedding"].float()
            seq_len = torch.full((), float(inputs["attention_mask"].shape[-1]),
                                 device=embeds.device)
            if self.mesh is not None:
                seq_len = comm.all_reduce(seq_len, self.mesh.group("dp", "fsdp"),
                                          dist.ReduceOp.MAX)
            mean = {
                "debug/audio_embeddings_norm_mean": ((audio_norms * audio_m).sum(), denom_a),
                "debug/audio_embeddings_mean": ((flat_audio.mean(-1) * audio_m).sum(), denom_a),
                "debug/text_embeddings_norm_mean": ((text_norms * text_m).sum(), denom_t),
                "debug/text_embeddings_mean": ((text_embeds.mean(-1) * text_m).sum(), denom_t),
            }
            return {
                "debug/seq_len": seq_len,
                **{k: self._data_sum(total) / denom for k, (total, denom) in mean.items()},
                "debug/audio_bos_mean": emb[0].mean(),
                "debug/audio_bos_norm": torch.linalg.norm(emb[0]),
                "debug/audio_eos_mean": emb[1].mean(),
                "debug/audio_eos_norm": torch.linalg.norm(emb[1]),
            }

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _grad_step(self, params, batch, dropout_seed: Optional[int]):
        """→ (grads, metrics, bn_stats): grads is the params tree with
        float32 tensors on trainable leaves (zeros where a skipped layer, or
        a running BN statistic, left none) and ``None`` on frozen ones;
        bn_stats the EfficientNet batch statistics (``{}`` otherwise)."""
        leaves = optim_lib.tree_map(
            lambda p, t: p.detach().requires_grad_(True) if t else p.detach(),
            params, self.freeze)
        used = self._use(leaves)
        on_cuda = self.device.type == "cuda"
        with timing.span("train.forward", device=on_cuda):
            logits, inputs, bn_stats = self._assemble_and_forward(used, batch, dropout_seed,
                                                                  train=True)
            loss = self._batch_ce(logits, batch)
        trainable = [x for x, t in zip(optim_lib.tree_leaves(leaves),
                                       optim_lib.tree_leaves(self.freeze)) if t]
        with timing.span("train.backward", device=on_cuda):
            found = iter(torch.autograd.grad(loss, trainable, allow_unused=True))

        def grad_of(p, t):
            if not t:
                return None
            g = next(found)
            return torch.zeros_like(p) if g is None else g

        grads = optim_lib.tree_map(grad_of, params, self.freeze)
        if self.mesh is not None:
            grads = self._reduce_grads(grads)
        metrics = self._debug_metrics(used, batch, inputs)
        metrics["train/loss"] = self._data_sum(loss.detach())
        # reference training_step grad norms
        specs = self.specs if self.mesh is not None else None
        metrics["train/audio_tokens_emb_grad"] = self._norm(
            grads["adapter"]["audio_tokens_embeddings"],
            specs and specs["adapter"]["audio_tokens_embeddings"])
        if self.config.train_audio_encoder and "feature_projection" in grads.get(
                "audio_encoder", {}):
            metrics["train/audio_encdoer_grad_norm"] = self._norm(
                grads["audio_encoder"]["feature_projection"]["projection"],
                specs and specs["audio_encoder"]["feature_projection"]["projection"])
        return grads, metrics, bn_stats

    def _reduce_grads(self, grads):
        """Each gradient summed over the ranks that computed distinct parts
        of it (:meth:`~aat_tpu_torch.parallel.mesh.Mesh.reduce_grads`)."""
        return self.mesh.reduce_grads(grads, self.specs, self._sp_paths)

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if v is None or k == "segments_count":
                continue
            out[k] = (v.to(self.device) if torch.is_tensor(v)
                      else torch.as_tensor(np.asarray(v), device=self.device))
        return out

    def dropout_seed(self, step: int, microbatch: int) -> int:
        """The int32 dropout seed of one microbatch of one optimizer step."""
        return fold_seed(self.config.seed, step, microbatch)

    def training_step(self, microbatches: List[dict],
                      fetch_metrics: bool = True) -> Dict[str, float]:
        """One optimizer step over the microbatches: gradients summed, then
        divided by their count (metrics averaged the same way), then the
        optimizer's update in place, then each microbatch's EfficientNet BN
        statistics folded into the running estimates, in order. Returns host
        metrics when ``fetch_metrics`` (one device sync)."""
        with timing.span("train.step"):
            acc_grads = acc_metrics = None
            bn_stats_seq = []
            for idx, mb in enumerate(microbatches):
                with timing.span("train.h2d"):
                    batch = self._to_device(mb)
                grads, metrics, bn_stats = self._grad_step(self.state.params, batch,
                                                           self.dropout_seed(self.state.step, idx))
                if bn_stats:
                    bn_stats_seq.append(bn_stats)
                if acc_grads is None:
                    acc_grads, acc_metrics = grads, metrics
                else:
                    acc_grads = optim_lib.tree_map(
                        lambda a, g: None if a is None else a + g, acc_grads, grads)
                    acc_metrics = {k: acc_metrics[k] + v for k, v in metrics.items()}
                del grads
            with timing.span("train.optimizer", device=self.device.type == "cuda"):
                n = len(microbatches)
                if n > 1:
                    acc_metrics = {k: v / n for k, v in acc_metrics.items()}
                with torch.no_grad():
                    opt_state = self.tx.step(acc_grads, n, self.state.opt_state,
                                             self.state.params)
                    if bn_stats_seq:
                        self._fold_bn_stats(bn_stats_seq)
            self.state = TrainState(self.state.step + 1, self.state.params, opt_state)
            return self._finish_metrics(acc_metrics, fetch_metrics)

    def _fold_bn_stats(self, stats_seq):
        """EMA each microbatch's EfficientNet batch statistics into the
        running estimates, in order, in place (torch updates them once per
        train-mode forward; JAX ``_fold_bn_stats``)."""
        from aat_tpu_torch.models.efficientnet import apply_bn_updates

        encoder = self.state.params["audio_encoder"]
        folded = encoder
        for stats in stats_seq:
            folded = apply_bn_updates(folded, stats)
        optim_lib.tree_map(lambda p, x: None if p is x else p.copy_(x), encoder, folded)

    def _finish_metrics(self, acc_metrics, fetch_metrics: bool) -> Dict[str, float]:
        if not fetch_metrics:
            return {}
        names = list(acc_metrics)
        values = [acc_metrics[k].float() for k in names]
        guarded = self.config.skip_nonfinite_updates
        if guarded:
            values.append(self.state.opt_state.total_notfinite.float())
        values = torch.stack(values).cpu().tolist()
        host = dict(zip(names, values))
        if guarded:
            host["train/skipped_nonfinite_total"] = values[-1]
            if not np.isfinite(host["train/loss"]):
                logger.warning("non-finite loss %s at step %d (update dropped)",
                               host["train/loss"], self.state.step)
        return host

    def unfreeze_lm_decoder(self):
        """Train the LM decoder from here on (the reference's
        ``unfreeze_lm_at_epoch``): the freeze mask and the optimizer are
        rebuilt, every optimizer-state leaf whose path, shape and dtype
        match is carried over (the moments of what already trained, and the
        step count), and the LM's moments start fresh
        (:func:`~aat_tpu_torch.training.optim.merge_matching_state`).
        ``config.train_lm_decoder`` becomes True, so the forward stops
        detaching the LM and its parameters get gradients."""
        self.config.train_lm_decoder = True
        self.freeze = optim_lib.trainable_mask(
            self.state.params, train_audio_encoder=self.config.train_audio_encoder,
            train_lm_decoder=True)
        self.tx = self._build_tx(self.state.params)
        merged = optim_lib.merge_matching_state(self.state.opt_state,
                                                self.tx.init(self.state.params))
        self.state = TrainState(self.state.step, self.state.params, merged)
        logger.info("lm decoder unfrozen at step %d", self.state.step)

    def train(self, train_batches: Iterable[dict],
              eval_batches: Optional[Callable[[], Iterable[dict]]] = None,
              resume_from_checkpoint: Optional[str] = None, fast_forward: bool = False):
        """Run one epoch over ``train_batches``: a step every
        ``gradient_accumulation_steps`` microbatches (a trailing partial
        group is dropped), metrics logged every ``logging_steps``, an
        evaluation of ``eval_batches()`` every ``eval_steps``, a checkpoint
        every ``save_steps``, stop at ``max_steps`` (or early stopping).
        ``resume_from_checkpoint`` restores in place first, then
        fast-forwards; ``fast_forward`` skips the microbatches that the
        restored step implies this epoch already consumed (HF
        ``resume_from_checkpoint`` semantics; whole completed epochs are the
        caller's to skip)."""
        cfg = self.config
        skip_micro = 0
        if resume_from_checkpoint:
            self.restore_checkpoint(resume_from_checkpoint)
            fast_forward = True
        if fast_forward:
            # an epoch consumes steps_per_epoch * accum microbatches (the
            # trailing partial group is dropped), so the position within the
            # epoch is step % steps_per_epoch
            if hasattr(train_batches, "__len__") and len(train_batches) > 0:
                steps_per_epoch = len(train_batches) // cfg.gradient_accumulation_steps
                if steps_per_epoch > 0:
                    skip_micro = ((self.state.step % steps_per_epoch)
                                  * cfg.gradient_accumulation_steps)
            logger.info("resume: skipping %d microbatches", skip_micro)
        early_stopping = (EarlyStopping(cfg.early_stopping_patience, cfg.early_stopping_threshold)
                          if cfg.early_stopping_patience else None)

        micro: List[dict] = []
        last_eval_metric: Optional[float] = None
        last_eval_step: Optional[int] = None
        t_start = time.perf_counter()
        for batch in train_batches:
            if skip_micro > 0:
                skip_micro -= 1
                continue
            micro.append(batch)
            if len(micro) < cfg.gradient_accumulation_steps:
                continue
            will_log = (self.state.step + 1) % cfg.logging_steps == 0
            metrics = self.training_step(micro, fetch_metrics=will_log)
            micro = []
            step = self.state.step
            if step % cfg.logging_steps == 0:
                metrics["train/step_time"] = (time.perf_counter() - t_start) / cfg.logging_steps
                if self.schedule is not None:
                    metrics["train/lr"] = float(self.schedule(step))
                self.log_fn(metrics)
                t_start = time.perf_counter()
            if cfg.eval_steps and step % cfg.eval_steps == 0 and eval_batches is not None:
                eval_metrics = self.evaluate(eval_batches())
                self.log_fn(eval_metrics)
                last_eval_metric = eval_metrics.get(cfg.metric_for_best_model)
                last_eval_step = step
                if early_stopping is not None and early_stopping.should_stop(eval_metrics):
                    logger.info("early stopping at step %d", step)
                    break
            if cfg.save_steps and step % cfg.save_steps == 0:
                # best-model credit only for a metric measured on THESE
                # weights (an earlier eval's would credit a checkpoint that
                # never achieved it)
                fresh_metric = last_eval_metric if last_eval_step == step else None
                path = self.save_checkpoint(metric=fresh_metric)
                self._track_best(path, fresh_metric)
            if cfg.max_steps is not None and step >= cfg.max_steps:
                break
        return self.state

    def _track_best(self, path: str, metric: Optional[float]):
        if metric is None:
            return
        better = self._best_metric is None or (
            metric > self._best_metric if self.config.greater_is_better
            else metric < self._best_metric)
        if better:
            self._best_metric = metric
            self._best_checkpoint = path

    def finalize(self):
        """End-of-training hook: reload the best checkpoint's params when
        ``load_best_model_at_end``. Only the weights roll back: the step and
        the optimizer state stay, so a later ``save_checkpoint`` does not
        stamp earlier moments with the final step."""
        if not (self.config.load_best_model_at_end and self._best_checkpoint):
            return
        logger.info("loading best model (%s=%s) from %s", self.config.metric_for_best_model,
                    self._best_metric, self._best_checkpoint)
        step, opt_state = self.state.step, self.state.opt_state
        self.restore_checkpoint(self._best_checkpoint, restore_opt_state=False)
        self.state = TrainState(step, self.state.params, opt_state)

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def _eval_loss(self, params, batch) -> torch.Tensor:
        """Caption CE of a device batch (under a mesh: of the global batch)
        at the compute dtype, no dropout (the JAX ``_eval_step``), as a
        device scalar."""
        with torch.no_grad():
            logits, _, _ = self._assemble_and_forward(params, batch)
            return self._data_sum(self._batch_ce(logits, batch))

    def _prefix_inputs(self, params, batch) -> dict:
        """[audio | prefix text] embeds for generation, encoded with the f32
        masters as they are (no compute-dtype cast), from whole-utterance,
        segmented, raw-waveform or melspec (eval-mode BN) device batches."""
        model = self.model
        with torch.no_grad():
            if "raw_waveforms" in batch:
                batch = self._segment_on_device(batch)
            if "batched_segments_melspectrograms" in batch:
                mels = batch["batched_segments_melspectrograms"]
                b, s = mels.shape[:2]
                audio_embeds, frame_mask = model.encode_audio_melspec(
                    params, mels.reshape(b * s, *mels.shape[2:]),
                    batch["segments_boarders_attention_mask"].reshape(b * s))
                segments_count = s
            elif "batched_segments" in batch:
                seg = batch["batched_segments"]
                b, s, f = seg.shape
                audio_embeds, frame_mask = model.encode_audio(
                    params, seg.reshape(b * s, f).float(),
                    batch["segments_waveforms_mask"].reshape(b * s, f),
                    batch["segments_boarders_attention_mask"].reshape(b * s))
                segments_count = s
            else:
                audio_embeds, frame_mask = model.encode_audio(
                    params, batch["waveforms"].float(), batch["waveforms_attention_mask"])
                segments_count = None
            return model.prepare_audio_inputs(
                params, audio_embeds=audio_embeds, frame_mask=frame_mask,
                input_ids=batch["prefix_input_ids"], attention_mask=batch["prefix_attention_mask"],
                segments_count=segments_count)

    def _generation_params(self):
        """(the parameters as the forward uses them, the whole LM's): decoding
        runs the whole LM on this rank's rows, so under a mesh it is
        gathered."""
        params = self._use(self.state.params, grad=False)
        if self.mesh is None:
            return params, params["lm_decoder"]
        return params, self.mesh.full_params(self.state.params["lm_decoder"],
                                             self.specs["lm_decoder"])

    def generate_for_batch(self, batch, max_new_tokens: Optional[int] = None,
                           fetch: bool = True, weights=None):
        """Generation with the reference's eval settings unless
        ``generation_config`` overrides them: beam 3, repetition penalty 2.5,
        no-repeat-4-gram, early stopping, pad = forced eos = eos (the
        tokenizer's, else 2), ``max_new_tokens`` the caption length rounded
        up to 16. Returns numpy ids, or the device tensor unless ``fetch``.
        ``weights`` is :meth:`_generation_params`' pair, made once by a
        caller that generates for many batches."""
        from aat_tpu_torch.training.generate import GenerationConfig, generate

        params, lm_params = weights or self._generation_params()
        inputs = self._prefix_inputs(params, self._to_device(batch))
        if max_new_tokens is None:
            max_new_tokens = int(-(-batch["input_ids"].shape[1] // 16) * 16)
        base = self.generation_config
        eos = self.tokenizer.eos_token_id if self.tokenizer is not None else 2
        gcfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            num_beams=base.num_beams if base else 3,
            repetition_penalty=base.repetition_penalty if base else 2.5,
            no_repeat_ngram_size=base.no_repeat_ngram_size if base else 4,
            eos_token_id=eos, pad_token_id=eos,
            early_stopping=base.early_stopping if base else True,
            forced_eos_token_id=eos)
        out = generate(lm_params, self.model.lm_config, inputs["inputs_embeds"],
                       inputs["attention_mask"], gcfg)
        return out.cpu().numpy() if fetch else out

    def evaluate(self, eval_batches: Iterable[dict],
                 with_generation: Optional[bool] = None) -> Dict[str, float]:
        """``eval/loss`` (the mean of the batches' losses) and, with
        generation (by default when ``compute_metrics`` is set), the
        metrics of the generated ids against the captions (taken from the
        batches as given). The losses and ids come to the host after the
        loop, with one sync. Under a mesh each rank passes its rows of the
        global batches and gets the global batches' loss and metrics (ids
        and captions gathered in data-rank order)."""
        if with_generation is None:
            with_generation = self.compute_metrics is not None
        losses, generated, references, prefixes = [], [], [], []
        weights = self._generation_params() if with_generation else None
        params = weights[0] if weights else self._use(self.state.params, grad=False)
        for batch in eval_batches:
            db = self._to_device(batch)
            losses.append(self._eval_loss(params, db))
            if with_generation:
                generated.append(self._data_rows(
                    self.generate_for_batch(db, fetch=False, weights=weights)))
                references.append(_host(self._data_rows(db["input_ids"])))
                prefixes.append(_host(self._data_rows(db["prefix_input_ids"])))
        metrics = {"eval/loss": float("nan")}
        if not losses:
            return metrics
        # one sync for the pass: both copies queue on the stream, then wait
        losses = torch.stack(losses).to("cpu", non_blocking=True)
        if generated:
            width = max(g.shape[1] for g in generated)
            generated = torch.cat([F.pad(g, (0, width - g.shape[1])) for g in generated]).to(
                "cpu", non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        metrics["eval/loss"] = float(np.mean(losses.tolist()))
        if self.compute_metrics is not None and references:
            def pad_cat(arrays, pad=0):
                width = max(a.shape[1] for a in arrays)
                return np.concatenate([
                    np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=pad)
                    for a in arrays])

            metrics.update(self.compute_metrics(
                generated_ids=generated.numpy(), inputs_ids=pad_cat(references),
                prefix_ids=pad_cat(prefixes)))
        return metrics

    def _data_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` in data-rank order, dim 1 padded
        with zeros to the widest (one device: ``x``)."""
        if self.mesh is None:
            return x
        group = self.mesh.group("dp", "fsdp")
        width = int(comm.all_reduce(torch.tensor(x.shape[1], device=x.device), group,
                                    dist.ReduceOp.MAX))
        return comm.gather_from_group(F.pad(x, (0, width - x.shape[1])), group, 0)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def _writer(self) -> bool:
        """Whether this process writes files (rank 0 under a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self):
        if self.mesh is not None:
            dist.barrier()

    def _state_specs(self, state):
        """The Spec tree of a params-shaped tree or an optimizer state:
        the params' specs, Adafactor's factored statistics without the dim
        they reduce."""
        if isinstance(state, optim_lib.FactoredState):
            def reduced(i):
                return optim_lib.tree_map(
                    lambda path, spec: (optim_lib.drop_dim(spec, self._factor_axes[path][i])
                                        if path in self._factor_axes else spec),
                    optim_lib.tree_paths(self.specs), self.specs)

            return optim_lib.FactoredState(None, reduced(1), reduced(0), self.specs)
        if optim_lib._is_namedtuple(state):
            return type(state)(*(self._state_specs(field) for field in state))
        return self.specs if isinstance(state, dict) else None

    def _full_state(self, state):
        """A params-shaped tree, or an optimizer state of such trees, with
        every sharded leaf gathered whole (one device: as it is)."""
        if self.mesh is None:
            return state

        def gather(x, specs):
            if optim_lib._is_namedtuple(x):
                return type(x)(*(gather(field, s) for field, s in zip(x, specs)))
            return self.mesh.full_params(x, specs) if isinstance(x, dict) else x

        return gather(state, self._state_specs(state))

    def _local_flat(self, flat: dict, template) -> dict:
        """A checkpoint's flat full tensors cut to this rank's shards, by the
        specs of ``template`` (the params, or an optimizer state)."""
        if self.mesh is None:
            return flat
        specs = ckpt_lib.flatten(self._state_specs(template))
        return {k: self.mesh.local_shard(v, specs[k]).clone(memory_format=torch.contiguous_format)
                if k in specs else v for k, v in flat.items()}

    def _ckpt_dir(self, step: Optional[int] = None) -> str:
        step = self.state.step if step is None else step
        return os.path.join(self.config.output_dir, f"checkpoint-{step}")

    def save_checkpoint(self, path: Optional[str] = None,
                        metric: Optional[float] = None) -> str:
        """Full-fidelity checkpoint: params, optimizer state and step (the
        schedule is a function of the step), and ``trainer_meta.json`` with
        the freeze flags and, when given, the eval ``metric``."""
        path = os.path.abspath(path or self._ckpt_dir())
        params, opt_state = self._full_state(self.state.params), self._full_state(
            self.state.opt_state)
        if self._writer():
            ckpt_lib.write_params(path, self.state.step, params)
            ckpt_lib.write_optimizer(path, opt_state)
            meta = {"step": self.state.step, "train_lm_decoder": self.config.train_lm_decoder,
                    "train_audio_encoder": self.config.train_audio_encoder}
            if metric is not None:
                meta[self.config.metric_for_best_model] = metric
            ckpt_lib.write_json(path, ckpt_lib.META_FILE, meta)
            self._prune_checkpoints()
            logger.info("saved checkpoint %s", path)
        self._barrier()
        return path

    def save_pretrained(self, path: str) -> str:
        """Export filtered by the train flags, as the reference's
        ``save_pretrained``: the adapter always, the audio encoder and the
        LM decoder only when trained; ``config.json`` describes the model
        (:func:`~aat_tpu_torch.models.build.model_config_dict`)."""
        from aat_tpu_torch.models.build import model_config_dict

        params = self._full_state(self.state.params)
        keep = {"adapter": params["adapter"]}
        if self.config.train_audio_encoder:
            keep["audio_encoder"] = params["audio_encoder"]
        if self.config.train_lm_decoder:
            keep["lm_decoder"] = params["lm_decoder"]
        # the interchange layout: a one-process consumer reads a pp run's export
        keep = {k: pipeline.unstack_model_layers(v) for k, v in keep.items()}
        path = os.path.abspath(path)
        if self._writer():
            ckpt_lib.write_params(path, self.state.step, keep)
            ckpt_lib.write_json(path, "config.json",
                                model_config_dict(self.model, self.config, sorted(keep)))
            logger.info("saved filtered model (%s) to %s", sorted(keep), path)
        self._barrier()
        return path

    def _prune_checkpoints(self):
        """``save_total_limit``: keep the newest checkpoints; the best is
        never pruned (``load_best_model_at_end`` needs it)."""
        limit, base = self.config.save_total_limit, self.config.output_dir
        if not limit or not os.path.isdir(base):
            return
        protected = os.path.basename(self._best_checkpoint) if self._best_checkpoint else None
        ckpts = sorted((d for d in os.listdir(base)
                        if d.startswith("checkpoint-") and d != protected),
                       key=lambda d: int(d.split("-")[-1]))
        for stale in ckpts[:-limit]:
            shutil.rmtree(os.path.join(base, stale), ignore_errors=True)

    def restore_checkpoint(self, path: str, partial: bool = True,
                           restore_opt_state: bool = True):
        """Restore params, optimizer state and step, by the first route that
        fits: the exact one (every param and moment of this trainer's
        trees); params only (the optimizer state re-initialised, with a
        warning when it was asked for); an export with some subtrees
        (``partial``: the missing ones kept from this trainer's build, the
        reference's ``_keys_to_ignore_on_load_missing``; else raises). The
        saved layers are first stacked or unstacked to this trainer's layout
        (a pp checkpoint in a one-process trainer, or the reverse), where
        the moments no longer fit and are re-initialised."""
        path = os.path.abspath(path)
        saved = ckpt_lib.read_params(path, self.device)
        flat = self._local_flat(pipeline.flat_to_layout(saved["params"], self.state.params),
                                self.state.params)
        opt_state = None
        try:
            params = ckpt_lib.unflatten_like(self.state.params, flat)
            if restore_opt_state:
                opt_state = self._read_opt_state(path)
        except (KeyError, ValueError):
            params = None
        if params is None:
            params = self._merge_saved_subtrees(path, flat, partial)
        if restore_opt_state and opt_state is None:
            logger.warning("checkpoint %s: optimizer state not restorable; re-initializing "
                           "(Adam moments reset)", path)
        self.state = TrainState(int(saved["step"]), params,
                                opt_state if opt_state is not None else self.tx.init(params))
        logger.info("restored checkpoint %s at step %d", path, self.state.step)

    def _read_opt_state(self, path: str):
        """The saved optimizer state in this trainer's state tree, or None
        where the file is missing or its leaves are not this optimizer's
        (another optimizer, or other trainable leaves)."""
        flat = ckpt_lib.read_optimizer(path, self.device)
        template = self.state.opt_state
        if flat is None or set(flat) != set(ckpt_lib.flatten(template)):
            return None
        return ckpt_lib.unflatten_like(template, self._local_flat(flat, template))

    def _merge_saved_subtrees(self, path: str, flat: dict, partial: bool) -> dict:
        """The saved top-level subtrees merged into this trainer's params."""
        saved_keys = {k.split(".", 1)[0] for k in flat}
        unknown = saved_keys - set(self.state.params)
        if unknown:
            raise ValueError(f"checkpoint {path} has unknown param subtree(s) {sorted(unknown)}")
        missing = set(self.state.params) - saved_keys
        if missing:
            if not partial:
                raise ValueError(f"checkpoint {path} lacks {sorted(missing)} and partial "
                                 "restore is disabled")
            logger.info("partial restore: %s kept from the fresh build "
                        "(_keys_to_ignore_on_load_missing semantics)", sorted(missing))
        merged = dict(self.state.params)
        for key in saved_keys:
            merged[key] = ckpt_lib.unflatten_like(self.state.params[key], flat, f"{key}.")
        return merged


def _host(x) -> np.ndarray:
    """A batch field as numpy (a tensor on the card copied once)."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


read_checkpoint_meta = ckpt_lib.read_checkpoint_meta


class EarlyStopping:
    """Stop after ``patience`` evals without ``threshold`` improvement of
    ``metric`` (the reference builds HF's EarlyStoppingCallback with these
    semantics and leaves it commented out)."""

    def __init__(self, patience: int, threshold: float = 0.01, metric: str = "eval/loss"):
        self.patience = patience
        self.threshold = threshold
        self.metric = metric
        self.best = float("inf")
        self.strikes = 0

    def should_stop(self, metrics: Dict[str, float]) -> bool:
        value = metrics.get(self.metric)
        if value is None:
            return False
        if value < self.best - self.threshold:
            self.best = value
            self.strikes = 0
        else:
            self.strikes += 1
        return self.strikes >= self.patience


class AATTrainerSegmentation(AATTrainer):
    """Name parity with the reference's segmented trainer; the segmented
    path is dispatched on batch keys in :meth:`AATTrainer._assemble_and_forward`."""
