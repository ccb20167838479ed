"""ASLM trainer (counterpart of ``aat_tpu/training/trainer.py``) on one
device: audio encoding → projection → input assembly → caption
cross-entropy, gradient accumulation over microbatches, and the fused
guarded AdamW update, through the same entry points as the JAX package
(``AATTrainer(model, params, config).training_step(microbatches)`` and
``AATTrainer.train(batches)``).

Mixed precision as in JAX: the parameters are float32 masters; with
``compute_dtype="bfloat16"`` the forward runs on differentiable bf16
copies, so the gradients land on the masters in float32. Frozen subtrees
are detached (``_stop_grad_frozen``): no parameter gradient is formed for
them, while activation gradients still flow through them (through the
frozen LM to the audio embeddings, which runs the causal flash backward).

Train-mode dropout seeds derive from ``(config.seed, step, microbatch)``
alone (:func:`~aat_tpu_torch.ops.dropout.fold_seed`), so a resumed run
would draw the same masks. The JAX package gets this from ``fold_in``; its
bits cannot be reproduced here, so the two trainers' dropout masks differ
by construction (parity tests run with dropout off or with explicit seeds).

Not ported yet (ROADMAP Queue 1): evaluation and generation, checkpoints,
adafactor and the unfused optimizer chain, remat, EfficientNet melspec
batches, multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aat_tpu_torch.models.aslm import AslmModel
from aat_tpu_torch.ops.dropout import fold_seed
from aat_tpu_torch.training import optim as optim_lib
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.lr_schedule import warmup_linear_schedule

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def caption_cross_entropy(logits: torch.Tensor, input_ids: torch.Tensor,
                          input_ids_attention_mask: torch.Tensor) -> torch.Tensor:
    """Shifted caption CE over the trailing caption positions, pad-masked,
    in float32. Accepts full-sequence logits [B, T, V] or caption-presliced
    logits [B, C−1, V]."""
    caption_len = input_ids.shape[1]
    pred = logits if logits.shape[1] == caption_len - 1 else logits[:, -caption_len:-1, :]
    targets = input_ids[:, 1:].long()
    mask = input_ids_attention_mask[:, 1:].float()
    ce = F.cross_entropy(pred.float().reshape(-1, pred.shape[-1]), targets.reshape(-1),
                         reduction="none").reshape(targets.shape)
    return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


class AATTrainer:
    """Audio-adaptive-tokenizer trainer (whole-utterance, segmented and
    raw-waveform batches)."""

    def __init__(self, model: AslmModel, params: Any, config: TrainingConfig, mesh=None,
                 compute_metrics: Optional[Callable] = None,
                 log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
                 tokenizer=None, generation_config=None):
        if mesh is not None:
            raise NotImplementedError(
                "device meshes are not ported yet (ROADMAP Queue 1, multi-device)")
        if config.encoder_remat:
            raise NotImplementedError("remat is not ported yet (ROADMAP Queue 1, trainer pieces)")
        self.model = model
        self.config = config
        self.tokenizer = tokenizer
        self.generation_config = generation_config
        self.compute_metrics = compute_metrics
        self.log_fn = log_fn or (lambda metrics: logger.info("metrics %s", metrics))
        if config.learning_rate is None:
            raise NotImplementedError(
                "relative-step Adafactor is not ported yet (ROADMAP Queue 1, trainer pieces)")
        self.schedule = warmup_linear_schedule(config.learning_rate, config.warmup_steps,
                                               config.max_steps or 100000,
                                               config.start_lr_from)
        self.freeze = optim_lib.trainable_mask(
            params, train_audio_encoder=config.train_audio_encoder,
            train_lm_decoder=config.train_lm_decoder)
        self.tx = self._build_tx(params)
        self.device = optim_lib.tree_leaves(params)[0].device
        self.state = TrainState(0, params, self.tx.init(params))

    def _build_tx(self, params):
        cfg = self.config
        if cfg.optimizer == "adamw" and cfg.skip_nonfinite_updates:
            return optim_lib.fused_guarded_adamw(
                self.schedule, params, weight_decay=cfg.weight_decay,
                clip_norm=cfg.grad_clip_norm, freeze=self.freeze)
        if cfg.optimizer == "adamw":
            return optim_lib.adamw_grouped(self.schedule, params)
        if cfg.optimizer == "adafactor":
            return optim_lib.adafactor(self.schedule)
        raise ValueError(f"unknown optimizer {cfg.optimizer}")

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

    def _assemble_and_forward(self, params, batch, dropout_seed: Optional[int] = None):
        """→ (caption logits, assembled inputs)."""
        model = self.model
        compute_dtype = (torch.bfloat16 if self.config.compute_dtype == "bfloat16"
                         else torch.float32)
        params = self._cast_for_compute(self._stop_grad_frozen(params))
        s_enc = s_proj = None
        if dropout_seed is not None:
            s_enc, s_proj = fold_seed(dropout_seed, 0), fold_seed(dropout_seed, 1)
        if "raw_waveforms" in batch:
            batch = self._segment_on_device(batch)
        if "batched_segments_melspectrograms" in batch:
            raise NotImplementedError(
                "EfficientNet melspec batches are not ported yet (ROADMAP Queue 1, EfficientNet)")
        if "batched_segments" in batch:
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
        return logits, inputs

    def _debug_metrics(self, params, batch, inputs) -> Dict[str, torch.Tensor]:
        """The reference's compute_loss debug block, on the device."""
        with torch.no_grad():
            embeds = inputs["inputs_embeds"]
            am = inputs["audio_embeds_attention_mask"]
            audio_len = am.shape[-1]
            flat_audio = inputs["audio_embeds"].reshape(-1, embeds.shape[-1]).float()
            audio_m = am.reshape(-1).float()
            audio_norms = torch.linalg.norm(flat_audio, dim=-1)
            denom_a = torch.clamp_min(audio_m.sum(), 1.0)
            text_embeds = embeds[:, audio_len + 2:, :].float()
            text_m = batch["attention_mask"].float()
            text_norms = torch.linalg.norm(text_embeds, dim=-1)
            denom_t = torch.clamp_min(text_m.sum(), 1.0)
            emb = params["adapter"]["audio_tokens_embeddings"]["embedding"].float()
            return {
                "debug/seq_len": torch.full((), float(inputs["attention_mask"].shape[-1]),
                                            device=embeds.device),
                "debug/audio_embeddings_norm_mean": (audio_norms * audio_m).sum() / denom_a,
                "debug/audio_embeddings_mean": (flat_audio.mean(-1) * audio_m).sum() / denom_a,
                "debug/text_embeddings_norm_mean": (text_norms * text_m).sum() / denom_t,
                "debug/text_embeddings_mean": (text_embeds.mean(-1) * text_m).sum() / denom_t,
                "debug/audio_bos_mean": emb[0].mean(),
                "debug/audio_bos_norm": torch.linalg.norm(emb[0]),
                "debug/audio_eos_mean": emb[1].mean(),
                "debug/audio_eos_norm": torch.linalg.norm(emb[1]),
            }

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _grad_step(self, params, batch, dropout_seed: Optional[int]):
        """→ (grads, metrics): grads is the params tree with float32 tensors
        on trainable leaves (zeros where a skipped layer left none) and
        ``None`` on frozen ones."""
        leaves = optim_lib.tree_map(
            lambda p, t: p.detach().requires_grad_(True) if t else p.detach(),
            params, self.freeze)
        logits, inputs = self._assemble_and_forward(leaves, batch, dropout_seed)
        loss = caption_cross_entropy(logits, batch["input_ids"],
                                     batch["input_ids_attention_mask"])
        trainable = [x for x, t in zip(optim_lib.tree_leaves(leaves),
                                       optim_lib.tree_leaves(self.freeze)) if t]
        found = iter(torch.autograd.grad(loss, trainable, allow_unused=True))

        def grad_of(p, t):
            if not t:
                return None
            g = next(found)
            return torch.zeros_like(p) if g is None else g

        grads = optim_lib.tree_map(grad_of, params, self.freeze)
        metrics = self._debug_metrics(params, batch, inputs)
        metrics["train/loss"] = loss.detach()
        # reference training_step grad norms
        metrics["train/audio_tokens_emb_grad"] = optim_lib.global_norm(
            grads["adapter"]["audio_tokens_embeddings"])
        if self.config.train_audio_encoder and "feature_projection" in grads.get(
                "audio_encoder", {}):
            metrics["train/audio_encdoer_grad_norm"] = optim_lib.global_norm(
                grads["audio_encoder"]["feature_projection"]["projection"])
        return grads, metrics

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
        fused guarded AdamW update in place. Returns host metrics when
        ``fetch_metrics`` (one device sync)."""
        acc_grads = acc_metrics = None
        for idx, mb in enumerate(microbatches):
            grads, metrics = self._grad_step(self.state.params, self._to_device(mb),
                                             self.dropout_seed(self.state.step, idx))
            if acc_grads is None:
                acc_grads, acc_metrics = grads, metrics
            else:
                acc_grads = optim_lib.tree_map(
                    lambda a, g: None if a is None else a + g, acc_grads, grads)
                acc_metrics = {k: acc_metrics[k] + v for k, v in metrics.items()}
            del grads
        n = len(microbatches)
        if n > 1:
            acc_grads = optim_lib.tree_map(lambda g: None if g is None else g / n, acc_grads)
            acc_metrics = {k: v / n for k, v in acc_metrics.items()}
        with torch.no_grad():
            updates, opt_state = self.tx.update(acc_grads, self.state.opt_state,
                                                self.state.params)
            optim_lib.apply_updates(self.state.params, updates)
        self.state = TrainState(self.state.step + 1, self.state.params, opt_state)
        return self._finish_metrics(acc_metrics, fetch_metrics)

    def _finish_metrics(self, acc_metrics, fetch_metrics: bool) -> Dict[str, float]:
        if not fetch_metrics:
            return {}
        names = list(acc_metrics)
        values = torch.stack([acc_metrics[k].float() for k in names]
                             + [self.state.opt_state.total_notfinite.float()]).cpu().tolist()
        host = dict(zip(names, values))
        host["train/skipped_nonfinite_total"] = values[-1]
        if not np.isfinite(host["train/loss"]):
            logger.warning("non-finite loss %s at step %d (update dropped)",
                           host["train/loss"], self.state.step)
        return host

    def train(self, train_batches: Iterable[dict], eval_batches=None,
              resume_from_checkpoint: Optional[str] = None, fast_forward: bool = False):
        """Run one epoch over ``train_batches``: a step every
        ``gradient_accumulation_steps`` microbatches (a trailing partial
        group is dropped), metrics logged every ``logging_steps``, stop at
        ``max_steps``. Evaluation, checkpoints and resume are not ported
        yet (ROADMAP Queue 1): passing them raises, and so does a run that
        could reach a multiple of ``save_steps``, before its first step."""
        if eval_batches is not None or resume_from_checkpoint or fast_forward:
            raise NotImplementedError(
                "evaluation, checkpoints and resume are not ported yet (ROADMAP Queue 1)")
        cfg = self.config
        if cfg.save_steps:
            next_save = (self.state.step // cfg.save_steps + 1) * cfg.save_steps
        if cfg.save_steps and (cfg.max_steps is None or cfg.max_steps >= next_save):
            raise NotImplementedError(
                f"save_steps={cfg.save_steps} would write a checkpoint at step {next_save}, and "
                "checkpoints are not ported yet (ROADMAP Queue 1 item 1): set save_steps=0 or "
                f"max_steps below {next_save}")
        micro: List[dict] = []
        t_start = time.time()
        for batch in train_batches:
            micro.append(batch)
            if len(micro) < cfg.gradient_accumulation_steps:
                continue
            will_log = (self.state.step + 1) % cfg.logging_steps == 0
            metrics = self.training_step(micro, fetch_metrics=will_log)
            micro = []
            step = self.state.step
            if step % cfg.logging_steps == 0:
                metrics["train/step_time"] = (time.time() - t_start) / cfg.logging_steps
                metrics["train/lr"] = float(self.schedule(step))
                self.log_fn(metrics)
                t_start = time.time()
            if cfg.max_steps is not None and step >= cfg.max_steps:
                break
        return self.state


class AATTrainerSegmentation(AATTrainer):
    """Name parity with the reference's segmented trainer; the segmented
    path is dispatched on batch keys in :meth:`AATTrainer._assemble_and_forward`."""
