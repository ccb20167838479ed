"""Rank functions and fixtures for the port's multi-device tests
(``tests/test_torch_parallel_*.py``). The ranks run in fresh processes
(``aat_tpu_torch.parallel.distributed.launch``) over gloo on the CPU; this
module imports no JAX, so neither do they. Every rank pins its torch
threads, since a test starts up to 8 ranks on shared cores."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.models.aslm import AslmConfig, AslmModel
from aat_tpu_torch.parallel.distributed import initialize
from aat_tpu_torch.parallel.pipeline import stack_model_layers, unstack_model_layers
from aat_tpu_torch.training import checkpoint as ckpt_lib
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.trainer import AATTrainer

RANK_THREADS = 1
TIMEOUT = 240  # seconds a launch may take


def start_rank(rank: int, world_size: int, port: int) -> torch.device:
    torch.set_num_threads(RANK_THREADS)
    return initialize(rank, world_size, f"tcp://localhost:{port}", device="cpu")


def tiny_model(dropout: float = 0.0, seed: int = 0, lm=None, layers: int = 2,
               layerdrop: float = 0.0, tied: bool = False):
    """JAX's ``tests/test_multichip.py::_tiny_trainer`` model, in the port;
    ``layers`` encoder and LM layers, the encoder's LayerDrop at
    ``layerdrop``, the LM's head ``tied`` to its embeddings or not."""
    config = AslmConfig(projection_type="linear", audio_encoder_hidden=32, lm_hidden=32,
                        projection_hidden=48)
    audio_cfg = dataclasses.replace(thub.tiny_test_config(), hidden_dropout=dropout,
                                    attention_dropout=dropout, num_hidden_layers=layers,
                                    layerdrop=layerdrop)
    lm = lm or tllm.tiny_test_config()
    lm = dataclasses.replace(lm, num_hidden_layers=layers,
                             tie_word_embeddings=lm.tie_word_embeddings or tied)
    model = AslmModel(config, audio_cfg, lm)
    return model, model.init_params(seed, device="cpu")


def tiny_config(mesh=None, output_dir: str = "/nonexistent", **kw) -> TrainingConfig:
    """JAX's ``_tiny_trainer`` settings on ``mesh`` ({axis: size}), with
    ``kw`` overriding them."""
    mesh = mesh or {}
    fields = dict(
        learning_rate=1e-3, warmup_steps=2, max_steps=10, gradient_accumulation_steps=1,
        train_audio_encoder=True, train_lm_decoder=True, compute_dtype="float32",
        mesh_dp=mesh.get("dp", 1), mesh_fsdp=mesh.get("fsdp", 1), mesh_tp=mesh.get("tp", 1),
        mesh_sp=mesh.get("sp", 1), mesh_pp=mesh.get("pp", 1), eval_steps=0, save_steps=0, logging_steps=1000,
        output_dir=output_dir)
    return TrainingConfig(**{**fields, **kw})


def _captions(rng, rows: int, ragged: bool):
    ids = rng.integers(1, 100, (rows, 6))
    mask = np.ones((rows, 6), np.int32)
    if ragged:
        # the data ranks' rows pad their captions differently: the global
        # token count, not a mean of per-rank means, normalizes the loss
        for r in range(rows):
            mask[r, 2 + (r * 3) % 5:] = 0
    return ids, mask


def equiv_batch(rows: int = 8, ragged: bool = False) -> dict:
    """JAX's ``_equiv_batch``: segmented, 2 segments of 400 samples a row."""
    rng = np.random.default_rng(7)
    seg = rng.normal(0, 0.3, (rows, 2, 400)).astype(np.float32)
    ids, mask = _captions(rng, rows, ragged)
    return {"batched_segments": seg, "segments_waveforms_mask": np.ones((rows, 2, 400), np.int32),
            "segments_boarders_attention_mask": np.ones((rows, 2), np.int32),
            "input_ids": ids, "attention_mask": mask, "input_ids_attention_mask": mask,
            "prefix_input_ids": ids[:, :2], "prefix_attention_mask": np.ones((rows, 2), np.int64)}


def whole_utterance_batch(rows: int = 8, ragged: bool = False) -> dict:
    """JAX's ``_whole_utterance_batch``: one 400-sample waveform a row (the
    tiny encoder's T = 19 pads to a multiple of sp)."""
    rng = np.random.default_rng(9)
    wave = rng.normal(0, 0.3, (rows, 400)).astype(np.float32)
    ids, mask = _captions(rng, rows, ragged)
    return {"waveforms": wave, "waveforms_attention_mask": np.ones((rows, 400), np.int32),
            "input_ids": ids, "attention_mask": mask, "input_ids_attention_mask": mask,
            "prefix_input_ids": ids[:, :2], "prefix_attention_mask": np.ones((rows, 2), np.int64)}


BATCHES = {"segmented": equiv_batch, "whole": whole_utterance_batch}


def flat_numpy(tree) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in ckpt_lib.flatten(tree).items()}


def interchange(params: dict) -> dict:
    """A params tree with its stacked layers (a pp trainer's) unstacked."""
    return {k: unstack_model_layers(v) for k, v in params.items()}


def run_steps(trainer: AATTrainer, batch: dict, steps: int = 2):
    """(losses, the full params as numpy, in the per-layer layout) after
    ``steps`` steps on the rank's rows of ``batch``."""
    local = trainer.mesh.local_batch(batch) if trainer.mesh is not None else batch
    losses = [trainer.training_step([local])["train/loss"] for _ in range(steps)]
    return losses, flat_numpy(interchange(trainer._full_state(trainer.state.params)))


def train_rank(rank, world_size, port, mesh, batch_name, dropout=0.0, ragged=False,
               steps=2, fault=None, config_kw=None, model_kw=None):
    """One rank of a mesh trainer: ``steps`` steps on its rows of the global
    batch → (losses, the full params). ``fault`` plants a defect the
    equivalence bounds must see: ``"no_reduce"`` (rank 1 takes part in the
    gradient reduction but keeps its own gradients),
    ``"unshifted_dropout"`` (every rank keys its masks as rows 0.., as if it
    held the batch's first rows), ``"pipeline_exit_sum"`` (the pipeline's
    result leaves through an all-reduce whose gradient is summed too) or
    ``"pipeline_entry_identity"`` (its input enters without the sum of the
    stages' gradients)."""
    start_rank(rank, world_size, port)
    model, params = tiny_model(dropout, **(model_kw or {}))
    trainer = AATTrainer(model, params, tiny_config(mesh, **(config_kw or {})))
    if fault == "pipeline_exit_sum":
        from aat_tpu_torch.parallel import comm, pipeline

        pipeline._exit = comm.all_reduce_sum
    if fault == "pipeline_entry_identity":
        from aat_tpu_torch.parallel import pipeline

        pipeline._enter = lambda x, group: x
    if fault == "no_reduce" and rank == 1:
        reduce = trainer._reduce_grads
        trainer._reduce_grads = lambda grads: (reduce(grads), grads)[1]
    if fault == "unshifted_dropout":
        from aat_tpu_torch.ops.dropout import ElementShard

        trainer.mesh.element_shard = lambda time=None: ElementShard(0, time)
    return run_steps(trainer, BATCHES[batch_name](ragged=ragged), steps)


def reference_run(batch_name, dropout=0.0, ragged=False, steps=2, config_kw=None,
                  model_kw=None, stacked=False):
    """The one-process trainer on the global batch; with ``stacked``, on its
    parameters with the encoder's and the LM's layers stacked (the tree a
    pp trainer's optimizer sees: Adafactor factors the stacked leaves)."""
    model, params = tiny_model(dropout, **(model_kw or {}))
    trainer = AATTrainer(model, params, tiny_config(**(config_kw or {})))
    if stacked:
        stack_trainer(trainer)
    return run_steps(trainer, BATCHES[batch_name](ragged=ragged), steps)


def stack_trainer(trainer: AATTrainer) -> None:
    """Stack a one-process trainer's encoder and LM layers in place, and
    rebuild its freeze mask, Adafactor axes and optimizer on that tree."""
    from aat_tpu_torch.training import optim
    from aat_tpu_torch.training.trainer import TrainState
    from aat_tpu_torch.utils import port

    params = {k: stack_model_layers(v) if k != "adapter" else v
              for k, v in trainer.state.params.items()}
    cfg = trainer.config
    trainer.freeze = optim.trainable_mask(params, train_audio_encoder=cfg.train_audio_encoder,
                                          train_lm_decoder=cfg.train_lm_decoder)
    trainer._factor_axes = {
        path: optim.factored_dims(p.shape)
        for path, p in zip(optim.tree_leaves(optim.tree_paths(params)),
                           optim.tree_leaves(params)) if p.ndim >= 2}
    trainer._factor_axes.update(port.adafactor_axes(params))
    trainer.tx = trainer._build_tx(params)
    trainer.state = TrainState(0, params, trainer.tx.init(params))


def grad_norms(trainer: AATTrainer, batch: dict) -> list:
    """The global norm of the gradient tree and the step's two grad-norm
    metrics, for the rank's rows of ``batch``."""
    local = trainer.mesh.local_batch(batch) if trainer.mesh is not None else batch
    grads, metrics, _ = trainer._grad_step(trainer.state.params, trainer._to_device(local),
                                           trainer.dropout_seed(0, 0))
    return [float(trainer._norm(grads)), float(metrics["train/audio_tokens_emb_grad"]),
            float(metrics["train/audio_encdoer_grad_norm"])]


def guard_rank(rank, world_size, port, mesh):
    """The gradient norms of a step (the sharded tree's, each replicated
    leaf once), then a step whose batch is non-finite on rank 1's rows
    only, which every rank must drop (the guard reads the global norm) →
    (the norms, the skipped count, whether every parameter kept its
    value)."""
    start_rank(rank, world_size, port)
    model, params = tiny_model()
    trainer = AATTrainer(model, params, tiny_config(mesh))
    norms = grad_norms(trainer, equiv_batch(ragged=True))
    before = flat_numpy(trainer.state.params)
    batch = equiv_batch()
    batch["batched_segments"][5, 0, 7] = np.nan  # a row of data rank 1
    metrics = trainer.training_step([trainer.mesh.local_batch(batch)])
    after = flat_numpy(trainer.state.params)
    return (norms, metrics["train/skipped_nonfinite_total"],
            all(np.array_equal(before[k], after[k]) for k in before))


def max_param_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def worst_diffs(ref, ranks) -> tuple:
    """(max loss |Δ|, max param |Δ|) of every rank's run against ``ref``."""
    return (max(abs(a - b) for losses, _ in ranks for a, b in zip(ref[0], losses)),
            max(max_param_diff(ref[1], params) for _, params in ranks))


def _gather_numpy(trainer: AATTrainer, x: torch.Tensor) -> np.ndarray:
    return trainer._data_rows(x).cpu().numpy()


def ulysses_rank(rank, world_size, port, q, k, v, key_mask, sm_scale):
    """Ulysses attention on a dp2 × sp2 mesh: this rank's batch rows and
    time slice of the global operands (T padded to a multiple of sp, as
    the encoder pads it) → (data rank, sp index, its output slice)."""
    from aat_tpu_torch.parallel import mesh as mesh_lib
    from aat_tpu_torch.parallel import sequence

    start_rank(rank, world_size, port)
    mesh = mesh_lib.make_mesh(dp=2, sp=2)
    q, k, v, key_mask = (mesh.local_rows(torch.as_tensor(x)) for x in (q, k, v, key_mask))
    q, k, v, key_mask = (sequence.shard_time(x, mesh) for x in (q, k, v, key_mask))
    out = sequence.ulysses_attention_bthd(q, k, v, key_mask, mesh, sm_scale=sm_scale,
                                          use_kernel=False)
    return mesh.data_rank, mesh.index("sp"), out.numpy()


def layout_rank(rank, world_size, port, sizes):
    """(coords, the ranks of each axis' group, data rank / world)."""
    import torch.distributed as dist

    from aat_tpu_torch.parallel import mesh as mesh_lib

    start_rank(rank, world_size, port)
    mesh = mesh_lib.make_mesh(**sizes)
    groups = {}
    for axes in (("dp",), ("fsdp",), ("tp",), ("sp",), ("dp", "fsdp")):
        group = mesh.group(*axes)
        groups[axes] = (None if group is None
                        else sorted(dist.get_process_group_ranks(group)))
    return mesh.coords, groups, (mesh.data_rank, mesh.data_world)


def _item_collate(items):
    """A deterministic segmented batch, row i a function of item id i (the
    JAX package's ``tests/_mp_common.collate``)."""
    rows = [int(i) for i in items]
    ids = np.stack([np.random.default_rng(200 + i).integers(1, 50, (6,)) for i in rows])
    seg = np.stack([np.random.default_rng(100 + i).normal(0, 0.3, (2, 400)).astype(np.float32)
                    for i in rows])
    n = len(rows)
    return {"batched_segments": seg, "segments_waveforms_mask": np.ones((n, 2, 400), np.int32),
            "segments_boarders_attention_mask": np.ones((n, 2), np.int32), "input_ids": ids,
            "attention_mask": np.ones((n, 6), np.int32),
            "input_ids_attention_mask": np.ones((n, 6), np.int32),
            "prefix_input_ids": ids[:, :2], "prefix_attention_mask": np.ones((n, 2), np.int64)}


def shard_order_rank(rank, world_size, port, mesh):
    """Under ``mesh``: each rank's dataloader shard of items 0-3 (the
    default shards of the trainer's mesh), the global batch the trainer
    assembles, and the refusal of default shards without a mesh."""
    from aat_tpu_torch.data.dataloaders import build_dataloaders

    start_rank(rank, world_size, port)
    model, params = tiny_model()
    trainer = AATTrainer(model, params, tiny_config(mesh))
    _, val = build_dataloaders(list(range(4)), list(range(4)), _item_collate, batch_size=2,
                               mesh=trainer.mesh)
    (local,) = list(val)
    try:
        build_dataloaders(list(range(4)), list(range(4)), _item_collate, batch_size=2)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return (local["input_ids"], _gather_numpy(trainer, torch.as_tensor(local["input_ids"])),
            refused)


class IdTokenizer:
    """Ids as words (the JAX package's ``tests/_mp_common`` tokenizer)."""

    eos_token_id = 2
    bos_token_id = 1

    def batch_decode(self, ids_batch, skip_special_tokens=True):
        return [" ".join(str(int(i)) for i in ids if int(i) > 2) for ids in ids_batch]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def eval_trainer(mesh=None):
    from aat_tpu_torch.training.generate import GenerationConfig
    from aat_tpu_torch.training.metrics import ComputeMetrics

    model, params = tiny_model()
    return AATTrainer(model, params, tiny_config(mesh),
                      compute_metrics=ComputeMetrics(IdTokenizer()), tokenizer=IdTokenizer(),
                      generation_config=GenerationConfig(num_beams=1))


def evaluate_run(trainer: AATTrainer, batches):
    """One training step, then ``evaluate`` with generation, and the
    generated ids of each batch (all data ranks' rows; under pp through
    the whole LM, gathered)."""
    local = [trainer.mesh.local_batch(b) if trainer.mesh is not None else b for b in batches]
    trainer.training_step([local[0]])
    metrics = trainer.evaluate(local, with_generation=True)
    ids = [trainer._data_rows(trainer.generate_for_batch(b, fetch=False)).cpu().numpy()
           for b in local]
    return metrics, ids


def evaluate_rank(rank, world_size, port, mesh, ragged):
    start_rank(rank, world_size, port)
    batches = [equiv_batch(ragged=ragged), whole_utterance_batch(ragged=ragged)]
    return evaluate_run(eval_trainer(mesh), batches)


def checkpoint_rank(rank, world_size, port, mesh, root):
    """Under ``mesh``: 2 steps and a save; a fresh trainer restores it and
    takes 2 more; an uninterrupted run takes 4. → (the saved path, both
    4-step states as full numpy params and moments)."""
    import os

    start_rank(rank, world_size, port)
    batch = equiv_batch(ragged=True)

    def trainer():
        model, params = tiny_model(dropout=0.1)
        t = AATTrainer(model, params, tiny_config(mesh, output_dir=os.path.join(root, "run")))
        return t, t.mesh.local_batch(batch)

    def state(t):
        return {**flat_numpy(t._full_state(t.state.params)),
                **{f"opt.{k}": v for k, v in flat_numpy(t._full_state(t.state.opt_state)).items()}}

    a, local = trainer()
    for _ in range(2):
        a.training_step([local])
    path = a.save_checkpoint()
    saved_state = state(a)
    b, _ = trainer()
    b.restore_checkpoint(path)
    for t in (a, b):
        for _ in range(2):
            t.training_step([local])
    return path, saved_state, state(a), state(b)


def bn_rank(rank, world_size, port, images):
    """EfficientNet-b0's train-mode features and batch statistics on this
    data rank's rows of ``images`` under a dp mesh."""
    from aat_tpu_torch.models import efficientnet as eff
    from aat_tpu_torch.parallel import mesh as mesh_lib

    start_rank(rank, world_size, port)
    mesh = mesh_lib.make_mesh(dp=world_size)
    params = eff.init_efficientnet_params(0, device="cpu")
    x = mesh.local_rows(torch.as_tensor(images)).requires_grad_(True)
    feats, stats = eff.EfficientNetAudioEncoderAdapter()(params, x, train=True, mesh=mesh)
    (feats.square().sum() * 1e-3).backward()
    return (feats.detach().numpy(), x.grad.numpy(),
            {k: v.numpy() for k, v in ckpt_lib.flatten(stats).items()})


def reuse_rank(rank, world_size, port, mesh=None):
    """A trainer on ``mesh`` (dp2 by default), then a one-device trainer
    built from the same model: the model's mesh (and pipeline microbatch
    count) is cleared and its step runs the plain route (no collective). A
    mesh larger than the world raises."""
    from aat_tpu_torch.parallel import comm

    start_rank(rank, world_size, port)
    model, params = tiny_model()
    mesh_trainer = AATTrainer(model, params, tiny_config(mesh or {"dp": 2},
                                                         pp_microbatches=2))
    mesh_trainer.training_step([mesh_trainer.mesh.local_batch(equiv_batch())])
    routed = model.mesh
    _, fresh = tiny_model()
    single = AATTrainer(model, fresh, tiny_config())
    cleared = model.mesh is None and model.pp_microbatches == 0
    before = sum(comm.calls.values())
    loss = single.training_step([equiv_batch(rows=2)])["train/loss"]
    collectives = sum(comm.calls.values()) - before
    try:
        AATTrainer(model, fresh, tiny_config({"dp": 4}))
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return routed is mesh_trainer.mesh, cleared, loss, collectives, refused


WORDS = [f"w{i}" for i in range(12)]


class WordTokenizer:
    """A word-level tokenizer with its whole vocabulary fixed up front (every
    rank gives a word the same id): the HF tokenizer calls the collators
    and metrics make."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        from aat_tpu_torch.data.collate import PREFIXES

        words = ["<pad>", "<s>", "</s>"] + WORDS + " ".join(PREFIXES).split()
        self.vocab = {w: i for i, w in enumerate(dict.fromkeys(words))}
        self.words = {i: w for w, i in self.vocab.items()}

    def decode(self, ids):
        return "".join(self.words.get(int(i), "?") for i in ids)

    def batch_decode(self, ids_batch, skip_special_tokens=True):
        out = []
        for ids in ids_batch:
            words = [self.words.get(int(i), "") for i in ids]
            if skip_special_tokens:
                words = [w for w in words if w not in ("<s>", "</s>", "<pad>", "")]
            out.append(" ".join(words))
        return out

    def __call__(self, texts, padding=True):
        seqs = [[self.vocab[w] for w in t.replace("<s>", " <s> ").replace("</s>", " </s> ").split()]
                for t in texts]
        ids = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
        mask = np.zeros_like(ids)
        for i, s in enumerate(seqs):
            ids[i, :len(s)], mask[i, :len(s)] = s, 1
        return {"input_ids": ids, "attention_mask": mask}


class Dataset(list):
    """A HF dataset stand-in: ``select``, ``shuffle(seed)``, ``len``."""

    def select(self, indices):
        return Dataset(self[int(i)] for i in indices)

    def shuffle(self, seed):
        return self.select(np.random.default_rng(seed).permutation(len(self)))


def speech_items(tag: str, n: int, seed: int) -> Dataset:
    rng = np.random.default_rng(seed)
    out = Dataset()
    for i in range(n):
        seconds = float(rng.uniform(0.4, 0.6))
        starts = np.linspace(0, seconds * 0.9, 4)
        wave = rng.normal(0, 0.3, int(seconds * 16000)) * np.hanning(int(seconds * 16000))
        out.append({"id": f"{tag}{i}", "words": list(rng.choice(WORDS, 4)),
                    "word_start": starts.tolist(), "word_end": (starts + 0.05).tolist(),
                    "audio": {"array": wave, "sampling_rate": 16000}})
    return out


class RecordingCollator:
    """A collator that records the ids of the items it collates."""

    def __init__(self, inner):
        self.inner, self.rng, self.seen = inner, inner.rng, []

    def __call__(self, items):
        self.seen.extend(item["id"] for item in items)
        return self.inner(items)


def cli_rank(rank, world_size, port, output_dirs):
    """The train command line as ``torchrun --nproc-per-node 2`` starts it
    (``RANK`` / ``WORLD_SIZE`` / ``MASTER_*``), with tiny models and the
    dataset and tokenizer seams replaced; each rank is given its own
    ``--output-dir``, so what rank 1 writes shows. → (the train and
    validation items this rank collated, the trainer's data shard)."""
    import os

    from aat_tpu_torch.scripts import train as ttrain

    torch.set_num_threads(RANK_THREADS)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port), WANDB_MODE="disabled")
    thub.hubert_large_config = thub.tiny_test_config
    tllm.smollm_135m_config = tllm.tiny_test_config
    data = {"train": speech_items("train", 8, 0), "valid": speech_items("valid", 4, 1)}
    ttrain.load_hf_dataset = lambda name, split=None: data[split]
    ttrain.build_tokenizer = lambda config: WordTokenizer()
    collators = []
    make_collator = ttrain.make_collator

    def recording(config, tokenizer):
        collate, cls = make_collator(config, tokenizer)
        collators.append(RecordingCollator(collate))
        return collators[-1], cls

    ttrain.make_collator = recording
    argv = ["--no-pretrained", "--per-device-train-batch-size", "2",
            "--gradient-accumulation-steps", "1", "--num-train-epochs", "1", "--max-steps", "1",
            "--eval-steps", "1", "--save-steps", "1", "--logging-steps", "1",
            "--no-load-best-model-at-end", "--compute-dtype", "float32", "--mesh-dp", "2",
            "--output-dir", output_dirs[rank]]
    trainer = ttrain.main(argv, device="cpu")
    return (collators[0].seen, collators[1].seen,
            (trainer.mesh.data_rank, trainer.mesh.data_world), trainer.state.step)


def record_dropout(mesh=None) -> dict:
    """One training step of the tiny model with every encoder dropout at
    0.2 (LayerDrop off) on 2 whole utterances, ``mesh`` ({axis: size}) or
    one process, recording the masks the encoder draws: ``"attention"``,
    a (seed, B, H, T) per attention call, and ``"dropout"``, a (seed, shape,
    keep mask) per dropout call, in call order."""
    from aat_tpu_torch.ops import dropout as dropout_lib
    from aat_tpu_torch.parallel import sequence

    rates = dict(hidden_dropout=0.2, attention_dropout=0.2, activation_dropout=0.2,
                 feature_projection_dropout=0.2)
    audio_cfg = dataclasses.replace(thub.tiny_test_config(), **rates)
    model = AslmModel(AslmConfig(projection_type="linear", audio_encoder_hidden=32,
                                 lm_hidden=32, projection_hidden=48),
                      audio_cfg, tllm.tiny_test_config())
    trainer = AATTrainer(model, model.init_params(0, device="cpu"), tiny_config(mesh))
    seen = {"attention": [], "dropout": []}

    def attention(q, k, v, key_mask, **kw):
        if kw.get("dropout_seed") is not None:
            seen["attention"].append((kw["dropout_seed"], q.shape[0], q.shape[2], q.shape[1]))
        return attention_plain(q, k, v, key_mask, **kw)

    def dropout(seed, x, rate, shard=None):
        if seed is not None and rate > 0.0:
            keep = dropout_lib.dropout(seed, torch.ones_like(x), rate, shard) != 0
            seen["dropout"].append((seed, tuple(x.shape), keep.numpy()))
        return dropout_lib.dropout(seed, x, rate, shard)

    attention_plain = thub.attention_bthd
    thub.attention_bthd = sequence.attention_bthd = attention
    thub.dropout = dropout
    try:
        batch = whole_utterance_batch(rows=2)
        trainer.training_step([trainer.mesh.local_batch(batch) if trainer.mesh else batch])
    finally:
        thub.attention_bthd = sequence.attention_bthd = attention_plain
        thub.dropout = dropout_lib.dropout
    return seen


def dropout_record_rank(rank, world_size, port, mesh):
    start_rank(rank, world_size, port)
    return record_dropout(mesh)


def toy_pipeline_problem(rows: int, layers: int, width: int = 8, seed: int = 11):
    """Seeded numpy operands of a toy layer stack: stacked weights and
    biases, an input batch, an upstream scale, a row mask and the loss
    weights."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.4, (layers, width, width)).astype(np.float32),
            "b": rng.normal(0, 0.1, (layers, width)).astype(np.float32),
            "x": rng.normal(0, 1.0, (rows, 3, width)).astype(np.float32),
            "scale": np.float32(1.5),
            "mask": (rng.uniform(size=(rows, 3)) > 0.2).astype(np.float32),
            "c": rng.normal(0, 1.0, (rows, 3, width)).astype(np.float32)}


def toy_layer(h, layer, idx, shard, mask):
    """One toy layer: a product, a bias, tanh, the row mask and the global
    layer index (so a stage that ran another stage's index shows)."""
    return torch.tanh(h @ layer["w"] + layer["b"]) * mask[..., None] + 0.01 * idx


def toy_pipeline(problem: dict, mesh=None, microbatches: int = 0, stage_layers=None,
                 layer_fn=toy_layer):
    """The toy stack on this rank's rows through ``gpipe_apply`` under
    ``mesh``, or on all rows as a plain loop without one → (output, loss,
    grads of the stage's stacked leaves, of the upstream scale and of the
    input), as numpy; the loss is this rank's rows' share."""
    from aat_tpu_torch.parallel import pipeline

    layers = problem["w"].shape[0]
    rows = (lambda x: mesh.local_rows(x)) if mesh is not None else (lambda x: x)
    sl = stage_layers or slice(0, layers)
    stacked = {k: torch.tensor(problem[k][sl], requires_grad=True) for k in ("w", "b")}
    scale = torch.tensor(problem["scale"], requires_grad=True)
    x = torch.tensor(rows(problem["x"]), requires_grad=True)
    mask = torch.tensor(rows(problem["mask"]))
    if mesh is None:
        y = x * scale
        for i in range(layers):
            y = layer_fn(y, {k: v[i] for k, v in stacked.items()}, i, None, mask)
    else:
        y = pipeline.gpipe_apply(layer_fn, stacked, x * scale, (mask,), mesh, num_layers=layers,
                                 microbatches=microbatches)
    loss = (y * torch.tensor(rows(problem["c"]))).square().sum()
    loss.backward()
    return (y.detach().numpy(), float(loss.detach()), {k: v.grad.numpy() for k, v in stacked.items()},
            float(scale.grad), x.grad.numpy())


def gpipe_rank(rank, world_size, port, sizes, rows, layers, microbatches, fault=None):
    """The toy stack pipelined on ``sizes`` → (pp coordinate, data rank,
    :func:`toy_pipeline`'s results, the microbatch count, the ring steps
    and bytes each way, the microbatches' ElementShard rows)."""
    from aat_tpu_torch.parallel import comm, pipeline
    from aat_tpu_torch.parallel import mesh as mesh_lib

    start_rank(rank, world_size, port)
    mesh = mesh_lib.make_mesh(**sizes)
    if fault == "pipeline_exit_sum":
        pipeline._exit = comm.all_reduce_sum
    if fault == "pipeline_entry_identity":
        pipeline._enter = lambda x, group: x
    per = layers // mesh.size("pp")
    s = mesh.coords["pp"]
    blocks = set()

    def recording(h, lp, idx, shard, mask):
        blocks.add(shard.row_block)
        return toy_layer(h, lp, idx, shard, mask)

    comm.calls.clear()
    comm.ring_bytes.clear()
    out = toy_pipeline(toy_pipeline_problem(rows, layers), mesh, microbatches,
                       slice(s * per, (s + 1) * per), recording)
    ring = {k: v for k, v in comm.calls.items() if k.startswith("ring_permute")}
    used = pipeline.microbatch_count(microbatches or 2 * mesh.size("pp"), rows // mesh.data_world)
    return s, mesh.data_rank, out, used, ring, dict(comm.ring_bytes), sorted(blocks)


def ring_rank(rank, world_size, port):
    """``ring_permute`` of a rank-tagged tensor and its gradient: → (what
    arrived, the gradient of ``sum(arrived · w_rank)`` with respect to what
    this rank sent)."""
    from aat_tpu_torch.parallel import comm

    start_rank(rank, world_size, port)
    import torch.distributed as dist

    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = comm.ring_permute(x, dist.group.WORLD)
    (y * torch.arange(3.0) * (10 * rank + 1)).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def residency_rank(rank, world_size, port, mesh, optimizer):
    """A pp trainer's stage-resident state → ({stack: layers of this
    rank's params, mu or v_row leaves}, the full params' layer counts)."""
    start_rank(rank, world_size, port)
    kw = {"optimizer": "adafactor", "learning_rate": None} if optimizer == "adafactor" else {}
    model, params = tiny_model(layers=4)
    trainer = AATTrainer(model, params, tiny_config(mesh, **kw))
    trainer.training_step([trainer.mesh.local_batch(equiv_batch())])
    state = trainer.state.opt_state
    inner = getattr(state, "inner_state", state)
    moments = inner.mu if hasattr(inner, "mu") else inner.v_row
    out = {}
    for stack in ("audio_encoder", "lm_decoder"):
        leaves = ckpt_lib.flatten(trainer.state.params[stack]["layers"])
        stats = ckpt_lib.flatten(moments[stack]["layers"])
        out[stack] = (sorted({int(v.shape[0]) for v in leaves.values()}),
                      sorted({int(v.shape[0]) for v in stats.values()}))
    full = trainer._full_state(trainer.state.params)
    return out, {k: sorted({int(v.shape[0]) for v in ckpt_lib.flatten(full[k]["layers"]).values()})
                 for k in ("audio_encoder", "lm_decoder")}


def adafactor_rank(rank, world_size, port, sizes, params, specs, grads, learning_rates):
    """The port's Adafactor on this rank's shards of whole leaves
    (``params``: {name: array}, ``specs``: {name: dims}), ``len(grads)``
    steps of whole gradients, for each of ``learning_rates`` → [{name:
    this rank's shard after them}]."""
    from aat_tpu_torch.parallel import mesh as mesh_lib
    from aat_tpu_torch.training import optim

    start_rank(rank, world_size, port)
    mesh = mesh_lib.make_mesh(**sizes)
    spec = {k: mesh_lib.Spec(tuple(v)) for k, v in specs.items()}
    axes = {k: optim.factored_dims(np.shape(v)) for k, v in params.items() if np.ndim(v) >= 2}
    out = []
    for learning_rate in learning_rates:
        local = {k: mesh.local_shard(torch.as_tensor(v), spec[k]).clone()
                 for k, v in params.items()}
        tx = optim.adafactor(learning_rate, axes=axes, mesh=mesh, specs=spec)
        state = tx.init(local)
        for step in grads:
            g = {k: mesh.local_shard(torch.as_tensor(v), spec[k]) for k, v in step.items()}
            updates, state = tx.update(g, state, local)
            optim.apply_updates(local, updates)
        out.append({k: v.numpy() for k, v in local.items()})
    return out


def restore_rank(rank, world_size, port, mesh, path, export=None):
    """A trainer on ``mesh`` restores the checkpoint at ``path`` → (its step,
    its full params and optimizer state as flat numpy, in its layout, and
    the keys of its ``save_pretrained`` export at ``export``, if given)."""
    start_rank(rank, world_size, port)
    model, params = tiny_model(seed=5)
    trainer = AATTrainer(model, params, tiny_config(mesh))
    trainer.restore_checkpoint(path)
    keys = None
    if export is not None:
        trainer.save_pretrained(export)
        keys = sorted(ckpt_lib.read_params(export, "cpu")["params"])
    return (trainer.state.step, flat_numpy(trainer._full_state(trainer.state.params)),
            flat_numpy(trainer._full_state(trainer.state.opt_state)), keys)
