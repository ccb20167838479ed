"""``AATTrainerSegmentation`` against the JAX package's over 3 steps on
EfficientNet-b0 melspec batches ``[2, 2, 64, 26]`` at gradient accumulation
2 (JAX ``test_trainer_step_updates_bn_running_stats``), f32, with the
encoder frozen and trained: each microbatch's BN statistics fold into the
running estimates after the update, as JAX's do (helpers in
``tests/test_torch_training_projections.py``)."""

import jax
import numpy as np
import pytest
import torch

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import efficientnet as jeff
from aat_tpu.models import llama as jllm
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import efficientnet as teff
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.lr_schedule import warmup_linear_schedule
from aat_tpu_torch.training.trainer import AATTrainerSegmentation as TTrainer
from aat_tpu_torch.utils.port import from_jax_params, to_jax_params
from tests.test_torch_training_projections import (  # noqa: F401
    TOL, TRAIN, melspec_batch, run, two_threads,
)


def first_step_grads(tm, jp, cfg, batches):
    """The port's gradient of a step's first microbatches, averaged, in the
    JAX layout (numpy; None on frozen leaves)."""
    tt = TTrainer(tm, from_jax_params(jax.tree.map(np.array, jp)), TConfig(**cfg))
    grads = [tt._grad_step(tt.state.params, tt._to_device(b), 0)[0] for b in batches]
    mean = jax.tree.map(lambda *g: sum(g) / len(g), *grads)
    return to_jax_params(mean)


@pytest.mark.parametrize("train_encoder", [False, True])
def test_efficientnet_melspec_trajectory_and_bn_fold_match_jax(train_encoder):
    """Losses within 1e-6 relative at every step. AdamW's first step is
    sign-like per element (``g / (|g| + 1e-8)``), so a coordinate whose
    gradient is near 0 can round to the other sign in the other package and
    move by a whole step: the smallest of the projection's 40,960 gradients
    are about 1e-8 of its largest, and a BN bias followed by a train-mode BN
    has a gradient that is 0 but for rounding. So after the first step the
    parameters are held to 1e-6 where that step's gradient carries signal
    (not below 1e-3 of its leaf's largest unless 0, in a leaf whose largest
    is at least 1e-6 of the tree's: over 90% of the coordinates), and the
    rest to two steps; after the third, where the first steps' flips have
    moved the later gradients of a trained encoder, every parameter to two
    steps a step (1e-6 where the encoder is frozen, on the same
    coordinates). Frozen leaves stay bit for bit. The BN running statistics
    are held to 1e-5: each fold adds 0.01 of a batch statistic, which
    inherits the forward's tolerance (``tests/test_torch_efficientnet.py``);
    after the third step of a trained encoder, whose weights then differ
    by up to two steps, to 1e-4."""
    aslm = dict(projection_type="mean", audio_encoder_hidden=1280, lm_hidden=32)
    jm = jaslm.AslmModel(jaslm.AslmConfig(**aslm), jeff.EfficientNetConfig(),
                         jllm.tiny_test_config(), audio_encoder_type="efficient_net")
    tm = taslm.AslmModel(taslm.AslmConfig(**aslm), teff.EfficientNetConfig(),
                         tllm.tiny_test_config(), audio_encoder_type="efficient_net")
    jp = {"audio_encoder": jeff.init_efficientnet_params(2),
          "adapter": jaslm.init_aslm_params(1, jm.config),
          "lm_decoder": jllm.init_llama_params(3, jm.lm_config)}
    cfg = dict(TRAIN, audio_encoder_type="efficient_net", train_audio_encoder=train_encoder,
               train_lm_decoder=True)
    rng = np.random.default_rng(5)  # run()'s first step draws these two microbatches
    grads = first_step_grads(tm, jp, dict(cfg, gradient_accumulation_steps=2),
                             [melspec_batch(rng) for _ in range(2)])
    losses, jparams, tparams, first = run(jm, tm, jp, cfg, melspec_batch, accum=2, seed=5,
                                          record_first=True)
    for i, (lj, lt) in enumerate(losses):
        assert np.isfinite(lt) and abs(lj - lt) <= TOL * abs(lj), (i, lj, lt)
    schedule = warmup_linear_schedule(TRAIN["learning_rate"], TRAIN["warmup_steps"],
                                      TRAIN["max_steps"], TConfig().start_lr_from)
    lrs = [float(schedule(torch.tensor(i))) for i in range(3)]
    flat_g = jax.tree.leaves(grads, is_leaf=lambda x: x is None)
    tree_max = max(np.abs(g).max() for g in flat_g if g is not None)
    for (jstate, tstate), n_steps in ((first, 1), ((jparams, tparams), 3)):
        held = 0
        for (path, a), b, g in zip(jax.tree_util.tree_flatten_with_path(jstate)[0],
                                   jax.tree.leaves(tstate), flat_g):
            key, diff = jax.tree_util.keystr(path), np.abs(b - np.asarray(a))
            if key.endswith(("['mean']", "['var']")):
                assert diff.max() <= (1e-4 if train_encoder and n_steps > 1 else 1e-5), key
            elif g is None:  # frozen: bit for bit
                assert diff.max() == 0.0, key
            else:
                noise = ((np.abs(g) < 1e-3 * np.abs(g).max()) & (g != 0)
                         if np.abs(g).max() >= 1e-6 * tree_max else np.ones(g.shape, bool))
                if n_steps == 1 or not train_encoder:
                    assert diff[~noise].max(initial=0.0) <= TOL, (n_steps, key)
                assert diff.max() <= 2 * sum(lrs[:n_steps]), (n_steps, key)
                held += int((~noise).sum())
        assert held > 0.9 * sum(g.size for g in flat_g if g is not None)
    enc0, enc = jp["audio_encoder"], tparams["audio_encoder"]
    # two EMAs of momentum 0.01 a step: the running mean moved by more
    # than 0 and less than 0.1; scale and kernels only through the optimizer
    shift = np.abs(enc["stem"]["bn"]["mean"] - enc0["stem"]["bn"]["mean"]).max()
    assert 0 < shift < 0.1
    assert np.abs(enc["stem"]["bn"]["var"] - enc0["stem"]["bn"]["var"]).max() > 0
    scale_moved = not np.array_equal(enc["stem"]["bn"]["scale"], enc0["stem"]["bn"]["scale"])
    kernel_moved = not np.array_equal(enc["stem"]["conv"]["kernel"],
                                      enc0["stem"]["conv"]["kernel"])
    assert scale_moved == kernel_moved == train_encoder
