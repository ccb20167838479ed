"""The port's checkpoints (``AATTrainer.save_checkpoint`` /
``restore_checkpoint`` / ``save_pretrained`` / ``finalize``, the files of
``training/checkpoint.py``) at tiny widths, mirroring
``tests/test_training.py`` (:220, :408, :450, :511, :549, :606) and
``tests/test_resume_epochs.py`` (:69, over a plain list of batches and a
small epoch loop), plus a JAX orbax checkpoint converted by
``utils/port.checkpoint_from_jax`` and resumed in the port."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from aat_tpu.models import build as jbuild
from aat_tpu.training.config import TrainingConfig as JConfig
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.training import checkpoint as ckpt
from aat_tpu_torch.training.config import TrainingConfig as TConfig
from aat_tpu_torch.training.optim import tree_leaves
from aat_tpu_torch.training.trainer import AATTrainer as TTrainer
from aat_tpu_torch.training.trainer import read_checkpoint_meta
from aat_tpu_torch.utils.port import to_jax_params
from tests._torch_trajectories import (TRAIN, assert_trajectories, jax_checkpoint, port_model,
                                       resumed_losses, whole_batch)
from tests._torch_threads import two_threads  # noqa: F401

DROPOUT = dict(hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
               feature_projection_dropout=0.1, layerdrop=0.1)


def make_trainer(tmp_path, name="run", dropout=False, seed=0, **train_kw):
    """A port trainer on the tiny model with JAX's seeded weights."""
    tm, params = port_model(seed, **(DROPOUT if dropout else {}))
    kw = dict(TRAIN, gradient_accumulation_steps=1, output_dir=str(tmp_path / name))
    kw.update(train_kw)
    return TTrainer(tm, params, TConfig(**kw))


def batches(seed, n):
    rng = np.random.default_rng(seed)
    return [whole_batch(rng) for _ in range(n)]


def state_of(t):
    """Every tensor of a trainer's state by name, and the step."""
    s = t.state
    out = {f"params.{k}": v for k, v in ckpt.flatten(s.params).items()}
    out.update({f"mu.{k}": v for k, v in ckpt.flatten(s.opt_state.mu).items()})
    out.update({f"nu.{k}": v for k, v in ckpt.flatten(s.opt_state.nu).items()})
    out.update(count=s.opt_state.count, total_notfinite=s.opt_state.total_notfinite)
    return out, s.step


def assert_states_equal(a, b):
    (sa, step_a), (sb, step_b) = state_of(a), state_of(b)
    assert step_a == step_b and set(sa) == set(sb)
    for name, x in sa.items():
        assert x.dtype == sb[name].dtype and torch.equal(x, sb[name]), name


def test_checkpoint_roundtrip(tmp_path):
    t = make_trainer(tmp_path)
    for b in batches(0, 2):
        t.training_step([b], fetch_metrics=False)
    path = t.save_checkpoint(str(tmp_path / "ckpt-1"))
    assert sorted(os.listdir(path)) == ["optimizer.pt", "params.pt", "trainer_meta.json"]
    assert read_checkpoint_meta(path) == {"step": 2, "train_lm_decoder": False,
                                          "train_audio_encoder": True}
    # one flat dotted-path map of the optimizer state
    opt = torch.load(os.path.join(path, "optimizer.pt"), weights_only=True)
    trainable = {k for k, v in ckpt.flatten(t.freeze).items() if v}
    assert not any(k.startswith(("mu.lm_decoder", "nu.lm_decoder")) for k in opt)  # frozen
    assert set(opt) == ({"count", "total_notfinite"} | {f"mu.{k}" for k in trainable}
                        | {f"nu.{k}" for k in trainable})

    before = {k: v.clone() for k, v in ckpt.flatten(t.state.params["adapter"]).items()}
    for x in ckpt.flatten(t.state.params["adapter"]).values():
        x.add_(1.0)
    t.restore_checkpoint(path)
    for k, v in ckpt.flatten(t.state.params["adapter"]).items():
        assert torch.equal(v, before[k]), k
    assert t.state.step == 2

    # a fresh trainer (other weights) restores the same state, bit for bit,
    # into tensors of its own
    fresh = make_trainer(tmp_path, "fresh", seed=5)
    fresh.restore_checkpoint(path)
    assert_states_equal(fresh, t)
    ptrs = {x.data_ptr() for x in state_of(t)[0].values()}
    assert not ptrs & {x.data_ptr() for x in state_of(fresh)[0].values()}


def test_resume_is_bitwise_identical_with_dropout(tmp_path):
    """Six steps uninterrupted equal three steps, a checkpoint, a restore in
    a fresh trainer and three more, bit for bit, with dropout and LayerDrop
    0.1 on: the seeds derive from the restored step."""
    data = batches(100, 6)
    a = make_trainer(tmp_path, "a", dropout=True)
    for b in data:
        a.training_step([b], fetch_metrics=False)
    b_run = make_trainer(tmp_path, "b", dropout=True)
    for b in data[:3]:
        b_run.training_step([b], fetch_metrics=False)
    path = b_run.save_checkpoint()
    assert path.endswith("checkpoint-3")
    c = make_trainer(tmp_path, "c", dropout=True, seed=9)
    c.restore_checkpoint(path)
    assert c.state.step == 3
    for b in data[3:]:
        c.training_step([b], fetch_metrics=False)
    assert_states_equal(c, a)
    # the dropout masks acted: a dropout-off run ends elsewhere
    off = make_trainer(tmp_path, "off")
    for b in data:
        off.training_step([b], fetch_metrics=False)
    assert not torch.equal(off.state.params["adapter"]["projection"]["in"]["kernel"],
                           a.state.params["adapter"]["projection"]["in"]["kernel"])


def test_partial_adapter_checkpoint_restore(tmp_path, caplog):
    """An adapter-only checkpoint restores against the fresh encoder and
    decoder (the reference's _keys_to_ignore_on_load_missing), the
    optimizer state re-initialised; ``partial=False`` refuses it; a
    checkpoint without its optimizer file restores the params only, with a
    warning."""
    t = make_trainer(tmp_path)
    adapter = {k: v + 0.5 for k, v in ckpt.flatten(t.state.params["adapter"]).items()}
    path = str(tmp_path / "adapter-ckpt")
    os.makedirs(path)
    torch.save({"step": 7, "params": {f"adapter.{k}": v for k, v in adapter.items()}},
               os.path.join(path, "params.pt"))
    encoder = t.state.params["audio_encoder"]["feature_projection"]["projection"]["kernel"].clone()
    with pytest.raises(ValueError, match="lacks"):
        t.restore_checkpoint(path, partial=False)
    t.restore_checkpoint(path, partial=True)
    for k, v in ckpt.flatten(t.state.params["adapter"]).items():
        assert torch.equal(v, adapter[k]), k
    assert torch.equal(t.state.params["audio_encoder"]["feature_projection"]["projection"]
                       ["kernel"], encoder)
    assert t.state.step == 7 and int(t.state.opt_state.count) == 0

    for b in batches(1, 2):
        t.training_step([b], fetch_metrics=False)
    full = t.save_checkpoint()
    os.remove(os.path.join(full, "optimizer.pt"))
    params = {k: v.clone() for k, v in ckpt.flatten(t.state.params).items()}
    fresh = make_trainer(tmp_path, "fresh", seed=3)
    with caplog.at_level(logging.WARNING):
        fresh.restore_checkpoint(full)
    assert "optimizer state not restorable" in caplog.text
    for k, v in ckpt.flatten(fresh.state.params).items():
        assert torch.equal(v, params[k]), k
    assert fresh.state.step == 9 and int(fresh.state.opt_state.count) == 0

    torch.save({"step": 1, "params": {"projector.w": torch.zeros(2)}},
               os.path.join(path, "params.pt"))
    with pytest.raises(ValueError, match="unknown param subtree"):
        t.restore_checkpoint(path)


def tiny_build(monkeypatch):
    """``build_model`` with hubert-large and SmolLM swapped for the tiny
    test configs (the JAX package's too, for its config dict)."""
    from aat_tpu.models import hubert as jhub
    from aat_tpu.models import llama as jllm

    monkeypatch.setattr(thub, "hubert_large_config", thub.tiny_test_config)
    monkeypatch.setattr(tllm, "smollm_135m_config", tllm.tiny_test_config)
    monkeypatch.setattr(jhub, "hubert_large_config", jhub.tiny_test_config)
    monkeypatch.setattr(jllm, "smollm_135m_config", jllm.tiny_test_config)


def test_save_pretrained_filters_frozen_submodules(tmp_path, monkeypatch):
    """``save_pretrained`` omits the frozen LM; its ``config.json`` has the
    keys of JAX's ``model_config_dict`` and the same values on the fields
    both packages carry; a fresh trainer restoring it keeps its own LM; and
    ``build_model(from_pretrained_adapter=...)`` gives the adapter back bit
    for bit (an adapter of other shapes raises)."""
    tiny_build(monkeypatch)
    cfg = TConfig(**dict(TRAIN, gradient_accumulation_steps=1, output_dir=str(tmp_path)))
    model, params = tbuild.build_model(cfg, pretrained=False, seed=4, device="cpu")
    t = TTrainer(model, params, cfg)
    t.training_step([whole_batch(np.random.default_rng(2))], fetch_metrics=False)
    path = t.save_pretrained(str(tmp_path / "export"))
    saved = ckpt.read_params(path, "cpu")
    assert {k.split(".")[0] for k in saved["params"]} == {"adapter", "audio_encoder"}
    assert saved["step"] == 1

    with open(os.path.join(path, "config.json")) as f:
        desc = json.load(f)
    jmodel, _ = jbuild.build_model(JConfig(**dict(TRAIN, gradient_accumulation_steps=1)),
                                   pretrained=False, seed=4)
    want = json.loads(json.dumps(jbuild.model_config_dict(
        jmodel, JConfig(), ["adapter", "audio_encoder"])))
    assert set(desc) == set(want)
    assert desc["aslm"] == want["aslm"]  # pooling and dropout too, in both directions
    for key, value in desc.items():
        if isinstance(value, dict):
            for field, v in value.items():
                assert want[key][field] == v, (key, field)
        else:
            assert want[key] == value, key

    _, other = tbuild.build_model(cfg, pretrained=False, seed=6, device="cpu")
    t2 = TTrainer(model, other, cfg)
    lm = {k: v.clone() for k, v in ckpt.flatten(t2.state.params["lm_decoder"]).items()}
    t2.restore_checkpoint(path)
    for k, v in ckpt.flatten(t2.state.params["lm_decoder"]).items():
        assert torch.equal(v, lm[k]), k
    for name in ("adapter", "audio_encoder"):
        for k, v in ckpt.flatten(t2.state.params[name]).items():
            assert torch.equal(v, ckpt.flatten(t.state.params[name])[k]), k

    _, rebuilt = tbuild.build_model(cfg, pretrained=False, seed=8,
                                    from_pretrained_adapter=path, device="cpu")
    for k, v in ckpt.flatten(t.state.params["adapter"]).items():
        assert torch.equal(ckpt.flatten(rebuilt["adapter"])[k], v), k
    small = make_trainer(tmp_path, "small").save_pretrained(str(tmp_path / "small-export"))
    with pytest.raises(ValueError, match="saved shape"):
        tbuild.build_model(cfg, pretrained=False, from_pretrained_adapter=small, device="cpu")


@pytest.mark.parametrize("run", ["efficient_net", "transformer_encoder"])
def test_export_of_the_new_paths_loads_back(tmp_path, monkeypatch, run):
    """An EfficientNet run's export (``build_model``) and a pooling run's
    (tiny ``PoolingConfig``): ``config.json`` equals JAX's
    ``model_config_dict`` of the same model (an EfficientNet ``AslmModel``
    built with ``audio_encoder_type="efficient_net"``), and
    ``load_pretrained`` gives back the encoder type, the configs and the
    saved params bit for bit."""
    from aat_tpu.models import aslm as jaslm
    from aat_tpu.models import efficientnet as jeff
    from aat_tpu.models import hubert as jhub
    from aat_tpu.models import llama as jllm
    from aat_tpu_torch.models import aslm as taslm
    from aat_tpu_torch.models import efficientnet as teff

    tiny_build(monkeypatch)
    kw = dict(TRAIN, gradient_accumulation_steps=1, output_dir=str(tmp_path))
    if run == "efficient_net":
        cfg = TConfig(**kw, audio_encoder_type="efficient_net")
        model, params = tbuild.build_model(cfg, pretrained=False, seed=4, device="cpu")
        jmodel = jaslm.AslmModel(
            jaslm.AslmConfig(audio_encoder_hidden=1280, lm_hidden=32),
            jeff.EfficientNetConfig(), jllm.tiny_test_config(),
            audio_encoder_type="efficient_net")
        jcfg = JConfig(**kw, audio_encoder_type="efficient_net")
    else:
        pool = dict(hidden_dim=16, num_heads=2, num_layers=1, ffn_dim=24, max_positions=32)
        model = taslm.AslmModel(
            taslm.AslmConfig(projection_type="transformer_encoder", audio_encoder_hidden=32,
                             lm_hidden=32, pooling=taslm.PoolingConfig(**pool)),
            thub.tiny_test_config(), tllm.tiny_test_config())
        params = model.init_params(4)
        jmodel = jaslm.AslmModel(
            jaslm.AslmConfig(projection_type="transformer_encoder", audio_encoder_hidden=32,
                             lm_hidden=32, pooling=jaslm.PoolingConfig(**pool)),
            jhub.tiny_test_config(), jllm.tiny_test_config())
        cfg, jcfg = TConfig(**kw), JConfig(**kw)
    t = TTrainer(model, params, cfg)
    path = t.save_pretrained(str(tmp_path / "export"))
    with open(os.path.join(path, "config.json")) as f:
        desc = json.load(f)
    want = json.loads(json.dumps(jbuild.model_config_dict(
        jmodel, jcfg, ["adapter", "audio_encoder"])))
    assert set(desc) == set(want)
    for key in ("aslm", "audio_encoder_type", "saved_subtrees", "audio_encoder_checkpoint"):
        assert desc[key] == want[key], key
    if run == "efficient_net":
        assert desc["audio_encoder_config"] == want["audio_encoder_config"]
    for field, v in desc["lm_config"].items():
        assert want["lm_config"][field] == v, field

    loaded, got = tbuild.load_pretrained(path, device="cpu")
    assert loaded.audio_encoder_type == ("efficient_net" if run == "efficient_net" else "hubert")
    assert isinstance(loaded.audio_encoder_config,
                      teff.EfficientNetConfig if run == "efficient_net" else thub.HubertConfig)
    assert isinstance(loaded.config.pooling, taslm.PoolingConfig)
    assert loaded.config == model.config
    for name in ("adapter", "audio_encoder"):
        for k, v in ckpt.flatten(params[name]).items():
            assert torch.equal(ckpt.flatten(got[name])[k], v), k


def test_jax_build_model_records_hubert_for_an_efficientnet_run(monkeypatch):
    """The reference's defect, as it is: JAX's ``build_model`` builds the
    ``AslmModel`` without ``audio_encoder_type``, so an EfficientNet run's
    ``model_config_dict`` says ``"hubert"`` beside an ``EfficientNetConfig``
    (and JAX's ``load_pretrained`` would then build a HubertConfig from
    it). The port's ``build_model`` records ``"efficient_net"``."""
    from aat_tpu.models import efficientnet as jeff

    tiny_build(monkeypatch)
    kw = dict(TRAIN, audio_encoder_type="efficient_net")
    jmodel, _ = jbuild.build_model(JConfig(**kw), pretrained=False, seed=0)
    assert isinstance(jmodel.audio_encoder_config, jeff.EfficientNetConfig)
    assert jmodel.audio_encoder_type == "hubert"
    assert jbuild.model_config_dict(jmodel, JConfig(**kw), ["adapter"])[
        "audio_encoder_type"] == "hubert"
    tmodel, _ = tbuild.build_model(TConfig(**kw), pretrained=False, seed=0, device="cpu")
    assert tmodel.audio_encoder_type == "efficient_net"
    assert tbuild.model_config_dict(tmodel, TConfig(**kw), ["adapter"])[
        "audio_encoder_type"] == "efficient_net"


def test_load_best_model_at_end(tmp_path):
    """``finalize`` reloads the best checkpoint's weights, which
    ``save_total_limit=1`` never prunes; the step and the optimizer state
    stay."""
    t = make_trainer(tmp_path, save_total_limit=1)
    data = batches(25, 2)
    t.training_step([data[0]], fetch_metrics=False)
    best_path = t.save_checkpoint(metric=0.5)
    t._track_best(best_path, 0.5)
    best = t.state.params["adapter"]["projection"]["out"]["kernel"].clone()
    t.training_step([data[1]], fetch_metrics=False)
    worse_path = t.save_checkpoint(metric=0.9)
    t._track_best(worse_path, 0.9)
    assert t._best_checkpoint == best_path and os.path.isdir(best_path)
    mu = {k: v.clone() for k, v in ckpt.flatten(t.state.opt_state.mu).items()}
    t.finalize()
    assert torch.equal(t.state.params["adapter"]["projection"]["out"]["kernel"], best)
    assert t.state.step == 2 and int(t.state.opt_state.count) == 2
    for k, v in ckpt.flatten(t.state.opt_state.mu).items():
        assert torch.equal(v, mu[k]), k


def test_prune_checkpoints_keeps_the_best(tmp_path):
    t = make_trainer(tmp_path, save_total_limit=2)
    for i, b in enumerate(batches(3, 4)):
        t.training_step([b], fetch_metrics=False)
        path = t.save_checkpoint(metric=[0.1, 0.5, 0.4, 0.3][i])
        t._track_best(path, [0.1, 0.5, 0.4, 0.3][i])
    assert sorted(os.listdir(tmp_path / "run")) == ["checkpoint-1", "checkpoint-3", "checkpoint-4"]


def test_resume_fast_forward_position(tmp_path):
    """5 batches at accumulation 2 make 2 steps an epoch (the trailing
    partial group is dropped); a resume at step 2, one whole epoch, skips
    no microbatch of the new epoch."""
    t = make_trainer(tmp_path, gradient_accumulation_steps=2, max_steps=2)
    data = batches(200, 5)
    t.train(data)
    assert t.state.step == 2
    path = t.save_checkpoint(str(tmp_path / "run" / "ckpt"))
    t2 = make_trainer(tmp_path, "resumed", seed=31, gradient_accumulation_steps=2, max_steps=4)
    consumed = []
    real_step = t2.training_step

    def recording_step(micro, fetch_metrics=True):
        consumed.append([id(m) for m in micro])
        return real_step(micro, fetch_metrics=fetch_metrics)

    t2.training_step = recording_step
    t2.train(data, resume_from_checkpoint=path)
    assert consumed == [[id(data[0]), id(data[1])], [id(data[2]), id(data[3])]]
    assert t2.state.step == 4


class SimulatedKill(Exception):
    """Raised mid-run to stand for a dying process (the schedule's
    max_steps stays the same in the killed and uninterrupted runs)."""


def epoch_batches(epoch):
    """One epoch of 4 batches of 2 items, shuffled by the epoch number;
    each batch is a function of its item ids and carries them."""
    perm = np.random.default_rng(7 + epoch).permutation(8)
    out = []
    for i in range(0, 8, 2):
        ids = np.sort(perm[i : i + 2])
        b = whole_batch(np.random.default_rng(ids))
        b["item_ids"] = ids
        out.append(b)
    return out


def run_epochs(trainer, n_epochs, consumed, start_epoch=0, fast_forward=False,
               kill_at_step=None):
    """The training command's epoch loop in miniature, recording the item
    ids each step consumed."""
    real_step = trainer.training_step

    def recording_step(micro, **kw):
        consumed.extend(tuple(int(i) for i in mb["item_ids"]) for mb in micro)
        out = real_step(micro, **kw)
        if kill_at_step is not None and trainer.state.step >= kill_at_step:
            raise SimulatedKill()
        return out

    trainer.training_step = recording_step
    for epoch in range(start_epoch, n_epochs):
        trainer.train(epoch_batches(epoch), fast_forward=fast_forward and epoch == start_epoch)
    return consumed


def test_resume_mid_epoch_consumes_exact_batches(tmp_path):
    """A run killed during step 7 (epoch 2 of 3) resumes from checkpoint-6:
    it skips epoch 1, fast-forwards 2 steps into epoch 2, consumes exactly
    the batches of the uninterrupted run and ends on its parameters."""
    a = make_trainer(tmp_path, "a", dropout=True, max_steps=200)
    consumed_a = run_epochs(a, 3, [])
    assert len(consumed_a) == 12 and consumed_a[0:4] != consumed_a[4:8]
    b = make_trainer(tmp_path, "b", dropout=True, max_steps=200, save_steps=2,
                     save_total_limit=0)
    consumed_b = []
    with pytest.raises(SimulatedKill):
        run_epochs(b, 3, consumed_b, kill_at_step=7)
    assert consumed_b == consumed_a[:7]
    path = str(tmp_path / "b" / "checkpoint-6")
    meta = read_checkpoint_meta(path)
    assert meta["step"] == 6 and meta["train_lm_decoder"] is False
    c = make_trainer(tmp_path, "c", dropout=True, seed=2, max_steps=200)
    c.restore_checkpoint(path)
    start_epoch = c.state.step // 4
    assert start_epoch == 1
    consumed_c = run_epochs(c, 3, [], start_epoch=start_epoch, fast_forward=True)
    assert consumed_c == consumed_a[6:] and c.state.step == 12
    assert_states_equal(c, a)


def assert_adamw_state_equals(t, state):
    """Every param and AdamW moment leaf of the port trainer ``t``, in JAX's
    layout, equal to the orbax ``state``'s, by the same paths; MaskedNode
    and None (frozen leaves) both have no leaves."""
    opt, jopt = t.state.opt_state, state["opt_state"]
    for name, got, want in (("params", t.state.params, state["params"]),
                            ("mu", opt.mu, jopt.mu), ("nu", opt.nu, jopt.nu)):
        flat_got = jax.tree_util.tree_flatten_with_path(to_jax_params(got))[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert ([jax.tree_util.keystr(p) for p, _ in flat_got]
                == [jax.tree_util.keystr(p) for p, _ in flat_want]), name
        for (path, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{name}{jax.tree_util.keystr(path)}")


def test_jax_checkpoint_converts_and_resumes(tmp_path):
    """A JAX trainer's orbax checkpoint after 3 steps, restored to numpy and
    converted by ``checkpoint_from_jax``, restores in the port exactly (the
    conv kernels and their moments in the port's layout, no moments on the
    frozen LM), and 3 more steps in each package agree within the training
    tests' tolerance. Dropout is off: the packages derive their seeds
    differently."""
    ref, ppath = jax_checkpoint(whole_batch, tmp_path, seed=300)
    state = ref.saved
    assert read_checkpoint_meta(ppath)["step"] == 3

    t = make_trainer(tmp_path, "port", seed=4)
    t.restore_checkpoint(ppath)
    opt, jopt = t.state.opt_state, state["opt_state"]
    assert t.state.step == 3 and int(opt.count) == int(jopt.count) == 3
    assert float(opt.total_notfinite) == float(jopt.total_notfinite)
    assert_adamw_state_equals(t, state)
    assert all(x is None for m in (opt.mu, opt.nu) for x in tree_leaves(m["lm_decoder"]))

    losses = resumed_losses(ref, t, whole_batch, 300)
    assert t.state.step == ref.step == 6
    # 3 steps at lr ~1e-4 move each element by ~2e-4, so the bounds sit far
    # below one update: read 4.8e-7 on the losses, 1.6e-8 on the params
    for step, (lj, lt) in enumerate(losses):
        assert abs(lj - lt) <= 1e-6, (step, lj, lt)
    assert_trajectories([], ref.params[-1], to_jax_params(t.state.params), 1e-7)
