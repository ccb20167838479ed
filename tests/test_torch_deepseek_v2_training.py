"""The DeepSeek-V2 decoder on the ASLM's normal path, on the CPU at tiny
widths: two ``AATTrainer`` steps with it against the plain reference of
``tests/reference_deepseek_v2.py`` (the loss, and the encoder's and
adapter's gradients read from AdamW's first moment); the refusal of the
tensor-, pipeline- and sequence-parallel routes; the reader of a
DeepSeek-V2 checkpoint directory (``utils/port.port_deepseek_v2``) on one
the test writes, holding a share of the routed experts; and the
``save_pretrained`` / ``load_pretrained`` round trip with this decoder."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import reference_deepseek_v2 as ref
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import build as tbuild
from aat_tpu_torch.models import deepseek_v2 as dsv2
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.training import checkpoint as ckpt
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.optim import tree_map
from aat_tpu_torch.training.trainer import AATTrainer, caption_cross_entropy
from aat_tpu_torch.utils import port as tport
from tests._torch_threads import two_threads  # noqa: F401

TRAIN = dict(learning_rate=1e-3, warmup_steps=2, max_steps=10, compute_dtype="float32",
             logging_steps=1000, eval_steps=0, save_steps=0, gradient_accumulation_steps=1)
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  layerdrop=0.0, feature_projection_dropout=0.0)


def model_and_params(held=4, offset=2, seed=0):
    lm = dsv2.tiny_test_config(held, offset)
    model = taslm.AslmModel(
        taslm.AslmConfig(projection_type="linear", audio_encoder_hidden=32, lm_hidden=32,
                         projection_hidden=48),
        dataclasses.replace(thub.tiny_test_config(), **NO_DROPOUT), lm)
    return model, model.init_params(seed, device="cpu")


def batch(rng, b=2, length=480, c=6):
    mask = np.ones((b, length), np.int32)
    mask[-1, 400:] = 0
    cmask = np.ones((b, c), np.int32)
    cmask[-1, c - 2:] = 0
    return {"waveforms": rng.normal(0, 0.3, (b, length)).astype(np.float32),
            "waveforms_attention_mask": mask, "input_ids": rng.integers(3, 100, (b, c)),
            "attention_mask": cmask, "input_ids_attention_mask": cmask}


def reference_loss_and_grads(model, params, mb):
    """The caption CE with the reference decoder over the port's encoder and
    projection (eval mode: no dropout here), and its gradients on the
    encoder's and adapter's leaves."""
    params = {k: tree_map(lambda x: x.detach().clone().requires_grad_(k != "lm_decoder"), v)
              for k, v in params.items()}
    t = {k: torch.as_tensor(v) for k, v in mb.items()}
    frames, fmask = model.encode_audio(params, t["waveforms"], t["waveforms_attention_mask"])
    inputs = model.prepare_audio_inputs(params, frames, fmask, input_ids=t["input_ids"],
                                        attention_mask=t["attention_mask"])
    logits = ref.decoder(params["lm_decoder"], model.lm_config, inputs["inputs_embeds"],
                         inputs["attention_mask"])
    loss = caption_cross_entropy(logits, t["input_ids"], t["input_ids_attention_mask"])
    leaves = {k: v for name in ("audio_encoder", "adapter")
              for k, v in ckpt.flatten({name: params[name]}).items()}
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def test_two_trainer_steps_against_reference():
    """Steps 1 and 2: the trainer's loss within 1e-5 of the reference's, and
    each encoder and adapter gradient (from AdamW's first moment mu = b1·mu
    + (1 - b1)·g) within 1e-4 of the reference's at the same parameters."""
    model, params = model_and_params()
    trainer = AATTrainer(model, params, TrainingConfig(**TRAIN))
    rng = np.random.default_rng(7)
    prev = None
    for step in range(2):
        mb = batch(rng)
        want_loss, want = reference_loss_and_grads(model, trainer.state.params, mb)
        metrics = trainer.training_step([mb])
        mu = {k: v.clone() for k, v in ckpt.flatten(
            {n: trainer.state.opt_state.mu[n] for n in ("audio_encoder", "adapter")}).items()}
        assert abs(metrics["train/loss"] - want_loss) <= 1e-5 * abs(want_loss), step
        for k, g in want.items():
            got = (mu[k] - (0.9 * prev[k] if prev else 0.0)) / 0.1
            torch.testing.assert_close(got, g, rtol=1e-4, atol=1e-7, msg=f"step {step} {k}")
        prev = mu


@pytest.mark.parametrize("axis", ["tp", "pp", "sp"])
def test_model_parallel_routes_refused(axis):
    model, params = model_and_params()
    with pytest.raises(ValueError, match="dp and fsdp only"):
        AATTrainer(model, params, TrainingConfig(**TRAIN, **{f"mesh_{axis}": 2}))


def hf_state(cfg, seed=1):
    """A DeepseekV2ForCausalLM state dict (``[out, in]`` Linear weights) of
    ``cfg`` with every routed expert, drawn at random."""
    g = torch.Generator().manual_seed(seed)
    h, nh = cfg.hidden_size, cfg.num_attention_heads

    def w(*shape):
        return torch.randn(*shape, generator=g)

    def mlp(base, width):
        return {f"{base}.gate_proj.weight": w(width, h), f"{base}.up_proj.weight": w(width, h),
                f"{base}.down_proj.weight": w(h, width)}

    s = {"model.embed_tokens.weight": w(cfg.vocab_size, h), "model.norm.weight": w(h),
         "lm_head.weight": w(cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}"
        s.update({f"{b}.input_layernorm.weight": w(h),
                  f"{b}.post_attention_layernorm.weight": w(h),
                  f"{b}.self_attn.q_proj.weight": w(nh * cfg.qk_head_dim, h),
                  f"{b}.self_attn.kv_a_proj_with_mqa.weight": w(
                      cfg.kv_lora_rank + cfg.qk_rope_head_dim, h),
                  f"{b}.self_attn.kv_a_layernorm.weight": w(cfg.kv_lora_rank),
                  f"{b}.self_attn.kv_b_proj.weight": w(
                      nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank),
                  f"{b}.self_attn.o_proj.weight": w(h, nh * cfg.v_head_dim)})
        if cfg.is_moe_layer(i):
            s[f"{b}.mlp.gate.weight"] = w(cfg.n_routed_experts, h)
            for e in range(cfg.n_routed_experts):
                s.update(mlp(f"{b}.mlp.experts.{e}", cfg.moe_intermediate_size))
            s.update(mlp(f"{b}.mlp.shared_experts",
                         cfg.moe_intermediate_size * cfg.n_shared_experts))
        else:
            s.update(mlp(f"{b}.mlp", cfg.intermediate_size))
    return s


def hf_config(cfg, **over):
    return dict({"model_type": "deepseek_v2", "vocab_size": cfg.vocab_size,
                 "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                 "moe_intermediate_size": cfg.moe_intermediate_size,
                 "num_hidden_layers": cfg.num_hidden_layers,
                 "num_attention_heads": cfg.num_attention_heads,
                 "num_key_value_heads": cfg.num_attention_heads,
                 "n_shared_experts": cfg.n_shared_experts, "n_routed_experts": cfg.n_routed_experts,
                 "num_experts_per_tok": cfg.num_experts_per_tok, "routed_scaling_factor": 1.0,
                 "norm_topk_prob": False, "first_k_dense_replace": 1, "moe_layer_freq": 1,
                 "kv_lora_rank": cfg.kv_lora_rank, "q_lora_rank": None,
                 "qk_nope_head_dim": cfg.qk_nope_head_dim,
                 "qk_rope_head_dim": cfg.qk_rope_head_dim, "v_head_dim": cfg.v_head_dim,
                 "rms_norm_eps": 1e-6, "rope_theta": 10000, "hidden_act": "silu",
                 "max_position_embeddings": cfg.max_position_embeddings,
                 "rope_scaling": {"type": "yarn", "factor": cfg.rope_factor,
                                  "original_max_position_embeddings":
                                      cfg.rope_original_max_position_embeddings,
                                  "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                                  "mscale_all_dim": 0.707},
                 "topk_method": "greedy", "scoring_func": "softmax",
                 "tie_word_embeddings": False}, **over)


def write_dir(path, config, state):
    path.mkdir()
    (path / "config.json").write_text(json.dumps(config))
    torch.save(state, path / "pytorch_model.bin")
    return str(path)


def test_port_reads_a_checkpoint_holding_a_share(tmp_path):
    """Experts 2-5 of 8 read from a written checkpoint: every leaf equal to
    the file's tensor (Linear weights transposed to ``[in, out]``, held
    experts stacked), the config field for field; a q LoRA is refused."""
    cfg = dsv2.tiny_test_config(8, 0)
    state = hf_state(cfg)
    path = write_dir(tmp_path / "dsv2", hf_config(cfg), state)
    params, got_cfg = tport.port_deepseek_v2(path, experts_held=4, expert_offset=2)
    assert got_cfg == dataclasses.replace(cfg, experts_held=4, expert_offset=2,
                                          rope_theta=10000)
    lay = params["layers"][2]
    assert torch.equal(lay["attention"]["kv_a"]["kernel"],
                       state["model.layers.2.self_attn.kv_a_proj_with_mqa.weight"].t())
    assert torch.equal(lay["moe"]["router"]["weight"], state["model.layers.2.mlp.gate.weight"])
    for j, e in enumerate(range(2, 6)):
        assert torch.equal(lay["moe"]["experts"]["down"][j],
                           state[f"model.layers.2.mlp.experts.{e}.down_proj.weight"].t())
    assert lay["moe"]["experts"]["gate"].shape == (4, 32, 16)
    assert torch.equal(params["layers"][0]["mlp"]["up"]["kernel"],
                       state["model.layers.0.mlp.up_proj.weight"].t())
    assert torch.equal(params["lm_head"]["kernel"], state["lm_head.weight"].t())
    lora = write_dir(tmp_path / "lora", hf_config(cfg, q_lora_rank=16), state)
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        tport.port_deepseek_v2(lora)
    with pytest.raises(ValueError, match="do not lie among"):
        tport.port_deepseek_v2(path, experts_held=4, expert_offset=6)


def test_export_round_trip_with_deepseek_decoder(tmp_path):
    """A trainer with the DeepSeek-V2 decoder (LM trained, so exported)
    saves; ``config.json`` names the decoder; ``load_pretrained`` rebuilds
    the same configs and parameters, and the same logits."""
    model, params = model_and_params()
    trainer = AATTrainer(model, params, TrainingConfig(**dict(TRAIN, train_lm_decoder=True),
                                                       output_dir=str(tmp_path / "run")))
    trainer.training_step([batch(np.random.default_rng(3))], fetch_metrics=False)
    export = trainer.save_pretrained(str(tmp_path / "export"))
    with open(f"{export}/config.json") as f:
        assert json.load(f)["lm_decoder_type"] == "deepseek_v2"
    model2, params2 = tbuild.load_pretrained(export, device="cpu")
    assert model2.lm_config == model.lm_config and model2.config == model.config
    saved, got = ckpt.flatten(trainer.state.params), ckpt.flatten(params2)
    assert set(got) == set(saved) and all(torch.equal(got[k], v) for k, v in saved.items())
    x = torch.randn(1, 9, 32)
    mask = torch.ones(1, 9, dtype=torch.int32)
    torch.testing.assert_close(model2.forward(params2, x, mask),
                               model.forward(trainer.state.params, x, mask))
