"""Model construction (counterpart of ``aat_tpu/models/build.py``): the
audio encoder and the Llama-family LM decoder that a
:class:`~aat_tpu_torch.training.config.TrainingConfig` names, and the
composed ASLM, with random weights drawn as the JAX package draws them
(``PRNGKey(0)`` for the encoder, ``PRNGKey(1)`` for the decoder,
``PRNGKey(seed)`` for the adapter).

Reading pretrained checkpoints (``pretrained=True``) needs the HF
``transformers`` readers and the checkpoint files, which the port does not
have: it raises, naming ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

from aat_tpu_torch.models import hubert as hub
from aat_tpu_torch.models import llama as llm
from aat_tpu_torch.models.aslm import AslmConfig, AslmModel, init_aslm_params
from aat_tpu_torch.training.config import TrainingConfig

ENCODER_KEY = (0, 0)  # jax.random.key_data(PRNGKey(0))
DECODER_KEY = (0, 1)  # jax.random.key_data(PRNGKey(1))


def _no_pretrained(what: str):
    raise NotImplementedError(
        f"reading a pretrained {what} checkpoint is not ported yet "
        "(ROADMAP Queue 1 item 3, the export loader and pretrained checkpoints); "
        "pass pretrained=False for random weights")


def build_audio_encoder(config: TrainingConfig, pretrained: bool = True, device=None):
    """→ (params, HubertConfig) for ``config.audio_encoder_type`` hubert
    (hubert-large) or wav2vec2 (wav2vec2-large)."""
    if pretrained:
        _no_pretrained(config.audio_encoder_checkpoint)
    if config.encoder_remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP Queue 1, trainer pieces)")
    if config.audio_encoder_type == "hubert":
        cfg = hub.hubert_large_config()
    elif config.audio_encoder_type == "wav2vec2":
        cfg = hub.wav2vec2_large_config()
    elif config.audio_encoder_type == "efficient_net":
        raise NotImplementedError("EfficientNet is not ported yet (ROADMAP Queue 1, EfficientNet)")
    else:
        raise ValueError(f"unknown audio_encoder_type: {config.audio_encoder_type}")
    return hub.init_hubert_params(ENCODER_KEY, cfg, device), cfg


def build_lm_decoder(config: TrainingConfig, pretrained: bool = True, device=None):
    """→ (params, LlamaConfig): Qwen-1.5-1.8B when ``lm_pretrained_model``
    names Qwen, SmolLM-135M otherwise."""
    if pretrained:
        _no_pretrained(config.lm_pretrained_model)
    name = config.lm_pretrained_model.lower()
    cfg = llm.qwen15_18b_config() if "qwen" in name else llm.smollm_135m_config()
    return llm.init_llama_params(DECODER_KEY, cfg, device), cfg


def build_model(config: TrainingConfig, pretrained: bool = True,
                from_pretrained_adapter=None, seed: int = 0, device=None):
    """→ (AslmModel, params): the encoder and decoder of
    :func:`build_audio_encoder` / :func:`build_lm_decoder` and a fresh
    adapter (``init_aslm_params(PRNGKey(seed))``). Freezing is the
    trainer's freeze mask, as in JAX."""
    if from_pretrained_adapter is not None:
        raise NotImplementedError("restoring an adapter checkpoint is not ported yet "
                                  "(ROADMAP Queue 1 item 3)")
    enc_params, enc_cfg = build_audio_encoder(config, pretrained, device)
    lm_params, lm_cfg = build_lm_decoder(config, pretrained, device)
    aslm_cfg = AslmConfig(
        projection_type=config.projection_type,
        audio_encoder_embeddings_seq_len=config.audio_encoder_embeddings_seq_len,
        audio_encoder_hidden=enc_cfg.hidden_size, lm_hidden=lm_cfg.hidden_size)
    adapter = init_aslm_params((0, int(seed)), aslm_cfg, device)
    return (AslmModel(aslm_cfg, enc_cfg, lm_cfg),
            {"audio_encoder": enc_params, "adapter": adapter, "lm_decoder": lm_params})
