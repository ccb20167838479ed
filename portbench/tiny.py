"""Tiny widths of the benchmark's configurations and traffic, for the CPU
tests: the same drivers, files and reference at sizes a test run holds."""

import copy

HUBERT = {"conv_dim": [16, 16, 16], "conv_kernel": [10, 3, 3], "conv_stride": [5, 2, 2],
          "conv_bias": True, "feat_extract_norm": "layer", "hidden_size": 32,
          "num_hidden_layers": 3, "num_attention_heads": 4, "intermediate_size": 64,
          "layer_norm_eps": 1e-5, "do_stable_layer_norm": True, "num_conv_pos_embeddings": 16,
          "num_conv_pos_embedding_groups": 4, "feature_projection_dropout": 0.0,
          "hidden_dropout": 0.1, "attention_dropout": 0.1, "activation_dropout": 0.1,
          "layerdrop": 0.1, "attention_impl": "pallas"}
LM = {"vocab_size": 256, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
      "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
      "rope_theta": 10000.0, "max_position_embeddings": 4096, "tie_word_embeddings": True,
      "attention_bias": False, "attention_impl": "pallas"}


def config(base: dict) -> dict:
    """``base`` (a configuration file's dict) at tiny widths, f32 compute."""
    out = copy.deepcopy(base)
    out.update(hubert=dict(HUBERT), lm=dict(LM), projection_hidden=64,
               per_device_train_batch_size=4, gradient_accumulation_steps=2,
               compute_dtype="float32", encoder_remat=False)
    return out


def traffic(base: dict) -> dict:
    return dict(base, items=24, words_per_s=5.0, length_s=[0.5, 0.9])
