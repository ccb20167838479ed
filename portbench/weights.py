"""Weights from the seed, made on the device in the parameter tree the
port's ASLM takes, and handed alike to the program and to the reference.

Each subtree (``audio_encoder``, ``adapter``, ``lm_decoder``) draws all its
random leaves in one ``normal_`` call of a generator on the card, seeded
from ``(seed, subtree)``, and cuts them as views in a fixed order: weights
and embeddings normal with std 0.02, biases zero, norm scales one, as the
port's random init draws them. The same seed on the same device gives the
same bits, so the reference makes its copy anew instead of keeping one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

STD = 0.02
SUBTREES = ("audio_encoder", "adapter", "lm_decoder")

Spec = Tuple[Tuple, Tuple[int, ...], str]  # (path, shape, "normal" | "zeros" | "ones")


def _dense(path, din, dout, bias=True) -> List[Spec]:
    out = [(path + ("kernel",), (din, dout), "normal")]
    return out + ([(path + ("bias",), (dout,), "zeros")] if bias else [])


def _norm(path, d, bias=True) -> List[Spec]:
    out = [(path + ("scale",), (d,), "ones")]
    return out + ([(path + ("bias",), (d,), "zeros")] if bias else [])


def encoder_specs(enc: dict) -> List[Spec]:
    """HuBERT / wav2vec2-large (``feat_extract_norm`` "layer"), conv kernels
    in the port's ``[C_out, C_in / groups, K]`` layout."""
    specs, c_in = [], 1
    for i, (c_out, k) in enumerate(zip(enc["conv_dim"], enc["conv_kernel"])):
        p = ("feature_extractor", i)
        specs.append((p + ("conv", "kernel"), (c_out, c_in, k), "normal"))
        if enc["conv_bias"]:
            specs.append((p + ("conv", "bias"), (c_out,), "zeros"))
        specs += _norm(p + ("layer_norm",), c_out)
        c_in = c_out
    h, i = enc["hidden_size"], enc["intermediate_size"]
    specs += _norm(("feature_projection", "layer_norm"), c_in)
    specs += _dense(("feature_projection", "projection"), c_in, h)
    groups = enc["num_conv_pos_embedding_groups"]
    specs.append((("pos_conv", "kernel"), (h, h // groups, enc["num_conv_pos_embeddings"]),
                  "normal"))
    specs.append((("pos_conv", "bias"), (h,), "zeros"))
    for layer in range(enc["num_hidden_layers"]):
        p = ("layers", layer)
        for name in ("q", "k", "v", "out"):
            specs += _dense(p + ("attention", name), h, h)
        specs += _norm(p + ("layer_norm",), h)
        specs += _dense(p + ("feed_forward", "intermediate"), h, i)
        specs += _dense(p + ("feed_forward", "output"), i, h)
        specs += _norm(p + ("final_layer_norm",), h)
    return specs + _norm(("encoder_layer_norm",), h)


def adapter_specs(config: dict) -> List[Spec]:
    """The linear projection (k = 1) and the audio BOS/EOS embeddings."""
    e, h_lm, hid = config["hubert"]["hidden_size"], config["lm"]["hidden_size"], \
        config["projection_hidden"]
    return ([(("audio_tokens_embeddings", "embedding"), (2, h_lm), "normal")]
            + _dense(("projection", "in"), e, hid) + _dense(("projection", "out"), hid, h_lm))


def lm_specs(lm: dict) -> List[Spec]:
    """A Llama-architecture decoder (SmolLM, Qwen1.5)."""
    h, v = lm["hidden_size"], lm["vocab_size"]
    kv = lm["num_key_value_heads"] * (h // lm["num_attention_heads"])
    bias = lm["attention_bias"]
    specs = [(("embed_tokens", "embedding"), (v, h), "normal")]
    for layer in range(lm["num_hidden_layers"]):
        p = ("layers", layer)
        specs += _norm(p + ("input_norm",), h, bias=False)
        specs += _dense(p + ("attention", "q"), h, h, bias)
        specs += _dense(p + ("attention", "k"), h, kv, bias)
        specs += _dense(p + ("attention", "v"), h, kv, bias)
        specs += _dense(p + ("attention", "out"), h, h, False)
        specs += _norm(p + ("post_attention_norm",), h, bias=False)
        specs += _dense(p + ("mlp", "gate"), h, lm["intermediate_size"], False)
        specs += _dense(p + ("mlp", "up"), h, lm["intermediate_size"], False)
        specs += _dense(p + ("mlp", "down"), lm["intermediate_size"], h, False)
    specs += _norm(("final_norm",), h, bias=False)
    if not lm["tie_word_embeddings"]:
        specs += _dense(("lm_head",), h, v, False)
    return specs


def specs_of(config: dict) -> Dict[str, List[Spec]]:
    return {"audio_encoder": encoder_specs(config["hubert"]),
            "adapter": adapter_specs(config), "lm_decoder": lm_specs(config["lm"])}


def generator_seed(seed: int, subtree: str) -> int:
    """A 64-bit generator seed from the run's seed and the subtree."""
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), SUBTREES.index(subtree)])
    return int(words.generate_state(1, np.uint64)[0])


def _insert(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make_subtree(specs: List[Spec], seed: int, subtree: str, device,
                 dtype=torch.float32) -> dict:
    """One subtree's leaves: the random ones views into one buffer drawn in
    one call."""
    numel = [int(np.prod(shape)) for _, shape, kind in specs if kind == "normal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, subtree))
    flat = torch.empty(sum(numel), dtype=dtype, device=device)
    flat.normal_(0.0, STD, generator=gen)
    tree: dict = {}
    offset = 0
    for path, shape, kind in specs:
        if kind == "normal":
            n = int(np.prod(shape))
            leaf = flat[offset: offset + n].view(shape)
            offset += n
        elif kind == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        else:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        _insert(tree, path, leaf)
    return tree


def make_params(config: dict, seed: int, device, subtrees=SUBTREES) -> dict:
    """``{subtree: tree}`` for the named subtrees, on ``device``."""
    specs = specs_of(config)
    return {name: make_subtree(specs[name], seed, name, device) for name in subtrees}


def leaf_items(tree, prefix: str = ""):
    """``[(path, tensor), ...]`` of a tree's leaves, paths joined by "/"."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaf_items(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaf_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]
