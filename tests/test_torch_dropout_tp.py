"""Dropout on a tensor-parallel shard keyed on global places
(``aat_tpu_torch/ops/attention.py``, ``ops/dropout.py``), on the CPU:

- the plain forward, dq and dk/dv routes launched on half of the heads
  with ``head_keys = (heads_total, head_offset)`` drop exactly what the
  global launch drops on those heads, dense and causal, with and without
  GQA (8 q-heads over 2 kv heads split in two); the masks are read through
  identity operands, as the kernels' keep-mask checks on the card read
  them. ``(H, 0)`` is today's key, and a half keyed on its own heads
  draws other masks;
- the activation dropout's column shards (``ElementShard.cols``), with
  row blocks and time slices, put back together equal one process's mask.

The kernels take the same ``(heads_total, head_offset)``; they run only on
the card, where ``chip_smoke.py`` holds them to these plain versions."""

import numpy as np
import pytest
import torch

from aat_tpu_torch.ops import attention as tattn
from aat_tpu_torch.ops.dropout import ElementShard, dropout, head_seeds

B, T_LEN, D, RATE, SEED = 2, 40, 16, 0.5, 24680
LAYOUTS = {"mha": (4, 4), "gqa": (8, 2)}  # (q-heads, kv heads)


def _gauss(rng, *shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


def _eye(kvh):
    return torch.eye(D)[None, :, None, :].expand(B, D, kvh, D).contiguous()


def _operands(route, h, kvh, seed=0):
    """Global operands whose outputs are zero exactly where a key was
    dropped (``route``: fwd v = I with S = D; dq k = v = I with S = D and
    out = 0; dkv T = D, dout read one q-head of each kv group at a time)."""
    rng = np.random.default_rng(seed)
    if route == "fwd":
        return {"q": _gauss(rng, B, T_LEN, h, D), "k": _gauss(rng, B, D, kvh, D), "v": _eye(kvh)}
    if route == "dq":
        return {"q": _gauss(rng, B, T_LEN, h, D), "k": _eye(kvh), "v": _eye(kvh),
                "dout": _gauss(rng, B, T_LEN, h, D)}
    return {"q": _gauss(rng, B, D, h, D), "k": _gauss(rng, B, T_LEN, kvh, D),
            "v": _gauss(rng, B, T_LEN, kvh, D)}


def _read_keep(route, ops, causal, head_keys):
    """[B, H, T, S] bool: where the route kept a key, read from its output."""
    q, k, v = ops["q"], ops["k"], ops["v"]
    h, kvh = q.shape[2], k.shape[2]
    scale = D ** -0.5
    mask = torch.ones((B, k.shape[1]), dtype=torch.int32)
    kw = dict(causal=causal, dropout_rate=RATE, dropout_seed=SEED, head_keys=head_keys)
    out, lse = tattn.flash_forward_reference(q, k, v, mask, scale, **kw)
    if route == "fwd":
        return (out != 0).permute(0, 2, 1, 3)
    if route == "dq":
        dq = tattn.flash_backward_dq_reference(q, k, v, mask, torch.zeros_like(out), lse,
                                               ops["dout"], scale, **kw)
        return (dq != 0).permute(0, 2, 1, 3)
    rep = h // kvh
    kept = torch.zeros((B, h, q.shape[1], k.shape[1]), dtype=torch.bool)
    for r in range(rep):  # dout = I on q-head r of each group, so dv is that head's
        dout = torch.zeros_like(q)
        dout[:, :, r::rep] = torch.eye(D)[None, :, None, :]
        _, dv = tattn.flash_backward_dkv_reference(q, k, v, mask, out, lse, dout, scale, **kw)
        kept[:, r::rep] = (dv != 0).permute(0, 2, 3, 1)
    return kept


def _half(ops, part, h, kvh):
    """The operands of half ``part`` of the heads (and of their kv heads)."""
    hs, ks = slice(part * h // 2, (part + 1) * h // 2), slice(part * kvh // 2,
                                                            (part + 1) * kvh // 2)
    return {name: x[:, :, ks if name in ("k", "v") else hs] for name, x in ops.items()}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("route", ["fwd", "dq", "dkv"])
def test_a_head_slice_drops_what_the_global_launch_drops(route, causal, layout):
    h, kvh = LAYOUTS[layout]
    ops = _operands(route, h, kvh)
    whole = _read_keep(route, ops, causal, None)
    t, s = whole.shape[2:]
    allowed = tattn._allowed(torch.ones((B, s), dtype=torch.int32), t, s, causal,
                             None).expand(B, h, t, s)
    keep = tattn._keep_mask(SEED, B, h, t, s, RATE, "cpu")
    assert torch.equal(whole[allowed], keep[allowed])  # the reading reads the mask
    assert torch.equal(_read_keep(route, ops, causal, (h, 0)), whole)
    for part in range(2):
        sl = slice(part * h // 2, (part + 1) * h // 2)
        half = _read_keep(route, _half(ops, part, h, kvh), causal, (h, part * h // 2))
        assert torch.equal(half, whole[:, sl])
    local = _read_keep(route, _half(ops, 1, h, kvh), causal, None)  # keyed on its own heads
    assert not torch.equal(local, whole[:, h // 2:])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_head_keys_place_the_heads_in_the_global_row(layout):
    h, _ = LAYOUTS[layout]
    rows, t = 3, 24
    whole = tattn._keep_mask(SEED, rows, h, t, t, 0.3, "cpu")
    assert torch.equal(tattn._keep_mask(SEED, rows, h, t, t, 0.3, "cpu", (h, 0)), whole)
    assert torch.equal(head_seeds(SEED, rows * h, None, h, (h, 0)), head_seeds(SEED, rows * h))
    for width in (1, h // 2):
        for offset in range(0, h, width):
            got = tattn._keep_mask(SEED, rows, width, t, t, 0.3, "cpu", (h, offset))
            assert torch.equal(got, whole[:, offset:offset + width])
    with pytest.raises(ValueError, match="head keys"):
        tattn._keep_mask(SEED, rows, h // 2, t, t, 0.3, "cpu", (h, h // 2 + 1))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rows", [1, 2], ids=["one_row_block", "dp2"])
@pytest.mark.parametrize("time", [False, True], ids=["whole_time", "sp2"])
def test_activation_column_shards_equal_one_process(tp, rows, time):
    """x [8, 19, 12] (batch, time, the feed-forward's columns): each rank's
    rows, time slice (T = 19 padded to 20 over sp = 2) and columns, its
    mask keyed by ``ElementShard(row, time, cols)``, put back together."""
    x = torch.ones(8, 19, 12)
    whole = dropout(1234, x, 0.3)
    padded = torch.nn.functional.pad(x, (0, 0, 0, 1))
    width = 12 // tp
    row_parts = []
    for r, block in enumerate(padded.chunk(rows)):
        slices = []
        for sp in range(2 if time else 1):
            part = block[:, sp * 10:(sp + 1) * 10] if time else block[:, :19]
            cols = [dropout(1234, part[..., c * width:(c + 1) * width], 0.3,
                            ElementShard(r, (sp * 10, 19) if time else None,
                                         (c * width, 12)))
                    for c in range(tp)]
            slices.append(torch.cat(cols, -1))
        row_parts.append(torch.cat(slices, 1)[:, :19])
    assert torch.equal(torch.cat(row_parts), whole)
    # keyed on the rank's own columns, the shards repeat one another's mask
    local = [dropout(1234, x[..., c * width:(c + 1) * width], 0.3) for c in range(tp)]
    assert torch.equal(local[0], local[1]) and not torch.equal(torch.cat(local, -1), whole)


def test_a_column_shard_needs_a_column_dim():
    with pytest.raises(ValueError, match="does not place"):
        dropout(1, torch.ones(5, 4), 0.3, ElementShard(0, (0, 4), (0, 8)))
