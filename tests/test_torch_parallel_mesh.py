"""The port's mesh, placement rule, dropout shards and Ulysses attention
(``aat_tpu_torch/parallel``) against the JAX package's:

- ``shard_params`` gives JAX's ``mesh.shard_params`` spec leaf for leaf at
  full width (hubert-large + linear projection + SmolLM-135M, and with
  Qwen-1.5-1.8B), on meshes (2, 2, 2) and (1, 4, 1), from shape-only trees
  (the init's generator patched to return shapes, so no full-size array is
  drawn);
- ranks sit at JAX's row-major device order, with one group per axis;
- the dropout masks of every data rank's rows, concatenated, equal one
  process's bit for bit, for the element hash and the attention hash;
- under tp2 the ranks' attention masks (their heads, keyed globally) and
  activation masks (their feed-forward columns), put back together, equal
  one process's; under sp2 the attention seeds follow JAX's salt, and
  under tp2 × sp2 the four ranks' attention masks are distinct;
- Ulysses attention on 4 gloo ranks (dp2 × sp2) equals JAX's
  ``ulysses_attention_bthd`` on a dp2 × sp2 mesh and the port's plain
  attention within 1e-5, at T = 32 and 37 with ragged and fully masked
  rows;
- the data ranks' shards of items 0-3 assemble to rows [0, 2, 1, 3], the
  order JAX's ``tests/_mp_worker.py`` checks.

The ranks run ``tests/_torch_parallel_workers.py`` (no JAX)."""

import numpy as np
import pytest
import torch

import jax

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.ops.attention import attention_bthd as jax_attention_bthd
from aat_tpu.parallel import mesh as jmesh
from aat_tpu.parallel.sequence import ulysses_attention_bthd as jax_ulysses
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.ops import attention as tattn
from aat_tpu_torch.ops.dropout import ElementShard, dropout, shift_head_seed, to_int32
from aat_tpu_torch.parallel import mesh as tmesh
from aat_tpu_torch.parallel import sequence as tsequence
from aat_tpu_torch.parallel.distributed import launch
from aat_tpu_torch.training.optim import tree_leaves, tree_map, tree_paths
from aat_tpu_torch.utils import port

import _torch_parallel_workers as workers


class _Shape:
    """A leaf that has a shape and nothing else."""

    def __init__(self, shape):
        self.shape = tuple(int(d) for d in shape)
        self.ndim = len(self.shape)

    def astype(self, dtype):
        return self


class _ShapeRng:
    def normal(self, loc, scale, shape):
        return _Shape(shape)


def _shape_only(monkeypatch):
    for module in (jhub, thub, tllm):
        monkeypatch.setattr(module, "np_rng_from", lambda seed: _ShapeRng())


FULL_WIDTH = {
    "smollm": (jllm.smollm_135m_config, tllm.smollm_135m_config, 576),
    "qwen": (jllm.qwen15_18b_config, tllm.qwen15_18b_config, 2048),
}


@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 4, 1)])
@pytest.mark.parametrize("lm", sorted(FULL_WIDTH))
def test_shard_plan_equals_jax_at_full_width(monkeypatch, mesh, lm):
    _shape_only(monkeypatch)
    jlm, tlm, lm_hidden = FULL_WIDTH[lm]
    jtree = {"audio_encoder": jhub.init_hubert_params(0, jhub.hubert_large_config()),
             "adapter": jaslm.init_aslm_params(1, jaslm.AslmConfig(lm_hidden=lm_hidden)),
             "lm_decoder": jllm.init_llama_params(2, jlm())}
    want = jmesh.shard_params(jtree, jmesh.make_mesh(*mesh))

    ttree = {"audio_encoder": thub.init_hubert_numpy(0, thub.hubert_large_config()),
             "adapter": taslm.init_aslm_numpy(1, taslm.AslmConfig(lm_hidden=lm_hidden)),
             "lm_decoder": tllm.init_llama_numpy(2, tlm())}
    perms = {"/".join(map(str, p)): perm for p, perm in port.conv_perms(ttree).items()}

    def to_port(path, leaf):  # the port's layout: conv kernels permuted
        shape = np.shape(leaf)
        perm = perms.get(path)
        return _Shape(shape if perm is None else [shape[j] for j in perm])

    ttree = tree_map(to_port, tree_paths(ttree), ttree)
    got = tmesh.shard_params(ttree, dict(zip(("dp", "fsdp", "tp"), mesh)))

    paths = tree_leaves(tree_paths(ttree))
    jax_specs = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): sharding.spec
        for path, sharding in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))}
    assert set(paths) == set(jax_specs) and len(paths) > 600
    sharded = 0
    for path, spec in zip(paths, tree_leaves(got)):
        jax_spec = tuple(jax_specs[path]) + (None,) * (len(spec.dims) - len(jax_specs[path]))
        perm = perms.get(path, tuple(range(len(spec.dims))))
        assert spec.dims == tuple(jax_spec[perm[i]] for i in range(len(perm))), path
        sharded += bool(spec.axes())
    assert sharded > 300


def test_ranks_sit_in_jax_device_order():
    sizes = {"dp": 2, "fsdp": 2, "tp": 2}
    out = launch(workers.layout_rank, 8, (sizes,), timeout=workers.TIMEOUT)
    for rank, (coords, groups, (data_rank, data_world)) in enumerate(out):
        dp, fsdp, tp = np.unravel_index(rank, (2, 2, 2))
        assert (coords["dp"], coords["fsdp"], coords["tp"], coords["sp"]) == (dp, fsdp, tp, 0)
        assert groups[("tp",)] == [rank - tp, rank - tp + 1]
        assert groups[("fsdp",)] == sorted([rank, rank ^ 2])
        assert groups[("dp",)] == sorted([rank, rank ^ 4])
        assert groups[("sp",)] is None
        assert groups[("dp", "fsdp")] == [r for r in range(8) if r % 2 == tp]
        assert (data_rank, data_world) == (dp * 2 + fsdp, 4)


@pytest.mark.parametrize("ranks", [2, 4])
def test_dropout_masks_of_the_shards_equal_one_process(ranks):
    x = torch.ones(8, 19, 6)
    whole = dropout(1234, x, 0.3)
    parts = [dropout(1234, part, 0.3, ElementShard(r))
             for r, part in enumerate(x.chunk(ranks))]
    assert torch.equal(torch.cat(parts), whole)
    # the time-sharded encoder stack: T = 19 padded to 20 over sp = 2
    padded = torch.nn.functional.pad(x, (0, 0, 0, 1))
    for r, rows in enumerate(padded.chunk(ranks)):
        slices = [dropout(1234, rows[:, s * 10:(s + 1) * 10], 0.3, ElementShard(r, (s * 10, 19)))
                  for s in range(2)]
        assert torch.equal(torch.cat(slices, 1)[:, :19], whole.chunk(ranks)[r])
    # the attention hash: seed + bh·GOLDEN over the flattened batch·head index
    b, h, t = 8, 4, 24
    keep = tattn._keep_mask(99, b, h, t, t, 0.3, "cpu")
    rows = b // ranks
    shards = [tattn._keep_mask(shift_head_seed(99, r * rows, h), rows, h, t, t, 0.3, "cpu")
              for r in range(ranks)]
    assert torch.equal(torch.cat(shards), keep)
    assert not torch.equal(shards[1], keep[:rows])


@pytest.mark.parametrize("axis, salt", [("sp", tsequence.SP_SEED_SALT)], ids=["sp"])
def test_tp_and_sp_dropout_masks_follow_their_salts(axis, salt):
    """sp2 (2 ranks) with every encoder dropout at 0.2, against one process
    on the same step: each rank's attention seed is one process's plus its
    index times the axis' salt, and the two ranks' head groups draw
    different masks. The time slices' masks put together are one
    process's, and every other mask is one process's. (tp draws one
    process's masks: ``test_tp_dropout_masks_put_together_equal_one_process``.)"""
    one = workers.record_dropout()
    ranks = launch(workers.dropout_record_rank, 2, ({axis: 2},), timeout=workers.TIMEOUT)
    heads = thub.tiny_test_config().num_attention_heads
    for r, seen in enumerate(ranks):
        assert len(seen["attention"]) == len(one["attention"]) == 2
        for (seed, b, h, t), (seed1, b1, h1, t1) in zip(seen["attention"], one["attention"]):
            assert seed == to_int32(seed1 + r * salt)
            assert (b, h, t) == (b1, heads // 2, -(-t1 // 2) * 2)
    for (s0, b, h, t), (s1, *_) in zip(*(seen["attention"] for seen in ranks)):
        assert not torch.equal(tattn._keep_mask(s0, b, h, t, t, 0.2, "cpu"),
                               tattn._keep_mask(s1, b, h, t, t, 0.2, "cpu"))
    kinds = set()
    for i, (seed1, shape1, keep1) in enumerate(one["dropout"]):
        calls = [seen["dropout"][i] for seen in ranks]
        if calls[0][1] != shape1:
            kinds.add("time slice")
            assert all(seed == seed1 for seed, _, _ in calls)
            np.testing.assert_array_equal(
                np.concatenate([keep for _, _, keep in calls], 1)[:, :shape1[1]], keep1)
        else:
            kinds.add("one process's")
            for seed, shape, keep in calls:
                assert (seed, shape) == (seed1, shape1)
                np.testing.assert_array_equal(keep, keep1)
    assert all(len(seen["dropout"]) == len(one["dropout"]) for seen in ranks)
    assert kinds == {"time slice", "one process's"}


def test_tp_dropout_masks_put_together_equal_one_process():
    """tp2 (2 ranks) with every encoder dropout at 0.2, against one process
    on the same step: each rank's attention launch on its half of the heads
    takes one process's seed and draws exactly one process's masks of those
    heads; its activation dropout on its half of the feed-forward columns
    draws one process's masks of those columns; every other mask is one
    process's."""
    one = workers.record_dropout()
    ranks = launch(workers.dropout_record_rank, 2, ({"tp": 2},), timeout=workers.TIMEOUT)
    heads = thub.tiny_test_config().num_attention_heads
    intermediate = thub.tiny_test_config().intermediate_size
    assert len(one["attention_keep"]) == len(one["attention"]) == 2
    for r, seen in enumerate(ranks):
        assert [a[0] for a in seen["attention"]] == [a[0] for a in one["attention"]]
        assert all(a[2] == heads // 2 for a in seen["attention"])
    for i, keep1 in enumerate(one["attention_keep"]):
        parts = [seen["attention_keep"][i] for seen in ranks]
        assert parts[0].shape[1] == heads // 2
        np.testing.assert_array_equal(np.concatenate(parts, 1), keep1)
    kinds = set()
    for i, (seed1, shape1, keep1) in enumerate(one["dropout"]):
        calls = [seen["dropout"][i] for seen in ranks]
        assert all(seed == seed1 for seed, _, _ in calls)
        if shape1[-1] == intermediate:
            kinds.add("activation")
            assert all(shape == shape1[:-1] + (intermediate // 2,) for _, shape, _ in calls)
            np.testing.assert_array_equal(np.concatenate([keep for _, _, keep in calls], -1),
                                          keep1)
        else:
            kinds.add("one process's")
            for _, shape, keep in calls:
                assert shape == shape1
                np.testing.assert_array_equal(keep, keep1)
    assert all(len(seen["dropout"]) == len(one["dropout"]) for seen in ranks)
    assert kinds == {"activation", "one process's"}


def test_tp_with_sp_dropout_masks():
    """tp2 × sp2 (4 ranks, rank = 2·tp + sp) with every encoder dropout at
    0.2: the sp salt stays on top of the tp head keys, so the four ranks'
    attention launches (one head each) draw four distinct masks; the
    activation masks of each rank's time slice and columns, and the other
    masks of its time slice, put back together are one process's."""
    one = workers.record_dropout()
    ranks = launch(workers.dropout_record_rank, 4, ({"tp": 2, "sp": 2},),
                   timeout=workers.TIMEOUT)
    intermediate = thub.tiny_test_config().intermediate_size
    for r, seen in enumerate(ranks):
        for (seed, b, h, _), (seed1, *_) in zip(seen["attention"], one["attention"]):
            assert seed == to_int32(seed1 + (r % 2) * tsequence.SP_SEED_SALT) and h == 1
    for i in range(len(one["attention"])):
        masks = [seen["attention_keep"][i] for seen in ranks]
        assert all(not np.array_equal(masks[a], masks[c])
                   for a in range(4) for c in range(a + 1, 4))
    kinds = set()
    for i, (seed1, shape1, keep1) in enumerate(one["dropout"]):
        calls = [seen["dropout"][i] for seen in ranks]
        assert all(seed == seed1 for seed, _, _ in calls)
        if calls[0][1] == shape1:
            kinds.add("one process's")
            assert all(np.array_equal(keep, keep1) for _, _, keep in calls)
            continue
        by_tp = [np.concatenate([calls[2 * tp + sp][2] for sp in range(2)], 1)[:, :shape1[1]]
                 for tp in range(2)]
        if shape1[-1] == intermediate:
            kinds.add("activation")
            np.testing.assert_array_equal(np.concatenate(by_tp, -1), keep1)
        else:
            kinds.add("time slice")
            for keep in by_tp:
                np.testing.assert_array_equal(keep, keep1)
    assert kinds == {"activation", "time slice", "one process's"}


def _ulysses_operands(t):
    rng = np.random.default_rng(3)
    q, k, v = (np.asarray(rng.normal(0, 1, (4, t, 8, 16)), np.float32) for _ in range(3))
    key_mask = np.ones((4, t), np.int32)
    key_mask[0, t - 5:] = 0  # ragged tail
    key_mask[3, :] = 0  # fully masked row
    return q, k, v, key_mask


@pytest.mark.parametrize("t", [32, 37])
def test_ulysses_equals_jax_and_plain_attention(t):
    q, k, v, key_mask = _ulysses_operands(t)
    want = np.asarray(jax_ulysses(q, k, v, key_mask, jmesh.make_mesh(dp=2, fsdp=1, tp=1, sp=2),
                                  sm_scale=0.25, use_pallas=False))
    plain = tattn.attention_bthd(*(torch.as_tensor(x) for x in (q, k, v, key_mask)),
                                 sm_scale=0.25, use_kernel=False).numpy()
    np.testing.assert_allclose(
        np.asarray(jax_attention_bthd(q, k, v, key_mask, sm_scale=0.25, use_pallas=False)),
        plain, rtol=1e-5, atol=1e-5)
    out = launch(workers.ulysses_rank, 4, (q, k, v, key_mask, 0.25), timeout=workers.TIMEOUT)
    got = np.zeros((4, 2 * out[0][2].shape[1], 8, 16), np.float32)
    for data_rank, sp_index, part in out:
        tl = part.shape[1]
        got[data_rank * 2:(data_rank + 1) * 2, sp_index * tl:(sp_index + 1) * tl] = part
    got = got[:, :t]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    assert not got[3].any()  # the fully masked row


def test_data_shards_assemble_in_jax_order():
    """dp2 × tp2: ranks 0-1 (data rank 0) read the same rows, ranks 2-3
    (data rank 1) the others; default shards need the mesh."""
    out = launch(workers.shard_order_rank, 4, ({"dp": 2, "tp": 2},), timeout=workers.TIMEOUT)
    want = workers._item_collate([0, 2, 1, 3])["input_ids"]
    for rank, (local, assembled, refused) in enumerate(out):
        np.testing.assert_array_equal(local, want[:2] if rank < 2 else want[2:])
        np.testing.assert_array_equal(assembled, want)
        assert "mesh=" in refused
