"""The port's pipeline parallelism (``aat_tpu_torch/parallel/pipeline.py``)
against the JAX package's and against plain loops:

- the stacked layout: stack / unstack round trips, per-layer views, and a
  checkpoint's flat entries moved between layouts, bit for bit;
- ``stacked_leaf_spec`` / ``shard_params`` equal to JAX's, leaf by leaf, for
  pp2 with tp2 and fsdp2, on the tiny trees and at full width
  (hubert-large, SmolLM-135M, Qwen-1.5-1.8B; shape-only trees);
- ``gpipe_apply`` on 2 and 4 gloo ranks: a toy stack's output and every
  gradient (its stage's layers, an upstream scale, the input) equal a
  plain loop's, for M in {1, 2, 4} and JAX's clamp of M to a divisor of
  the rank's rows, with M + pp − 2 ring steps each way and each
  microbatch's masks keyed as its first global row;
- the ring permute and its reverse-ring gradient;
- ``num_hidden_layers % pp`` refused with both numbers;
- the two planted boundary faults (the result leaving through an
  all-reduce with a summed gradient; the input entering without the sum
  of the stages' gradients) break the gradients by far more than the bar.

The ranks run ``tests/_torch_parallel_workers.py`` (no JAX)."""

import numpy as np
import pytest
import torch

import jax

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu.parallel import mesh as jmesh
from aat_tpu.parallel import pipeline as jpipe
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.parallel import mesh as tmesh
from aat_tpu_torch.parallel import pipeline as tpipe
from aat_tpu_torch.parallel.distributed import launch
from aat_tpu_torch.training import checkpoint as ckpt_lib
from aat_tpu_torch.training.optim import tree_leaves, tree_map, tree_paths
from aat_tpu_torch.utils import port

import _torch_parallel_workers as workers
from _torch_parallel_cases import PARAM_BAR
from test_torch_parallel_mesh import FULL_WIDTH, _Shape, _shape_only

GRAD_BAR = 1e-5  # the toy stack's outputs and gradients, f32


def _tiny_tree(seed=0):
    model, params = workers.tiny_model(layers=4, seed=seed)
    return params


def test_stack_unstack_and_checkpoint_layouts_round_trip():
    params = _tiny_tree()
    stacked = {k: tpipe.stack_model_layers(v) for k, v in params.items()}
    for k in ("audio_encoder", "lm_decoder"):
        assert tpipe.is_stacked(stacked[k]["layers"])
        q = stacked[k]["layers"]["attention"]["q"]["kernel"]
        assert tuple(q.shape) == (4, 32, 32)
        views = tpipe.layer_seq(stacked[k]["layers"], 4)
        assert views[2]["attention"]["q"]["kernel"].data_ptr() == q[2].data_ptr()
    assert tmesh.stacked_prefixes(stacked) == ["audio_encoder/layers/", "lm_decoder/layers/"]
    back = {k: tpipe.unstack_model_layers(v) for k, v in stacked.items()}
    flat, flat_back = ckpt_lib.flatten(params), ckpt_lib.flatten(back)
    assert set(flat) == set(flat_back)
    for k in flat:
        assert torch.equal(flat[k], flat_back[k]), k
    # a checkpoint's flat entries, moved to either layout
    flat_stacked = ckpt_lib.flatten(stacked)
    to_stacked = tpipe.flat_to_layout(flat, stacked)
    to_list = tpipe.flat_to_layout(flat_stacked, params)
    assert set(to_stacked) == set(flat_stacked) and set(to_list) == set(flat)
    for k in flat_stacked:
        assert torch.equal(to_stacked[k], flat_stacked[k]), k
    for k in flat:
        assert torch.equal(to_list[k], flat[k]), k
    # unstacked entries are fresh tensors, not views of the stacked one
    q = flat_stacked["lm_decoder.layers.attention.q.kernel"]
    assert (to_list["lm_decoder.layers.1.attention.q.kernel"].untyped_storage().data_ptr()
            != q.untyped_storage().data_ptr())
    # the same layout passes as it is
    assert tpipe.flat_to_layout(flat, params).keys() == flat.keys()


def _stack_shapes(tree):
    """A shape-only tree with its encoder's and LM's layers stacked."""
    def stack(sub):
        if not isinstance(sub.get("layers"), list):
            return sub
        layers = sub["layers"]
        return {**sub, "layers": tree_map(lambda *xs: _Shape((len(xs),) + xs[0].shape),
                                          layers[0], *layers[1:])}

    return {k: stack(v) if k != "adapter" else v for k, v in tree.items()}


def _compare_specs(jtree, ttree, sizes, stacked_tp):
    """JAX's and the port's specs, leaf by leaf → the stacked leaves' count."""
    want = jmesh.shard_params(jtree, jmesh.make_mesh(**sizes), stacked_tp)
    got = tmesh.shard_params(ttree, {"dp": 1, "sp": 1, "fsdp": 1, "tp": 1, **sizes},
                             stacked_tp)
    perms = {"/".join(map(str, p)): perm for p, perm in port.conv_perms(ttree).items()}
    jax_specs = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): sharding.spec
        for path, sharding in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))}
    paths = tree_leaves(tree_paths(ttree))
    assert set(paths) == set(jax_specs)
    stacked = 0
    for path, spec in zip(paths, tree_leaves(got)):
        jax_spec = tuple(jax_specs[path]) + (None,) * (len(spec.dims) - len(jax_specs[path]))
        perm = perms.get(path, tuple(range(len(spec.dims))))
        assert spec.dims == tuple(jax_spec[perm[i]] for i in range(len(perm))), path
        stacked += "/layers/" in path and path.split("/")[0] != "adapter"
    return got, stacked


MESHES = [{"pp": 2}, {"pp": 2, "tp": 2}, {"pp": 2, "fsdp": 2}, {"pp": 2, "tp": 2, "fsdp": 2}]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "_".join(f"{k}{v}" for k, v in s.items()))
def test_stacked_specs_equal_jax_on_the_tiny_trees(sizes):
    params = _tiny_tree()
    jtree = jax.tree.map(np.asarray, port.to_jax_params(params))
    jtree = {k: jpipe.stack_model_layers(v) if k != "adapter" else v for k, v in jtree.items()}
    ttree = {k: tpipe.stack_model_layers(v) if k != "adapter" else v for k, v in params.items()}
    tp = sizes.get("tp", 1)
    stacked_tp = {"audio_encoder": thub.tp_partitionable(thub.tiny_test_config(), tp),
                  "lm_decoder": tllm.tp_partitionable(tllm.tiny_test_config(), tp)}
    got, stacked = _compare_specs(jtree, ttree, sizes, stacked_tp)
    assert stacked > 20
    layers = got["audio_encoder"]["layers"]
    # JAX's asserts (tests/test_multichip.py): q columns and its bias on tp,
    # the LM's down rows on tp; under fsdp the matrices' widest free axis
    if tp > 1:
        assert layers["attention"]["q"]["kernel"].dims[:1] == ("pp",)
        assert layers["attention"]["q"]["kernel"].dims[2] == "tp"
        assert layers["attention"]["q"]["bias"].dims == ("pp", "tp")
        assert got["lm_decoder"]["layers"]["mlp"]["down"]["kernel"].dims[:2] == ("pp", "tp")
    if "fsdp" in sizes:
        assert "fsdp" in layers["attention"]["q"]["kernel"].dims
        assert layers["attention"]["q"]["bias"].dims[1:] in ((None,), ("tp",))


@pytest.mark.parametrize("sizes", MESHES[1:], ids=lambda s: "_".join(f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("lm", sorted(FULL_WIDTH))
def test_stacked_specs_equal_jax_at_full_width(monkeypatch, sizes, lm):
    _shape_only(monkeypatch)
    jlm, tlm, lm_hidden = FULL_WIDTH[lm]
    jtree = _stack_shapes({
        "audio_encoder": jhub.init_hubert_params(0, jhub.hubert_large_config()),
        "adapter": jaslm.init_aslm_params(1, jaslm.AslmConfig(lm_hidden=lm_hidden)),
        "lm_decoder": jllm.init_llama_params(2, jlm())})
    ttree = {"audio_encoder": thub.init_hubert_numpy(0, thub.hubert_large_config()),
             "adapter": taslm.init_aslm_numpy(1, taslm.AslmConfig(lm_hidden=lm_hidden)),
             "lm_decoder": tllm.init_llama_numpy(2, tlm())}
    perms = {"/".join(map(str, p)): perm for p, perm in port.conv_perms(ttree).items()}

    def to_port(path, leaf):
        shape = np.shape(leaf)
        perm = perms.get(path)
        return _Shape(shape if perm is None else [shape[j] for j in perm])

    ttree = _stack_shapes(tree_map(to_port, tree_paths(ttree), ttree))
    tp = sizes.get("tp", 1)
    stacked_tp = {"audio_encoder": thub.tp_partitionable(thub.hubert_large_config(), tp),
                  "lm_decoder": tllm.tp_partitionable(tlm(), tp)}
    # SmolLM's 9 heads do not split at tp 2: its stacks are pp-only
    assert stacked_tp["lm_decoder"] == (lm == "qwen" and tp > 1)
    got, stacked = _compare_specs(jtree, ttree, sizes, stacked_tp)
    assert stacked > 20
    down = got["lm_decoder"]["layers"]["mlp"]["down"]["kernel"].dims
    assert down[0] == "pp" and (down[1] == "tp") == (lm == "qwen" and tp > 1)


def _plain(problem):
    return workers.toy_pipeline(problem)


# (world, mesh, global rows, requested M, the M used)
GPIPE_RUNS = [
    (2, {"pp": 2}, 6, 1, 1),
    (2, {"pp": 2}, 6, 2, 2),
    (2, {"pp": 2}, 6, 4, 3),  # JAX's clamp: the largest divisor of 6 below 4
    (4, {"pp": 4}, 8, 4, 4),
    (4, {"dp": 2, "pp": 2}, 12, 4, 3),
    (4, {"dp": 2, "pp": 2}, 8, 0, 4),  # 0: 2·pp
]


@pytest.mark.parametrize("world, sizes, rows, requested, used", GPIPE_RUNS)
def test_gpipe_apply_equals_a_plain_loop(world, sizes, rows, requested, used):
    layers = 4
    problem = workers.toy_pipeline_problem(rows, layers)
    y, loss, grads, scale_grad, x_grad = _plain(problem)
    out = launch(workers.gpipe_rank, world, (sizes, rows, layers, requested),
                 timeout=workers.TIMEOUT)
    pp = sizes["pp"]
    per, local = layers // pp, rows // (world // pp)
    summed = {}
    for stage, data_rank, (ry, rloss, rgrads, rscale, rx), m, ring, ring_bytes, blocks in out:
        assert m == used
        assert blocks == [data_rank * m + j for j in range(m)]
        rows_of = slice(data_rank * local, (data_rank + 1) * local)
        np.testing.assert_allclose(ry, y[rows_of], atol=GRAD_BAR, rtol=0)
        np.testing.assert_allclose(rx, x_grad[rows_of], atol=GRAD_BAR, rtol=0)
        steps = m + pp - 2
        assert ring == {"ring_permute (gloo)": 2 * steps}
        assert ring_bytes["forward"] == ring_bytes["backward"] == steps * (local // m) * 3 * 8 * 4
        acc = summed.setdefault(stage, [0.0, {k: 0.0 for k in rgrads}])
        acc[0] += rscale
        for k, v in rgrads.items():
            acc[1][k] = acc[1][k] + v
    for stage, (rscale, rgrads) in summed.items():
        # the upstream scale's gradient: every pp peer holds the whole one
        assert abs(rscale - scale_grad) < GRAD_BAR * max(1.0, abs(scale_grad))
        for k, v in rgrads.items():
            np.testing.assert_allclose(v, grads[k][stage * per:(stage + 1) * per],
                                       atol=GRAD_BAR, rtol=0, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_permute_and_its_gradient(world):
    out = launch(workers.ring_rank, world, timeout=workers.TIMEOUT)
    for rank, (arrived, grad) in enumerate(out):
        np.testing.assert_array_equal(arrived, np.full(3, float((rank - 1) % world + 1)))
        # what this rank sent was used by the next rank, with its weights
        np.testing.assert_array_equal(grad, np.arange(3.0) * (10 * ((rank + 1) % world) + 1))


class _PipelineMesh:
    """A mesh with a pp axis of 2 and nothing else (no process group)."""

    coords = {"pp": 0}

    def size(self, *axes):
        return 2 if axes == ("pp",) else 1


def test_layers_must_divide_pp():
    with pytest.raises(ValueError, match="num_hidden_layers=3 is not divisible by mesh_pp=2"):
        tpipe.check_layers(3, 2)
    problem = workers.toy_pipeline_problem(4, 3)
    stacked = {k: torch.tensor(problem[k]) for k in ("w", "b")}
    with pytest.raises(ValueError, match="num_hidden_layers=3 is not divisible by mesh_pp=2"):
        tpipe.gpipe_apply(workers.toy_layer, stacked, torch.tensor(problem["x"]),
                          (torch.tensor(problem["mask"]),), _PipelineMesh(), num_layers=3)
    assert tpipe.check_layers(24, 2) == 12 and tpipe.check_layers(30, 2) == 15


@pytest.mark.parametrize("fault", ["pipeline_exit_sum", "pipeline_entry_identity"])
def test_planted_boundary_faults_break_the_gradients(fault):
    layers, rows = 4, 6
    problem = workers.toy_pipeline_problem(rows, layers)
    _, _, grads, scale_grad, x_grad = _plain(problem)
    out = launch(workers.gpipe_rank, 2, ({"pp": 2}, rows, layers, 2, fault),
                 timeout=workers.TIMEOUT)
    worst = 0.0
    for stage, _, (_, _, rgrads, rscale, rx), *_ in out:
        worst = max(worst, abs(rscale - scale_grad), float(np.abs(rx - x_grad).max()),
                    max(float(np.abs(v - grads[k][stage * 2:(stage + 1) * 2]).max())
                        for k, v in rgrads.items()))
    # the trainer cases' parameter bar (JAX's), missed by far more
    assert worst > 10 * PARAM_BAR, (fault, worst)
