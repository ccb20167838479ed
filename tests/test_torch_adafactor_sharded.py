"""Adafactor on sharded leaves (``training/optim.adafactor`` with a mesh):
every mean (the factored statistics, the block RMS of the clip, the
parameter RMS) runs over the whole leaf, by all-reduce over the axes that
shard it, as GSPMD computes JAX's. Held against JAX's ``optim.adafactor``
applied to the whole leaves:

- 3 steps on 2 and 4 gloo ranks, relative-step and constant-lr, for
  stacked ``[L, n]`` and ``[L, a, b]`` leaves under pp (JAX's pp math
  factors the stacked leaf: ``[L, n]`` over L and n), fsdp- and
  tp-sharded matrices and a replicated vector, each rank's shards within
  1e-6 of JAX's, relative to the leaf's largest value;
- a dp2 × fsdp2 Adafactor trainer against JAX's one-device trainer and the
  port's one-process trainer, and a dp2 × pp2 one against the port's
  one-process trainer on the stacked tree (JAX's own pp trainer is the
  slow oracle in ``test_torch_pipeline_jax.py``), at JAX's bars after 2
  steps (``tests/_torch_parallel_cases.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from aat_tpu.training import optim as joptim
from aat_tpu_torch.parallel import mesh as tmesh
from aat_tpu_torch.parallel.distributed import launch

import _torch_parallel_workers as workers
from _torch_parallel_cases import check_case

# (mesh, {leaf: (shape, dims)}): stacked leaves under pp, fsdp- and
# tp-sharded matrices, combinations on 4 ranks, and a replicated vector
LAYOUTS = {
    "pp2": ({"pp": 2}, {"bias": ((4, 6), ("pp", None)), "kernel": ((4, 6, 10), ("pp", None, None)),
                        "scale": ((5,), (None,))}),
    "fsdp2": ({"fsdp": 2}, {"wide_rows": ((12, 10), ("fsdp", None)),
                            "wide_cols": ((6, 16), (None, "fsdp")), "scale": ((5,), (None,))}),
    "tp2": ({"tp": 2}, {"column": ((10, 8), (None, "tp")), "row": ((8, 10), ("tp", None))}),
    "pp2_tp2": ({"tp": 2, "pp": 2}, {"q": ((4, 6, 8), ("pp", None, "tp")),
                                     "q_bias": ((4, 8), ("pp", "tp")),
                                     "down": ((4, 8, 6), ("pp", "tp", None))}),
    "pp2_fsdp2": ({"fsdp": 2, "pp": 2}, {"kernel": ((4, 12, 6), ("pp", "fsdp", None)),
                                         "bias": ((4, 6), ("pp", None))}),
}


def _problem(layout, steps=3, seed=3):
    rng = np.random.default_rng(seed)
    leaves = LAYOUTS[layout][1]
    params = {k: rng.normal(0, 0.5, shape).astype(np.float32) for k, (shape, _) in leaves.items()}
    grads = [{k: rng.normal(0, 1e-2 * (i + 1), shape).astype(np.float32)
              for k, (shape, _) in leaves.items()} for i in range(steps)]
    return params, grads


def _jax_adafactor(params, grads, learning_rate):
    tx = joptim.adafactor(learning_rate)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)
    return jax.tree.map(np.asarray, p)


def _shard(x, dims, sizes, coords):
    """``x``'s shard at ``coords`` (the port's chunk rule)."""
    for d, entry in enumerate(dims):
        if entry is not None:
            x = np.split(x, sizes[entry], axis=d)[coords[entry]]
    return x


LEARNING_RATES = (None, 0.01)  # relative step, constant


@functools.lru_cache(maxsize=None)
def _ranks(layout):
    """Each rank's shards after 3 steps, by learning rate (one launch)."""
    sizes, leaves = LAYOUTS[layout]
    params, grads = _problem(layout)
    specs = {k: dims for k, (_, dims) in leaves.items()}
    world = int(np.prod(list(sizes.values())))
    out = launch(workers.adafactor_rank, world, (sizes, params, specs, grads, LEARNING_RATES),
                 timeout=workers.TIMEOUT)
    return {lr: [rank[i] for rank in out] for i, lr in enumerate(LEARNING_RATES)}


@pytest.mark.parametrize("learning_rate", LEARNING_RATES, ids=["relative", "constant"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_adafactor_equals_jax_on_whole_leaves(layout, learning_rate):
    sizes, leaves = LAYOUTS[layout]
    params, grads = _problem(layout)
    want = _jax_adafactor(params, grads, learning_rate)
    specs = {k: dims for k, (_, dims) in leaves.items()}
    full = {**{a: 1 for a in tmesh.AXES}, **sizes}
    for rank, got in enumerate(_ranks(layout)[learning_rate]):
        coords = dict(zip(tmesh.AXES, np.unravel_index(rank, [full[a] for a in tmesh.AXES])))
        for k, dims in specs.items():
            ref = _shard(want[k], dims, full, coords)
            moved = np.abs(ref - _shard(params[k], dims, full, coords)).max()
            err = np.abs(got[k] - ref).max()
            assert moved > 1e-4, (k, moved)  # the updates are not all zero
            assert err <= 1e-6 * np.abs(want[k]).max(), (layout, k, err)


@pytest.mark.parametrize("case", ["dp2_fsdp2_adafactor", "dp2_pp2_adafactor"])
def test_sharded_adafactor_trainer_equals_one_process(case):
    check_case(case)
