"""Port ``AATTrainer`` vs the JAX package's with bf16 compute over f32
masters (the default training config's precision), 3 whole-utterance
steps at tiny widths, the port on its flash route and JAX on its XLA
attention (``tests/_torch_trajectories.py``)."""

import numpy as np

import jax

from tests._torch_trajectories import flash_route, jax_params, models, run_both, whole_batch
from tests._torch_threads import two_threads  # noqa: F401


def test_bf16_compute_trajectory_close_to_jax(monkeypatch):
    """bf16 compute: both packages round weights, activations and
    probabilities to bf16 at the same points but sum in other orders. The
    stated bar: losses within 1e-2 relative, and the 3-step weight updates
    of the trained parts pointing the same way (cosine >= 0.9). Adam moves
    each weight by about lr whatever its gradient's size, so weights whose
    gradients are near zero may step either way in either package; an
    elementwise bound would be about 2 lr per step and say little."""
    flash_route(monkeypatch)
    r = run_both(whole_batch, seed=1, compute_dtype="bfloat16")
    losses, (jparams, tparams) = r.losses, r.params[-1]
    for lj, lt in losses:
        assert abs(lj - lt) <= 1e-2 * abs(lj), (lj, lt)
    init = jax.device_get(jax_params(models()[0]))
    for part in ("audio_encoder", "adapter"):
        dj, dt = [np.concatenate([(np.asarray(x) - np.asarray(x0)).ravel() for x, x0 in
                                  zip(jax.tree.leaves(p[part]), jax.tree.leaves(init[part]))])
                  for p in (jparams, tparams)]
        cos = float(dj @ dt / (np.linalg.norm(dj) * np.linalg.norm(dt)))
        assert cos >= 0.9, (part, cos)
    for b in jax.tree.leaves(tparams):
        assert b.dtype == np.float32  # the masters stay f32
    for a, b in zip(jax.tree.leaves(init["lm_decoder"]), jax.tree.leaves(tparams["lm_decoder"])):
        np.testing.assert_array_equal(b, np.asarray(a))  # the frozen LM never moves
