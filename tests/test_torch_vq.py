"""Port VQ (``aat_tpu_torch.ops.vq``) vs the JAX package's ``ops/vq.py``:
nearest-codebook ids against the XLA route and the Pallas kernel (in
interpret mode) with ragged tiles and duplicate codes, the straight-through
forward and its gradients, EMA k-means steps, the seeded init, the state
bridge, and the quantize command line against ``scripts/quantize_embeddings.py``
run as a subprocess."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aat_tpu.ops import vq as jvq
from aat_tpu_torch.ops import vq as tvq
from aat_tpu_torch.scripts import quantize_embeddings as tquant
from aat_tpu_torch.utils.port import vq_state_from_jax, vq_state_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_ids_agree(got, want, x, codebook):
    """Ids equal where the reference's best-to-second distance gap exceeds
    1e-4·max(1, |best|); on every row the chosen code's distance within that
    margin of the best (two f32 GEMMs sum in other orders, so a near-tie may
    resolve either way)."""
    x64, c64 = x.astype(np.float64), codebook.astype(np.float64)
    dist = (c64 ** 2).sum(-1)[None, :] - 2.0 * x64 @ c64.T
    order = np.sort(dist, axis=1)
    margin = 1e-4 * np.maximum(1.0, np.abs(order[:, 0]))
    clear = order[:, 1] - order[:, 0] > margin
    np.testing.assert_array_equal(got[clear], want[clear])
    chosen = dist[np.arange(len(got)), got]
    assert np.all(chosen <= order[:, 0] + margin)


def codebook_case(seed, n, k, d):
    """Gaussian data and codes, with exact duplicate codes and rows sitting
    on them (exact ties, which go to the lowest id)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    c = rng.normal(0, 1, (k, d)).astype(np.float32)
    dups = min(40, k // 4)
    c[k - dups:] = c[3]
    c[k // 2 : k // 2 + min(5, dups)] = c[1]
    x[:10] = c[3]
    x[10:20] = c[1] + rng.normal(0, 1e-2, (10, d)).astype(np.float32)
    return x, c


@pytest.mark.parametrize("n,k,d", [(300, 700, 24), (256, 512, 16), (37, 9, 8)])
def test_nearest_codebook_matches_jax_routes(n, k, d):
    """N not a multiple of the TPU's 256-row tile, K not a multiple of its
    512-code tile (an overhanging tile), and duplicate codes."""
    x, c = codebook_case(n + k, n, k, d)
    want_xla, want_q = jvq.nearest_codebook(jnp.asarray(x), jnp.asarray(c))
    want_pallas, _ = jvq.nearest_codebook_pallas(jnp.asarray(x), jnp.asarray(c))
    got, got_q = tvq.nearest_codebook(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.all(got.numpy()[:10] == 3)  # duplicates of code 3: the lowest id


def test_plain_route_only_on_cpu():
    """The dispatch takes the plain version for a CPU tensor; the kernel
    wrapper refuses one."""
    x, c = codebook_case(0, 20, 8, 4)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    cbn = tvq.codebook_norms(ct)
    before = tvq.nearest_codebook_kernel.launches
    np.testing.assert_array_equal(tvq.nearest_codebook(xt, ct)[0].numpy(),
                                  tvq.nearest_codebook_reference(xt, ct, cbn).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tvq.nearest_codebook_kernel(xt, ct, cbn)
    assert tvq.nearest_codebook_kernel.launches == before


def test_vq_forward_values_and_gradients_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (40, 12)).astype(np.float32)
    c = rng.normal(0, 1, (16, 12)).astype(np.float32)
    state = jvq.VQState(jnp.asarray(c), jnp.ones((16,)), jnp.asarray(c))

    def loss_j(xj, cj, w):
        st, _, loss = jvq.vq_forward(state._replace(codebook=cj), xj, beta=0.3)
        return loss + jnp.sum(st * w)

    w = rng.normal(0, 1, (40, 12)).astype(np.float32)
    st_j, idx_j, l_j = jvq.vq_forward(state, jnp.asarray(x), beta=0.3)
    gx_j, gc_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(c), jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    tstate = tvq.VQState(ct, torch.ones(16), ct.detach().clone())
    st_t, idx_t, l_t = tvq.vq_forward(tstate, xt, beta=0.3)
    (l_t + (st_t * torch.from_numpy(w)).sum()).backward()
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(st_t.detach().numpy(), np.asarray(st_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(l_t.item(), float(l_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc_j), atol=1e-6, rtol=0)
    assert np.abs(ct.grad.numpy()).max() > 0  # the codebook gets a gradient


def test_ema_iterations_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 1, (200, 8)) + rng.integers(0, 4, (200, 1)) * 3).astype(np.float32)
    js = jvq.init_vq_state(jax.random.PRNGKey(2), 12, 8)
    ts = vq_state_from_jax(js)
    for _ in range(5):
        jidx, _ = jvq.nearest_codebook(jnp.asarray(x), js.codebook)
        js = jvq.vq_ema_update(js, jnp.asarray(x), jidx, decay=0.9)
        tidx, _ = tvq.nearest_codebook(torch.from_numpy(x), ts.codebook)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        ts = tvq.vq_ema_update(ts, torch.from_numpy(x), tidx, decay=0.9)
        for a, b in zip(vq_state_to_jax(ts), js):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", [5, (0, 0), (0, 7)])
def test_init_vq_state_draws_equal_jax(seed):
    key = seed if isinstance(seed, int) else jax.random.PRNGKey(seed[1])
    if not isinstance(seed, int):
        assert tuple(int(v) for v in np.asarray(jax.random.key_data(key))) == seed
    want = jvq.init_vq_state(key, 10, 6)
    got = tvq.init_vq_state(seed, 10, 6)
    for a, b in zip(vq_state_to_jax(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = vq_state_from_jax(jax.device_get(want))
    for a, b in zip(back, got):
        assert torch.equal(a, b)


def write_embeddings(directory, seed, sizes, dim=16):
    rng = np.random.default_rng(seed)
    os.makedirs(directory)
    for i, s in enumerate(sizes):
        centers = rng.normal(0, 2, (3, dim))
        x = centers[rng.integers(0, 3, s)] + rng.normal(0, 0.5, (s, dim))
        np.save(os.path.join(directory, f"utt{i}.npy"), x[None].astype(np.float32))


@pytest.mark.parametrize("codes,sizes", [(8, (30, 24, 41)), (24, (5, 6, 7))])
def test_quantize_cli_matches_jax_script(tmp_path, codes, sizes):
    """Same directory through both command lines. (24, ...): fewer
    embeddings than codes, so the codebook is padded with copies of row 0;
    the EMA then moves the copies by an ulp or two, and the near-ties among
    them may resolve either way (the rule of :func:`assert_ids_agree`)."""
    emb = str(tmp_path / "emb")
    write_embeddings(emb, codes, sizes)
    args = ["--embeddings", emb, "--codes", str(codes), "--iters", "12", "--decay", "0.8"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", AAT_TPU_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "quantize_embeddings.py"),
                           *args, "--out", str(tmp_path / "jax")], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tquant.main([*args, "--out", str(tmp_path / "port")], device="cpu")
    want_cb = np.load(tmp_path / "jax" / "codebook.npy")
    got_cb = np.load(tmp_path / "port" / "codebook.npy")
    np.testing.assert_allclose(got_cb, want_cb, atol=1e-5, rtol=0)
    for i in range(len(sizes)):
        name = f"utt{i}.tokens.npy"
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.dtype == np.int32 and got.shape == want.shape
        if sum(sizes) >= codes:
            np.testing.assert_array_equal(got, want)
        else:
            x = np.load(os.path.join(emb, f"utt{i}.npy"))[0]
            assert_ids_agree(got, want, x, want_cb)


def test_quantize_cli_needs_a_gpu_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tquant.main(["--embeddings", str(tmp_path), "--out", str(tmp_path / "o")])
