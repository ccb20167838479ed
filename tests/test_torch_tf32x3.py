"""3xTF32, the arithmetic of the f32 tensor-core kernels
(``csrc/flash_fwd_tf32x3.cu``, ``csrc/flash_bwd_tf32x3.cu`` and
``csrc/vq.cu``), emulated on the CPU.

No kernel runs here, so this file holds the arithmetic the kernels use to
the JAX package's f32 results and to the f32 contracts that
``chip_smoke.py`` holds the kernels to on the card:
- ``cvt.rna.tf32.f32`` is the f32 bits rounded at bit 13, ties away from
  zero; an operand splits as hi = tf32(a), lo = tf32(a - hi), and a·b is
  lo·hi + hi·lo + hi·hi summed in f32 (tf32 products are exact in f32);
- (a) vq: the 3xTF32 ids equal the JAX routes (XLA, and Pallas in
  interpret mode) with exact duplicates; on the smoke test's Gaussian
  mixture at D = 1024 its distance error is a few percent of the near-tie
  margin, where one-pass TF32's passes half of it, and on the smoke test's
  planted near-ties 3xTF32 flips none where one-pass TF32 flips some;
- (b) flash: against the JAX flash forward (Pallas in interpret mode)
  3xTF32 out and lse lie within the f32 bounds (1e-4 max abs, 1e-4 norm
  ratio) and one-pass TF32 does not, so those checks reject a kernel that
  drops the lo terms;
- (c) the kernel's relabelled P·V (A column t4 holds key 2·t4, column
  t4 + 4 key 2·t4 + 1, V read in that order) equals the plain product, and
  a dropout hash given the relabelled key index in place of the true one
  drops keys with the same distribution but not ``_keep_mask``'s, which
  only the identity construction (v = I) shows;
- (d) the backward: against the JAX flash backward (Pallas in interpret
  mode) the 3xTF32 dq, dk and dv lie within the f32 gradient bounds (1e-3
  of max|ref|, 1e-4 norm ratio) and one-pass TF32's do not; the kernels'
  relabelled dS·K and P_v^T·dout equal the plain products; and a hash
  given the relabelled index in place of the true one breaks the identity
  checks (dout = I; k = v = I) while keeping the share of kept entries."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aat_tpu.ops.attention as jatt
import aat_tpu_torch.ops.attention as tatt
import chip_smoke
from aat_tpu.ops import vq as jvq
from test_torch_vq import codebook_case

MARGIN = 1e-4  # the near-tie margin of the vq checks, of max(1, |best|)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: round at bit 13, ties away from
    zero (adding half an ulp to the magnitude bits carries on a tie)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: the two small products first, in f32."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-pass TF32: both operands rounded, products in f32."""
    return tf32(a) @ tf32(b)


MATMULS = {"3xtf32": matmul_3xtf32, "tf32": matmul_tf32}


def test_tf32_rounding():
    """The rounding of ``cvt.rna``: 10 mantissa bits kept, to nearest, a tie
    away from zero; the split leaves only an exact remainder."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2 ** -23,
                      1.0 + 3 * one_ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp, 3.0])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(1).normal(0, 1, 4096).astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    rel = (hi.double() + lo.double() - r.double()).abs() / r.double().abs()
    assert float(rel.max()) < 2 ** -21


# -------------------------------------------------------------------- (a) vq


def nearest(x: torch.Tensor, codebook: torch.Tensor, matmul) -> torch.Tensor:
    """The vq kernel's ids with x·c taken by ``matmul``: argmin of
    cbn − 2·x·c in f32, the first (lowest) id on a tie."""
    cbn = (codebook ** 2).sum(-1)
    return torch.argmin(cbn[None, :] - 2.0 * matmul(x, codebook.t()), dim=-1)


@pytest.mark.parametrize("n,k,d", [(300, 700, 24), (256, 512, 16), (37, 9, 8)])
def test_vq_3xtf32_ids_equal_jax_routes(n, k, d):
    """``test_torch_vq.py``'s shapes and exact duplicates: the 3xTF32 ids
    equal the JAX XLA and Pallas (interpret mode) routes."""
    x, c = codebook_case(n + k, n, k, d)
    got = nearest(torch.from_numpy(x), torch.from_numpy(c), matmul_3xtf32).numpy()
    want_xla, _ = jvq.nearest_codebook(jnp.asarray(x), jnp.asarray(c))
    want_pallas, _ = jvq.nearest_codebook_pallas(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(got, np.asarray(want_xla))
    np.testing.assert_array_equal(got, np.asarray(want_pallas))
    assert np.all(got[:10] == 3)


@pytest.fixture(scope="module")
def mixture():
    """The smoke test's corpus construction at D = 1024 (on the CPU, at a
    smaller N): Gaussian-mixture rows and 1024 codes drawn from them."""
    x = chip_smoke.corpus_embeddings(torch, "cpu", 8192, 1024, seed=10)
    return x[:2048].clone(), chip_smoke.corpus_codebook(torch, x, 1024, seed=1024)


def test_vq_distance_error_against_the_near_tie_margin(mixture):
    """The distance error against f64, over all rows and codes, as a share
    of the median near-tie margin: 3xTF32 under 5%, one-pass TF32 over 50%
    (it would flip near-ties that the f32 contract resolves)."""
    x, cb = mixture
    c64 = cb.double()
    exact = (c64 ** 2).sum(-1)[None, :] - 2.0 * x.double() @ c64.t()
    margin = float((MARGIN * exact.min(1).values.abs().clamp_min(1.0)).median())
    cbn = (cb ** 2).sum(-1)
    share = {name: float((cbn[None, :] - 2.0 * mm(x, cb.t()) - exact).abs().max()) / margin
             for name, mm in MATMULS.items()}
    assert share["3xtf32"] < 0.05, share
    assert share["tf32"] > 0.5, share


def test_planted_near_ties_reject_one_pass_tf32(mixture):
    """``chip_smoke.planted_near_ties`` (a gap of ``NEAR_TIE_GAP`` margins
    between two codes of one centre): 3xTF32 and plain f32 give the f64
    argmin on every row, one-pass TF32 misses some (about one in ten), so
    phase 10's check can tell them apart. At gaps of 1.1 margins and more
    one-pass TF32 would flip almost none: its error in a gap spreads over
    about a third of a margin."""
    _, cb = mixture
    x, want = chip_smoke.planted_near_ties(torch, cb, 1024, seed=1025)
    matmuls = dict(MATMULS, f32=torch.matmul)
    wrong = {name: int((nearest(x, cb, mm) != want.long()).sum())
             for name, mm in matmuls.items()}
    assert wrong["3xtf32"] == 0 and wrong["f32"] == 0, wrong
    assert wrong["tf32"] > 1024 // 30, wrong
    # the error in the gap itself, in margins: one-pass TF32's spreads over
    # about a third of a margin, 3xTF32's and f32's stay within a fiftieth
    c64 = cb.double()
    exact = (c64 ** 2).sum(-1)[None, :] - 2.0 * x.double() @ c64.t()
    two = torch.topk(exact, 2, dim=1, largest=False)
    rows = torch.arange(len(want))
    second = two.indices[:, 1]
    margin = MARGIN * two.values[:, 0].abs().clamp_min(1.0)
    cbn = (cb ** 2).sum(-1)
    gap_err = {}
    for name, mm in matmuls.items():
        dist = (cbn[None, :] - 2.0 * mm(x, cb.t())).double()
        gap = dist[rows, second] - dist[rows, want.long()]
        gap_err[name] = (gap - (two.values[:, 1] - two.values[:, 0])) / margin
    assert 0.2 < float(gap_err["tf32"].std()) < 0.6, gap_err
    assert max(float(gap_err[n].abs().max()) for n in ("3xtf32", "f32")) < 0.05


# ----------------------------------------------------------------- (b) flash

# name: (causal, H, KVH, D)
FLASH_CASES = {"dense": (False, 4, 4, 64), "causal": (True, 4, 4, 64),
               "dense_gqa_d128": (False, 4, 2, 128), "causal_gqa_d128": (True, 4, 2, 128)}


def flash_case(seed, causal, h, kvh, d, t=300):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (1, t, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (1, t, kvh, d)).astype(np.float32)
    v = rng.normal(0, 1, (1, t, kvh, d)).astype(np.float32)
    mask = np.ones((1, t), np.int32)
    mask[:, t - t // 10:] = 0
    return q, k, v, mask


def emulated_forward(q, k, v, mask, causal, matmul):
    """The 3xTF32 kernel's forward with its products taken by ``matmul``:
    q·sm_scale in f32, masked scores at -2e30, the max floored at -1e30,
    unnormalised p, P·V, then the reciprocal of the floored sum. Returns
    out [B, T, H, D] and lse [B, H, T]."""
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    b, t, h, d = qt.shape
    kt, vt = tatt._repeat_kv(kt, vt, h, axis=2)
    qs = (qt * d ** -0.5).transpose(1, 2)
    scores = matmul(qs, kt.permute(0, 2, 3, 1))  # [B, H, T, S]
    allowed = tatt._allowed(torch.from_numpy(mask), t, kt.shape[1], causal, None)
    scores = torch.where(allowed, scores, torch.full_like(scores, tatt.MASK))
    m = scores.max(-1, keepdim=True).values.clamp_min(tatt.NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = matmul(p, vt.transpose(1, 2)) / l
    return out.transpose(1, 2).numpy(), (m + torch.log(l))[..., 0].numpy()


def jax_forward(q, k, v, mask, causal):
    """The JAX flash forward (Pallas in interpret mode): out [B, T, H, D],
    lse [B, H, T]."""
    qj, kj, vj = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    b, t, h, d = q.shape
    out, lse, _ = jatt._flash_forward(qj, kj, vj, jnp.asarray(mask), causal, d ** -0.5)
    return (np.asarray(out).transpose(0, 2, 1, 3),
            np.asarray(lse)[:, :t, 0].reshape(b, h, t))


@pytest.fixture(scope="module")
def flash_results():
    """{case: (jax out, jax lse, {matmul: (out, lse)})}, one JAX run per case."""
    results = {}
    for seed, (name, (causal, h, kvh, d)) in enumerate(FLASH_CASES.items()):
        q, k, v, mask = flash_case(seed, causal, h, kvh, d)
        results[name] = (*jax_forward(q, k, v, mask, causal),
                         {mm: emulated_forward(q, k, v, mask, causal, fn)
                          for mm, fn in MATMULS.items()})
    return results


def f32_errors(out, lse, ref_out, ref_lse):
    """Phase 4's f32 readings: out's max abs error and norm ratio, and lse's
    max abs error on live rows."""
    diff = out.astype(np.float64) - ref_out
    live = ref_lse > -1e29
    return (float(np.abs(diff).max()), float(np.linalg.norm(diff) / np.linalg.norm(ref_out)),
            float(np.abs(lse - ref_lse)[live].max()))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_3xtf32_within_the_f32_bounds(flash_results, case):
    ref_out, ref_lse, emulated = flash_results[case]
    errs = f32_errors(*emulated["3xtf32"], ref_out, ref_lse)
    assert max(errs) <= chip_smoke.FLASH_TOL["float32"], errs
    assert errs[1] <= chip_smoke.FLASH_REL_TOL["float32"], errs


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_one_pass_tf32_fails_the_f32_bounds(flash_results, case):
    """A kernel that drops the lo terms is caught by the same checks."""
    ref_out, ref_lse, emulated = flash_results[case]
    max_err, ratio, lse_err = f32_errors(*emulated["tf32"], ref_out, ref_lse)
    assert (max_err > chip_smoke.FLASH_TOL["float32"]
            or ratio > chip_smoke.FLASH_REL_TOL["float32"]
            or lse_err > chip_smoke.FLASH_TOL["float32"]), (max_err, ratio, lse_err)


# ---------------------------------------------------- (c) the relabelled P·V


def relabel(n_keys):
    """Key of each A column in the kernel's P·V: within each k-step of 8
    keys, column t4 holds key 2·t4 and column t4 + 4 key 2·t4 + 1."""
    c = np.arange(n_keys)
    within = c % 8
    return c - within + np.where(within < 4, 2 * within, 2 * (within - 4) + 1)


def test_relabelled_pv_equals_the_plain_product():
    """Columns of P and rows of V in the same relabelled order: the product
    is the plain one up to the order of the f32 sums."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.uniform(0, 1, (64, 128)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (128, 64)).astype(np.float32))
    perm = torch.from_numpy(relabel(128))
    assert sorted(perm.tolist()) == list(range(128))
    got = matmul_3xtf32(p[:, perm], v[perm])
    exact = p.double() @ v.double()
    scale = p.double() @ v.double().abs()
    assert float(((got.double() - exact).abs() / scale).max()) < 1e-6
    assert torch.allclose(got, matmul_3xtf32(p, v), rtol=0, atol=1e-5)


def identity_forward(q, k, rate, seed, hash_key):
    """The kernel's dropped, normalised P·V with v = I (S = D keys), the
    keep test given the true key of each A column (``hash_key`` "true") or
    its relabelled position ("relabelled")."""
    b, t, h, s = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q * s ** -0.5, k)
    p = torch.exp(scores - scores.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    perm = torch.from_numpy(relabel(s))
    keep = tatt._keep_mask(seed, b, h, t, s, rate, q.device)  # [B, H, T, S] by key
    a = p[..., perm]  # A columns in the relabelled order
    a = torch.where(keep[..., perm if hash_key == "true" else torch.arange(s)],
                    a / (1.0 - rate), torch.zeros_like(a))
    eye = torch.eye(s)
    return matmul_3xtf32(a, eye[perm]) / l  # [B, H, T, S]


def test_a_relabelled_hash_index_breaks_only_the_identity_check():
    """With the true key the zeros of out (v = I) are ``_keep_mask``'s;
    with the relabelled position they keep the same share of the keys but
    differ from it on many positions."""
    rng = np.random.default_rng(3)
    b, t, h, s, rate, seed = 2, 24, 2, 16, 0.5, 97531
    q = torch.from_numpy(rng.normal(0, 1, (b, t, h, s)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (b, s, h, s)).astype(np.float32))
    keep = tatt._keep_mask(seed, b, h, t, s, rate, "cpu")
    right = identity_forward(q, k, rate, seed, "true") != 0
    wrong = identity_forward(q, k, rate, seed, "relabelled") != 0
    assert torch.equal(right, keep)
    assert int((wrong != keep).sum()) > keep.numel() // 8
    assert abs(float(wrong.float().mean()) - float(keep.float().mean())) < 0.05
    ref = tatt.reference_attention_bthd(q, k, torch.eye(s)[None, :, None, :].expand(b, s, h, s),
                                        torch.ones((b, s), dtype=torch.int32), None, False,
                                        rate, seed)
    assert torch.equal((ref != 0).permute(0, 2, 1, 3), keep)


# ------------------------------------------------------------- (d) backward

BWD_DROPOUT = (0.1, 24680)  # rate, seed


def emulated_backward(q, k, v, mask, out, lse, dout, causal, matmul, rate, seed):
    """The 3xTF32 backward kernels with their products taken by ``matmul``:
    q_s = q·sm_scale in f32, masked scores at -2e30, p = exp(s - lse), dp
    and p_v dropped and scaled by the keep mask, delta = rowsum(dout·out),
    ds = p·(dp - delta); dq = (ds·k)·sm_scale, dk = ds^T·q_s and dv =
    p_v^T·dout per q-head, summed over the heads that share a kv head.
    Operands [B, T, H, D] (k, v [B, S, KVH, D]) and lse [B, H, T]."""
    qt, kt, vt, ot, dt = (torch.from_numpy(x) for x in (q, k, v, out, dout))
    b, t, h, d = qt.shape
    s, kvh = kt.shape[1], kt.shape[2]
    scale = d ** -0.5
    kr, vr = tatt._repeat_kv(kt, vt, h, axis=2)
    qs = (qt * scale).transpose(1, 2)  # [B, H, T, D]
    kh, vh, doh = kr.transpose(1, 2), vr.transpose(1, 2), dt.transpose(1, 2)
    scores = matmul(qs, kh.transpose(-1, -2))
    allowed = tatt._allowed(torch.from_numpy(mask), t, s, causal, None)
    scores = torch.where(allowed, scores, torch.full_like(scores, tatt.MASK))
    p = torch.exp(scores - torch.from_numpy(lse)[..., None])
    dp = matmul(doh, vh.transpose(-1, -2))
    keep = tatt._keep_mask(seed, b, h, t, s, rate, "cpu")
    p_v = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    dp = torch.where(keep, dp / (1.0 - rate), torch.zeros_like(dp))
    delta = (dt * ot).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    dq = (matmul(ds, kh) * scale).transpose(1, 2)
    dk = matmul(ds.transpose(-1, -2), qs).transpose(1, 2)
    dv = matmul(p_v.transpose(-1, -2), doh).transpose(1, 2)
    rep = h // kvh
    dk, dv = (x.reshape(b, s, kvh, rep, d).sum(3) for x in (dk, dv))
    return tuple(x.numpy() for x in (dq, dk, dv))


@pytest.fixture(scope="module")
def backward_results():
    """{case: (jax (dq, dk, dv), {matmul: (dq, dk, dv)})}: the JAX flash
    forward and backward (Pallas in interpret mode) with dropout, and the
    emulated kernels fed JAX's out and lse."""
    rate, seed = BWD_DROPOUT
    results = {}
    for n, (name, (causal, h, kvh, d)) in enumerate(FLASH_CASES.items()):
        q, k, v, mask = flash_case(10 + n, causal, h, kvh, d)
        dout = np.random.default_rng(20 + n).normal(0, 1, q.shape).astype(np.float32)
        qj, kj, vj, dj = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v, dout))
        maskj = jnp.asarray(mask)
        b, t = q.shape[:2]
        out_j, lse_j, _ = jatt._flash_forward(qj, kj, vj, maskj, causal, d ** -0.5,
                                              dropout_rate=rate, dropout_seed=jnp.int32(seed))
        grads = jatt._flash_backward(qj, kj, vj, maskj, out_j, lse_j, causal, d ** -0.5, dj,
                                     dropout_rate=rate, dropout_seed=jnp.int32(seed))
        want = tuple(np.asarray(x).transpose(0, 2, 1, 3) for x in grads)
        out = np.array(out_j).transpose(0, 2, 1, 3).copy()
        lse = np.array(lse_j)[:, :t, 0].reshape(b, h, t)
        results[name] = (want, {mm: emulated_backward(q, k, v, mask, out, lse, dout, causal, fn,
                                                      rate, seed)
                                for mm, fn in MATMULS.items()})
    return results


def grad_errors(got, want):
    """Phase 7's readings of each of dq, dk, dv: max abs error over max|ref|
    and the norm ratio."""
    return [(float(np.abs(g - w).max() / np.abs(w).max()),
             float(np.linalg.norm(g.astype(np.float64) - w) / np.linalg.norm(w)))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_backward_3xtf32_within_the_f32_bounds(backward_results, case):
    want, emulated = backward_results[case]
    for rel, ratio in grad_errors(emulated["3xtf32"], want):
        assert rel <= chip_smoke.GRAD_REL_TOL["float32"], (rel, ratio)
        assert ratio <= chip_smoke.GRAD_NORM_TOL["float32"], (rel, ratio)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_backward_one_pass_tf32_fails_the_f32_bounds(backward_results, case):
    """A backward that drops the lo terms is caught by the same checks: at
    least one of dq, dk and dv leaves the norm-ratio bound."""
    want, emulated = backward_results[case]
    errs = grad_errors(emulated["tf32"], want)
    assert any(rel > chip_smoke.GRAD_REL_TOL["float32"]
               or ratio > chip_smoke.GRAD_NORM_TOL["float32"] for rel, ratio in errs), errs


@pytest.mark.parametrize("product", ["dS·K", "P_v^T·dout"])
def test_relabelled_backward_products_equal_the_plain_products(product):
    """dq's dS·K (A columns keys) and dk/dv's P_v^T·dout (A columns
    queries): the columns of A and the rows of B in the kernels' relabelled
    order give the plain product up to the order of the f32 sums."""
    rng = np.random.default_rng(4 if product == "dS·K" else 5)
    rows, inner, cols = (16, 32, 64) if product == "dS·K" else (16, 32, 128)
    x = rng.normal(0, 1, (rows, inner)) if product == "dS·K" else rng.uniform(0, 1, (rows, inner))
    a = torch.from_numpy(x.astype(np.float32))
    bm = torch.from_numpy(rng.normal(0, 1, (inner, cols)).astype(np.float32))
    perm = torch.from_numpy(relabel(inner))
    got = matmul_3xtf32(a[:, perm], bm[perm])
    exact = a.double() @ bm.double()
    scale = a.double().abs() @ bm.double().abs()
    assert float(((got.double() - exact).abs() / scale).max()) < 1e-6
    assert torch.allclose(got, matmul_3xtf32(a, bm), rtol=0, atol=1e-5)


def identity_backward(p, keep, rate, transposed, hash_index):
    """The zeros of the backward identity constructions as the kernels take
    them. ``transposed`` (dk/dv: dout = I, so dv = p_v^T): rows are keys and
    the relabelled A columns queries; else (dq: k = v = I, out = 0, so dq
    is sm_scale·ds): rows are queries and the columns keys. The keep test
    takes each A column's true index (``hash_index`` "true") or its
    relabelled position ("relabelled"). Returns the nonzeros, oriented as
    ``keep`` [B, H, T, S]."""
    x = p.transpose(-1, -2) if transposed else p
    kept = keep.transpose(-1, -2) if transposed else keep
    n = x.shape[-1]
    perm = torch.from_numpy(relabel(n))
    a = x[..., perm]
    test = kept[..., perm] if hash_index == "true" else kept
    a = torch.where(test, a / (1.0 - rate), torch.zeros_like(a))
    got = matmul_3xtf32(a, torch.eye(n)[perm]) != 0
    return got.transpose(-1, -2) if transposed else got


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_a_relabelled_backward_hash_breaks_only_the_identity_check(kernel):
    """With the true index the zeros are ``_keep_mask``'s; with the
    relabelled position they keep the same share of entries but differ
    from it on many positions."""
    rng = np.random.default_rng(6)
    b, h, t, s, rate, seed = 2, 2, 24, 16, 0.5, 13579
    if kernel == "dkv":
        t, s = s, t  # T = D queries against more keys
    p = torch.from_numpy(rng.uniform(0.01, 1.0, (b, h, t, s)).astype(np.float32))
    keep = tatt._keep_mask(seed, b, h, t, s, rate, "cpu")
    transposed = kernel == "dkv"
    right = identity_backward(p, keep, rate, transposed, "true")
    wrong = identity_backward(p, keep, rate, transposed, "relabelled")
    assert torch.equal(right, keep)
    assert int((wrong != keep).sum()) > keep.numel() // 8
    assert abs(float(wrong.float().mean()) - float(keep.float().mean())) < 0.05
