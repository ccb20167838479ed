"""The fused guarded AdamW's in-place step (``GradientTransformation.step``
of ``training/optim.fused_guarded_adamw``) and its two C entries
(``csrc/adamw.cu``: ``aat_adamw_sumsq``, ``aat_adamw_update``).

On the CPU the step is the plain route, ``g / n`` then ``update`` then
``apply_updates``, bit for bit. The kernel route is reached with a library
that records the C entries (on the meta device, and on host memory with
the route's device test patched): its leaf table, constants and scalar
pointers, and, run by :class:`EmulatedLibrary` in numpy float32 op for op
as the kernels compute, the plain route's bits over steps with a NaN step
and a clip. The ``card`` tests hold the kernels to the plain route on an
NVIDIA GPU at the benchmark cells' leaf set (``chip_smoke.adamw_*``);
this file imports nothing of JAX, so on the card

    python -m pytest tests/test_torch_adamw_kernel.py --noconftest -m card -p no:cacheprovider
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from _recording_library import RecordingLibrary, meta_library  # noqa: F401  (the fixture)
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.runtime import kernels
from aat_tpu_torch.training import optim
from aat_tpu_torch.training.config import TrainingConfig
from aat_tpu_torch.training.lr_schedule import warmup_linear_schedule
from aat_tpu_torch.training.trainer import AATTrainer

F32 = np.float32
NAN_STEP = 2


def small_tree(seed=0, device="cpu"):
    """Decay and no-decay leaves (kernels, biases, a norm scale), an odd
    size (a vector tail), and a frozen subtree."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32)).to(device)

    return {"audio_encoder": {"layers": [{"kernel": leaf(8, 6), "bias": leaf(6)},
                                         {"kernel": leaf(6, 7), "bias": leaf(7)}],
                              "norm": {"scale": leaf(7)}},
            "adapter": {"kernel": leaf(7, 5), "bias": leaf(5)},
            "lm_decoder": {"embedding": leaf(9, 5)}}


def gradient_sums(params, freeze, step, seed=1):
    """Gradients summed over microbatches (None on frozen leaves); one NaN
    at ``NAN_STEP``."""
    rng = np.random.default_rng([seed, step])
    grads = optim.tree_map(
        lambda p, t: torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)).to(
            p.device) if t else None, params, freeze)
    if step == NAN_STEP:
        grads["adapter"]["kernel"][1, 2] = float("nan")
    return grads


def clone(tree):
    return optim.tree_map(lambda x: None if x is None else x.clone(), tree)


def bits(x):
    return x.view(torch.int32)


def assert_trees_bitwise(a, b):
    for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))


def assert_states_bitwise(a, b):
    assert torch.equal(a.count, b.count) and a.count.dtype == b.count.dtype
    assert torch.equal(a.total_notfinite, b.total_notfinite)
    assert_trees_bitwise(a.mu, b.mu)
    assert_trees_bitwise(a.nu, b.nu)


def transformation(params, freeze, clip=None, norm=optim.global_norm):
    schedule = warmup_linear_schedule(1e-2, 2, 20)
    return optim.fused_guarded_adamw(schedule, params, weight_decay=0.1, clip_norm=clip,
                                     freeze=freeze, norm=norm)


def old_step(tx):
    """The trainer's optimizer step as it was written before the in-place
    step: ``g / n``, ``tx.update``, ``apply_updates``."""

    def step(grads, n, state, params):
        if n > 1:
            grads = optim.tree_map(lambda g: None if g is None else g / n, grads)
        updates, state = tx.update(grads, state, params)
        optim.apply_updates(params, updates)
        return state

    return step


@pytest.mark.parametrize("clip", [None, 0.05])
def test_cpu_step_equals_update_and_apply(clip):
    """Five steps (the third with a NaN) of ``step`` on CPU leaves against
    ``g / n``, ``update`` and ``apply_updates``: params, moments, count and
    total_notfinite bit for bit; the frozen subtree untouched and
    stateless; with the clip, the clip binds."""
    params = small_tree()
    freeze = optim.trainable_mask(params)
    tx = transformation(params, freeze, clip)
    ref_params = clone(params)
    frozen = clone(params["lm_decoder"])
    state, ref_state = tx.init(params), tx.init(ref_params)
    for step in range(5):
        grads = gradient_sums(params, freeze, step)
        if clip is not None and step != NAN_STEP:
            assert float(optim.global_norm(grads)) / 2 > clip
        state = tx.step(grads, 2, state, params)
        ref_state = old_step(tx)(grads, 2, ref_state, ref_params)
        assert_trees_bitwise(params, ref_params)
        assert_states_bitwise(state, ref_state)
    assert int(state.count) == 4 and float(state.total_notfinite) == 1.0
    assert state.mu["lm_decoder"]["embedding"] is None
    assert state.nu["lm_decoder"]["embedding"] is None
    assert_trees_bitwise(params["lm_decoder"], frozen)


def f32_at(address, n):
    """A float32 numpy view of ``n`` values at a host address."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(address)) if n else \
        np.zeros(0, F32)


def sqrt(x):
    """The square root the plain route takes here: torch's f32 ``sqrt`` on
    the CPU is not always correctly rounded (one ulp off numpy's for about
    one value in 40 of these trees), where on CUDA it is, as the kernel's
    ``__fsqrt_rn``. The card's check holds that rounding; this file the
    order of the operations."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x, F32))).numpy()


class EmulatedLibrary(RecordingLibrary):
    """Records the C entries, reads at call time what their scalar pointers
    point at, and runs the adamw entries on host memory: numpy float32, op
    for op as ``csrc/adamw.cu`` computes (the norm's sum in another order,
    the square root as :func:`sqrt`)."""

    def __init__(self):
        super().__init__()
        self.tables, self.scalars = [], []

    def call(self, name, *args):
        super().call(name, *args)
        getattr(self, name[len("aat_adamw_"):])(*args)

    def sumsq(self, g, numel, n_leaves, inv_n, partials, n_partials, stream):
        total = F32(0.0)
        for i in range(n_leaves):
            x = f32_at(g[i], numel[i]) * F32(inv_n)
            total = F32(total + np.sum(x * x, dtype=F32))
        out = f32_at(partials, n_partials)
        out[:] = 0.0
        out[0] = total

    def update(self, g, p, m, v, numel, decay, n_leaves, inv_n, partials, n_partials, gn_at,
               neg_lr, bc1, bc2, b1, b2, c1, c2, eps, wd, has_clip, clip, stream):
        self.tables.append({"g": list(g), "p": list(p), "m": list(m), "v": list(v),
                            "numel": list(numel), "decay": list(decay), "n_leaves": n_leaves,
                            "inv_n": inv_n, "n_partials": n_partials})
        scalars = [f32_at(x, 1)[0] for x in (neg_lr, bc1, bc2)]
        self.scalars.append(scalars)
        neg_lr, bc1, bc2 = scalars
        gn_cell = f32_at(gn_at, 1)
        if n_partials > 0:
            gn_cell[:] = sqrt(np.sum(f32_at(partials, n_partials), dtype=F32, keepdims=True))
        gn = gn_cell[0]
        if not np.isfinite(gn):
            return
        scale = (F32(1.0) / gn) * F32(clip) if has_clip and not gn < F32(clip) else F32(1.0)
        for i in range(n_leaves):
            gi, pi, mi, vi = (f32_at(x[i], numel[i]) for x in (g, p, m, v))
            gs = (gi * F32(inv_n)) * scale
            mi[:] = F32(c1) * gs + F32(b1) * mi
            vi[:] = F32(c2) * (gs * gs) + F32(b2) * vi
            d = (mi / bc1) / (sqrt(vi / bc2) + F32(eps))
            if decay[i]:
                d = d + F32(wd) * pi
            pi[:] = pi + neg_lr * d


def emulate_kernels(monkeypatch) -> EmulatedLibrary:
    """The kernel route on host memory: CPU leaves taken for card leaves,
    the adamw entries run by :class:`EmulatedLibrary`."""
    lib = EmulatedLibrary()
    monkeypatch.setattr(optim, "_plain_device", lambda x: False)
    monkeypatch.setattr(kernels, "check_cuda", lambda x, kernel: None)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: ("stream", device))
    monkeypatch.setattr(torch.cuda, "device", lib.device_guard)
    return lib


@pytest.fixture
def emulated(monkeypatch):
    return emulate_kernels(monkeypatch)


@pytest.mark.parametrize("clip, given_norm", [(None, False), (None, True), (0.05, True)])
def test_kernel_arithmetic_equals_plain_route(emulated, clip, given_norm):
    """The kernel route, its C entries run in numpy float32 on the leaves'
    memory, against the plain route over 5 steps with a NaN step, n = 2 (the
    cells'; 1/n exact): p, m, v, count and total_notfinite bit for bit. With
    a clip both routes take the same norm (``given_norm``: a norm other than
    ``global_norm``, as a mesh's, which the update entry reads instead of
    summing), so the kernel's scale, torch's reciprocal(gn)·clip, is held
    bit for bit. Without ``given_norm`` the sum entry runs each step."""
    params = small_tree()
    freeze = optim.trainable_mask(params)
    norm = (lambda tree: optim.global_norm(tree)) if given_norm else optim.global_norm
    tx = transformation(params, freeze, clip, norm)
    ref_params = clone(params)
    state, ref_state = tx.init(params), tx.init(ref_params)
    for step in range(5):
        grads = gradient_sums(params, freeze, step)
        mu, nu = state.mu, state.nu
        state = tx.step(grads, 2, state, params)
        assert state.mu is mu and state.nu is nu  # the same trees, updated in place
        ref_state = optim.plain_step(tx.update, grads, 2, ref_state, ref_params)
        assert_trees_bitwise(params, ref_params)
        assert_states_bitwise(state, ref_state)
    want = ["aat_adamw_update"] * 5 if given_norm else ["aat_adamw_sumsq", "aat_adamw_update"] * 5
    assert emulated.names == want
    assert all(t["n_partials"] == (0 if given_norm else optim._SUMSQ_BLOCKS)
               for t in emulated.tables)
    assert int(state.count) == 4 and float(state.total_notfinite) == 1.0


def test_kernel_leaf_table_and_scalars(emulated):
    """The update entry's leaf table (the trainable leaves in tree order:
    their gradients', parameters' and moments' addresses, sizes and decay
    flags), ``inv_n``, the hyper-parameters as float32, and its scalar
    pointers at -lr(count), 1 - b1^(count+1) and 1 - b2^(count+1); the
    parameters' part built once while the leaves stay, the gradients' each
    step."""
    params = small_tree()
    freeze = optim.trainable_mask(params)
    tx = transformation(params, freeze, clip=0.5)
    state = tx.init(params)
    trainable = [p for p, t in zip(optim.tree_leaves(params), optim.tree_leaves(freeze)) if t]
    decay = [d for d, t in zip(optim.tree_leaves(optim.decay_mask(params)),
                               optim.tree_leaves(freeze)) if t]
    assert decay == [True, False, True, False, False, True, False]
    for step in range(2):
        grads = gradient_sums(params, freeze, step)
        state = tx.step(grads, 4, state, params)
        table = emulated.tables[-1]
        assert table["n_leaves"] == len(trainable) == 7
        assert table["g"] == [g.data_ptr() for g in optim.tree_leaves(grads) if g is not None]
        assert table["p"] == [p.data_ptr() for p in trainable]
        assert table["m"] == [m.data_ptr() for m in optim.tree_leaves(state.mu) if m is not None]
        assert table["v"] == [v.data_ptr() for v in optim.tree_leaves(state.nu) if v is not None]
        assert table["numel"] == [p.numel() for p in trainable]
        assert table["decay"] == [int(d) for d in decay]
        assert table["inv_n"] == 0.25
        count = torch.tensor(step, dtype=torch.int32)
        lr = warmup_linear_schedule(1e-2, 2, 20)(count)
        bc1, bc2 = optim._bias_corrections(0.9, 0.999, count + 1)
        assert emulated.scalars[-1] == [-lr.numpy(), bc1.numpy(), bc2.numpy()]
    args = emulated.args[-1]
    assert args[14:22] == tuple(float(F32(x)) for x in (0.9, 0.999, 1 - 0.9, 1 - 0.999, 1e-8,
                                                        0.1)) + (1, float(F32(0.5)))


def test_card_tree_reaches_both_entries(meta_library):
    """A tree on a device other than the CPU (meta stands in for the card)
    goes to ``aat_adamw_sumsq`` then ``aat_adamw_update``, once each, with
    its leaf table, on the leaves' device; the counter
    ``optim.fused_leaves`` counts the leaves."""
    from aat_tpu_torch.utils import timing

    params = small_tree(device="meta")
    freeze = optim.trainable_mask(params)
    tx = transformation(params, freeze)
    state = tx.init(params)
    grads = optim.tree_map(lambda p, t: torch.empty_like(p) if t else None, params, freeze)
    before = timing.counters().get("optim.fused_leaves", 0)
    state = tx.step(grads, 2, state, params)
    assert meta_library.names == ["aat_adamw_sumsq", "aat_adamw_update"]
    assert meta_library.devices == [torch.device("meta")] * 2
    sumsq, update = meta_library.args
    assert list(sumsq[1]) == list(update[4]) == [48, 6, 42, 7, 7, 35, 5]
    assert sumsq[2:4] == (7, 0.5) and sumsq[5] == optim._SUMSQ_BLOCKS
    assert list(update[5]) == [1, 0, 1, 0, 0, 1, 0] and update[6:8] == (7, 0.5)
    assert update[-3:-1] == (0, 0.0)  # no clip
    assert timing.counters()["optim.fused_leaves"] - before == 7
    assert state.count.device.type == "meta"


def test_cpu_tree_launches_nothing(meta_library):
    params = small_tree()
    freeze = optim.trainable_mask(params)
    tx = transformation(params, freeze)
    tx.step(gradient_sums(params, freeze, 0), 2, tx.init(params), params)
    assert meta_library.names == []


@pytest.mark.parametrize("fault", ["transposed_grad", "float64_param"])
def test_kernel_route_refuses_what_the_kernel_does_not_take(meta_library, fault):
    """A non-contiguous gradient or a float64 leaf raises before any launch:
    the kernel route has no fallback."""
    params = small_tree(device="meta")
    if fault == "float64_param":
        params["adapter"]["bias"] = params["adapter"]["bias"].double()
    freeze = optim.trainable_mask(params)
    tx = transformation(params, freeze)
    state = tx.init(params)
    grads = optim.tree_map(lambda p, t: torch.empty_like(p) if t else None, params, freeze)
    if fault == "transposed_grad":
        grads["adapter"]["kernel"] = torch.empty((5, 7), device="meta").t()
    with pytest.raises(ValueError, match="contiguous float32"):
        tx.step(grads, 2, state, params)
    assert meta_library.names == []


def tiny_trainer(seed=0):
    enc = dataclasses.replace(thub.tiny_test_config(), hidden_dropout=0.0, attention_dropout=0.0,
                              activation_dropout=0.0, layerdrop=0.0,
                              feature_projection_dropout=0.0)
    lm = tllm.tiny_test_config()
    model = taslm.AslmModel(taslm.AslmConfig(projection_type="linear",
                                             audio_encoder_hidden=enc.hidden_size,
                                             lm_hidden=lm.hidden_size, projection_hidden=48),
                            enc, lm)
    cfg = TrainingConfig(learning_rate=1e-3, warmup_steps=2, max_steps=10,
                         compute_dtype="float32", logging_steps=1000, eval_steps=0,
                         save_steps=0, gradient_accumulation_steps=2)
    return AATTrainer(model, model.init_params(seed, device="cpu"), cfg)


def microbatches(step, b=2, length=480, c=6):
    rng = np.random.default_rng([7, step])
    out = []
    for _ in range(2):
        mask = np.ones((b, length), np.int32)
        mask[-1, 400:] = 0
        cmask = np.ones((b, c), np.int32)
        cmask[-1, c - 2:] = 0
        out.append({"waveforms": rng.normal(0, 0.3, (b, length)).astype(np.float32),
                    "waveforms_attention_mask": mask, "input_ids": rng.integers(3, 100, (b, c)),
                    "attention_mask": cmask, "input_ids_attention_mask": cmask})
    return out


@pytest.mark.parametrize("route", ["cpu", "kernel_emulated"])
def test_trainer_steps_unchanged(monkeypatch, route):
    """Three ``AATTrainer`` steps of two microbatches each: params, moments,
    count and losses bit for bit those of the trainer's former optimizer
    step (:func:`old_step`), on the CPU route and on the kernel route with
    its entries emulated on host memory."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        reference = tiny_trainer()
        reference.tx = reference.tx._replace(in_place=old_step(reference.tx))
        ref_losses = [reference.training_step(microbatches(s))["train/loss"] for s in range(3)]
        if route == "kernel_emulated":
            emulate_kernels(monkeypatch)
        trainer = tiny_trainer()
        losses = [trainer.training_step(microbatches(s))["train/loss"] for s in range(3)]
    finally:
        torch.set_num_threads(threads)
    assert losses == ref_losses
    assert_trees_bitwise(trainer.state.params, reference.state.params)
    assert_states_bitwise(trainer.state.opt_state, reference.state.opt_state)
    assert int(trainer.state.opt_state.count) == 3


# --- on the card (``chip_smoke.py`` phase 21 runs the same functions) ---


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the chip")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [2, 3])
def test_card_kernel_equals_plain_route(card, n):
    """At HuBERT-large + the adapter, without a clip: p, m and v bit for bit
    the plain route's over 3 steps, the NaN step leaving them as they were;
    one update launch a step."""
    import chip_smoke

    for i, s in enumerate(chip_smoke.adamw_routes(torch, chip_smoke.adamw_leaf_set(torch, card),
                                                  n=n)):
        assert s["ulps_p_m_v"] == [0, 0, 0], (i, s)
        assert s["unchanged"] == (i == 1) and s["launches"] == 1, (i, s)
        assert s["counts"][0] == s["counts"][1] and s["counts"][2] == s["counts"][3], (i, s)


@pytest.mark.card
def test_card_clip_differs_only_by_the_norm(card):
    """With a binding clip: bit for bit where both routes take the plain
    route's norm; the kernel's own norm within 4 ulp of it, and each leaf's
    p, m and v within 4 ulp of its norm."""
    import chip_smoke

    params = chip_smoke.adamw_leaf_set(torch, card)
    for i, s in enumerate(chip_smoke.adamw_routes(torch, params, clip=0.05, plain_norm=True)):
        assert s["ulps_p_m_v"] == [0, 0, 0] and s["unchanged"] == (i == 1), (i, s)
    for i, s in enumerate(chip_smoke.adamw_routes(torch, params, clip=0.05)):
        assert max(s["rel_p_m_v"]) <= chip_smoke.ADAMW_REL, (i, s)
    kernel_gn, plain_gn = chip_smoke.kernel_norm(torch, params, 2)
    assert chip_smoke.ulps(torch, torch.tensor(kernel_gn), torch.tensor(plain_gn)) <= \
        chip_smoke.ADAMW_ULPS


@pytest.mark.card
def test_card_kernels_reach_70_percent_of_their_bytes_bound(card):
    import chip_smoke

    t = chip_smoke.adamw_times(torch, chip_smoke.adamw_leaf_set(torch, card))
    assert 100.0 * t["bound_ms"] / (t["sumsq_ms"] + t["update_ms"]) >= 70.0, t
