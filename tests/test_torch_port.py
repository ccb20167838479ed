"""Parameter bridge and package hygiene: ``from_jax_params`` round-trips,
the port's int-seed init equals the bridged JAX int-seed init, and
importing the port loads no JAX."""

import subprocess
import sys
import os

import numpy as np
import jax

from aat_tpu.models import aslm as jaslm
from aat_tpu.models import hubert as jhub
from aat_tpu.models import llama as jllm
from aat_tpu_torch.models import aslm as taslm
from aat_tpu_torch.models import hubert as thub
from aat_tpu_torch.models import llama as tllm
from aat_tpu_torch.utils.port import from_jax_params, to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_configs():
    """(JAX model, port model) at tiny widths, linear projection."""
    jcfg = jaslm.AslmConfig(projection_type="linear", audio_encoder_hidden=32,
                            lm_hidden=32, projection_hidden=48)
    tcfg = taslm.AslmConfig(projection_type="linear", audio_encoder_hidden=32,
                            lm_hidden=32, projection_hidden=48)
    jmodel = jaslm.AslmModel(jcfg, jhub.tiny_test_config(), jllm.tiny_test_config())
    tmodel = taslm.AslmModel(tcfg, thub.tiny_test_config(), tllm.tiny_test_config())
    return jmodel, tmodel


def jax_int_seed_params(jmodel, seed=0):
    """The JAX int-seed init of each part, with the seeds the port's
    ``AslmModel.init_params(seed)`` uses."""
    return {
        "audio_encoder": jhub.init_hubert_params(seed, jmodel.audio_encoder_config),
        "adapter": jaslm.init_aslm_params(seed + 1, jmodel.config),
        "lm_decoder": jllm.init_llama_params(seed + 2, jmodel.lm_config),
    }


def assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_from_jax_params_round_trips():
    jmodel, _ = tiny_configs()
    tree = jax_int_seed_params(jmodel)
    ported = from_jax_params(tree)
    # conv kernels move to PyTorch's [C_out, C_in, K]
    k0 = tree["audio_encoder"]["feature_extractor"][0]["conv"]["kernel"]
    assert tuple(ported["audio_encoder"]["feature_extractor"][0]["conv"]["kernel"].shape) == \
        k0.shape[::-1]
    assert_trees_equal(to_jax_params(ported), tree)


def test_port_int_seed_init_equals_bridged_jax_init():
    jmodel, tmodel = tiny_configs()
    want = from_jax_params(jax_int_seed_params(jmodel, seed=3))
    got = tmodel.init_params(3)
    assert_trees_equal(to_jax_params(got), to_jax_params(want))


def test_mean_projection_init_equals_jax():
    jcfg = jaslm.AslmConfig(projection_type="mean", audio_encoder_hidden=16, lm_hidden=8)
    tcfg = taslm.AslmConfig(projection_type="mean", audio_encoder_hidden=16, lm_hidden=8)
    assert_trees_equal(taslm.init_aslm_params(5, tcfg), jaslm.init_aslm_params(5, jcfg))


def test_port_imports_no_jax():
    modules = [
        "aat_tpu_torch", "aat_tpu_torch.ops.mel", "aat_tpu_torch.ops.segmentation",
        "aat_tpu_torch.ops.ragged", "aat_tpu_torch.ops.attention",
        "aat_tpu_torch.data.ondevice", "aat_tpu_torch.models.hubert",
        "aat_tpu_torch.models.llama", "aat_tpu_torch.models.aslm",
        "aat_tpu_torch.serving.engine", "aat_tpu_torch.serving.serve",
        "aat_tpu_torch.utils.port", "aat_tpu_torch.runtime.kernels",
        "aat_tpu_torch.ops.dropout", "aat_tpu_torch.training.config",
        "aat_tpu_torch.training.lr_schedule", "aat_tpu_torch.training.optim",
        "aat_tpu_torch.training.trainer",
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aat_tpu'))\n"
        + "built = aat_tpu_torch.runtime.kernels._library is not None\n"
        + "print(bad, 'kernel library built' if built else '')\n"
        + "sys.exit(1 if bad or built else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
