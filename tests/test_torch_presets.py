"""Three shipped presets the port trains on parts it already had, held
against the jitted JAX step: cifar10_32 (f32 compute), celeba_64
(attention at every stage) and ffhq_256 (class-conditional: the class
embedding and the projection D, labels passed explicitly). Two steps with
R1 firing at step 0 from one state with the same draws, the port on its
gate Functions, f32 on the CPU at narrowed widths (channels 32 down to
16, latent 16, batch 4; ffhq_256 at 64x64, its depth cut so that the JAX
compile stays short), the preset's recipe otherwise as shipped (R1
gamma, the guards, EMA 0.999). The zero-init leaves are filled with
N(0, 0.05^2): at 0.2 (the other step tests' fill) the softmax gates at
32^2 and up sit at their clamp (16) for some elements, and the clamp's
kink makes G's gradient move by 1e-3 under a 1e-7 change of the weights
(measured on the JAX step alone), more than the tolerance. Tolerances as
in `test_torch_step_options.py`; full width in
`test_torch_presets_full.py` (slow)."""

import numpy as np
import pytest

from locate_tpu.config import get_config
from torch_port_parity import port_config
from torch_step_draws import run_parity

NARROW = {"model.base_channels": "32", "model.max_channels": "32",
          "model.min_channels": "16", "model.latent_dim": "16",
          "train.compute_dtype": "float32", "train.global_batch": "4"}
SCALE = 0.05
CUT = {"ffhq_256": {"model.resolution": "64", "data.resolution": "64"}}


def preset(name, overrides, cut=True):
    jcfg = get_config(name, {**overrides, **(CUT.get(name, {}) if cut else {})})
    return jcfg, port_config(jcfg)


@pytest.mark.parametrize("name", ["cifar10_32", "celeba_64", "ffhq_256"])
def test_preset_two_steps_match_jax(name):
    jcfg, tcfg = preset(name, NARROW)
    assert jcfg.train.r1_gamma > 0 and jcfg.train.r1_interval > 1
    pm, jm, pstate, jstate = run_parity(jcfg, tcfg, use_pallas=True, scale=SCALE)
    assert float(jm["r1"]) == 0.0  # fired at step 0 only
    if name == "ffhq_256":
        assert jcfg.model.num_classes == 10
        assert np.abs(pstate.d_params.named(pstate.d_params.flat)["class_proj"].numpy()).max() > 0
    if name == "cifar10_32":
        assert jcfg.train.compute_dtype == "float32"
    if name == "celeba_64":
        assert jcfg.model.attention_stages == "all"
