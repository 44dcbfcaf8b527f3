"""The port's configuration dataclasses equal the JAX package's, field for
field and default for default, so one configuration serves both."""

import dataclasses

import pytest

from indonesian_image_captioning_tpu.core import config as jax_config
from indonesian_image_captioning_tpu_torch.core import config


@pytest.mark.parametrize("name", ["ModelConfig", "TaggerConfig",
                                  "BeamConfig", "DataConfig",
                                  "TrainConfig"])
def test_fields_and_defaults_match_jax(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
            == [(f.name, f.default) for f in dataclasses.fields(theirs)])
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_model_config_properties_match_jax():
    for mt in ("pure_scn", "pure_attention", "attention_scn"):
        ours = config.ModelConfig(model_type=mt, enc_image_size=3)
        theirs = jax_config.ModelConfig(model_type=mt, enc_image_size=3)
        for prop in ("num_pixels", "uses_tags", "uses_attention"):
            assert getattr(ours, prop) == getattr(theirs, prop)
