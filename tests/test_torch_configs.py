"""The port's configs equal the JAX package's, field for field."""
import dataclasses

import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs as jax_list_configs
from repro_torch.configs.base import config_from_dict
from repro_torch.configs.base import get_config, list_configs

from conftest import TINY_FAMILIES


def test_same_registry():
    assert list_configs() == jax_list_configs()
    assert len(list_configs()) == 11


@pytest.mark.parametrize("name", jax_list_configs())
def test_registered_config_fields_equal(name):
    ours, ref = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.hd == ref.hd and ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.layer_kinds() == ref.layer_kinds()
    assert dataclasses.asdict(ours.prefill_capabilities()) == \
        dataclasses.asdict(ref.prefill_capabilities())
    assert ours.pdtype == getattr(torch, ref.param_dtype)
    assert ours.cdtype == getattr(torch, ref.compute_dtype)


@pytest.mark.parametrize("name", ["dense", "dense-bias-qknorm"])
def test_tiny_family_round_trip(name):
    ref = TINY_FAMILIES[name]
    ours = config_from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.pdtype == torch.float32
    assert dataclasses.asdict(ours.prefill_capabilities()) == \
        dataclasses.asdict(ref.prefill_capabilities())
