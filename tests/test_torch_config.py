"""The port's own `config` equals the JAX package's, field for field.

The port keeps a copy of image_denoising_filter_tpu/config.py so that it
imports nothing of the JAX package. The two are held equal here: every
dataclass with its fields, types and defaults, the battery, the output file
names and the derived properties. The BorderPolicy values are plain strings,
so parameters of the two packages compare equal field by field.

`jax_params` builds the JAX package's dataclass with the fields of a port
dataclass: the other torch tests construct each package's parameters from
that package's own config with it.
"""

import dataclasses

import pytest

from image_denoising_filter_tpu import config as jconfig
from image_denoising_filter_tpu_torch import config as pconfig

DATACLASSES = [
    "BilateralParams",
    "CpuBilateralParams",
    "NlmParams",
    "LayersParams",
    "NormalizeParams",
    "RunConfig",
    "TilingConfig",
]


def jax_params(p):
    """The JAX package's dataclass of the same name and field values as the
    port's dataclass `p` (None stays None)."""
    if p is None:
        return None
    cls = getattr(jconfig, type(p).__name__)
    return cls(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def test_port_config_is_its_own_module():
    assert pconfig is not jconfig
    assert pconfig.__name__ == "image_denoising_filter_tpu_torch.config"


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults_equal(name):
    ours, theirs = getattr(pconfig, name), getattr(jconfig, name)
    assert ours is not theirs
    fields = [(f.name, f.type, f.default) for f in dataclasses.fields(ours)]
    assert fields == [(f.name, f.type, f.default) for f in dataclasses.fields(theirs)]
    assert ours.__dataclass_params__.frozen == theirs.__dataclass_params__.frozen
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in theirs.__mro__]


def test_border_policy_values_equal():
    assert pconfig.BorderPolicy.CLAMP == jconfig.BorderPolicy.CLAMP == "clamp"
    assert pconfig.BorderPolicy.ZERO == jconfig.BorderPolicy.ZERO == "zero"


def test_gpu_battery_and_output_names_equal():
    assert len(pconfig.GPU_BATTERY) == len(jconfig.GPU_BATTERY) == 6
    for ours, theirs in zip(pconfig.GPU_BATTERY, jconfig.GPU_BATTERY):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        for hdr in (False, True):
            assert ours.output_name(hdr) == theirs.output_name(hdr)


@pytest.mark.parametrize(
    "kwargs",
    [{}, dict(sigma_spatial=6.0), dict(truncate_eps=0.0), dict(radius=3), dict(sigma_spatial=0.3)],
    ids=["defaults", "sigma_s6", "no_truncation", "radius3", "sigma_s0.3"],
)
def test_effective_radius_equal(kwargs):
    ours = pconfig.BilateralParams(**kwargs)
    assert ours.effective_radius == jconfig.BilateralParams(**kwargs).effective_radius
    assert ours.window == jconfig.BilateralParams(**kwargs).window
    assert pconfig.BilateralParams().effective_radius == 12


def test_derived_properties_and_checks_equal():
    assert pconfig.NlmParams().halo == jconfig.NlmParams().halo == 10
    with pytest.raises(AssertionError):
        pconfig.RunConfig(multiframe=True)
    with pytest.raises(AssertionError):
        pconfig.RunConfig(nlm=True, use_layers=True)


def test_jax_params_builds_the_jax_dataclass():
    p = pconfig.NlmParams(search_stride=2, search_disk=True)
    j = jax_params(p)
    assert type(j) is jconfig.NlmParams
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert jax_params(None) is None
