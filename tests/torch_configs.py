"""Configurations for the port's parity tests, built on each side from its
own package's config module."""

import dataclasses

from detectorch_tpu import config as jax_config
from detectorch_tpu_torch import config as torch_config


def both_configs(build):
    """build(config_module) with the JAX package's config module and with
    the port's: one configuration, each side built from its own package's
    PRESETS and dataclasses, held equal field for field. Returns (JAX's,
    the port's)."""
    j, p = build(jax_config), build(torch_config)
    assert type(p).__module__ == torch_config.__name__
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    return j, p
