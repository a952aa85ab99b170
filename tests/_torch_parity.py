"""Shared set-up of the port's parity tests: one configuration in both
packages, and JAX weights carried into the port through numpy."""
import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.convert import params_from_jax


def config_pair(arch: str, **reduced):
    """The reduced `arch` in float32, as (JAX config, port config)."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(**reduced),
                               dtype="float32")
    tcfg = dataclasses.replace(torch_get_config(arch).reduced(**reduced),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def weights_pair(jcfg, tcfg, seed: int = 0):
    """JAX `init_params` weights and the same weights in the port (CPU)."""
    jparams = jax_init_params(jax.random.key(seed), jcfg)
    return jparams, params_from_jax(numpy_tree(jparams), tcfg, device="cpu")
