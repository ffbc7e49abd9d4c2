"""The port's model for a configuration file: the system under test.

The configuration file holds the sizes as they are run; each key that is a
field of the port's ``ModelConfig`` replaces the registered value, so the
file, not the program's registry, fixes what a cell runs.  The reference
reads the same file.
"""

from __future__ import annotations

import dataclasses


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def sizes(run) -> dict:
    """The configuration file's values, with a test's overrides."""
    return {**run.config, **run.overrides}


def build(run):
    """(the port's model on the run's device, its ModelConfig)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build_model, get_config

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    vals = sizes(run)
    cfg = get_config(vals["registry_name"]).replace(
        **{k: _tuples(v) for k, v in vals.items()
           if k in fields and k != "name"})
    return build_model(cfg, device=run.device), cfg
