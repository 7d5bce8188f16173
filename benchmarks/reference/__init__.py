"""The benchmark's plain references: one module per configuration, named by
the configuration's ``reference`` key, each defining ``Model``."""

import importlib


def model_for(name: str, cfg: dict):
    """The reference model of module ``reference.<name>`` over ``cfg``."""
    return importlib.import_module(f"reference.{name}").Model(cfg)
