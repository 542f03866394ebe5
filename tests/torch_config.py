"""The port keeps its own copy of the reference's config module, so a test
that hands one configuration to both packages converts it for the port."""

import dataclasses
import enum

from orbslam2_tpu_torch import config as port_config_module


def port_config(cfg):
    """The port's twin of a reference config object: the same class by
    name, field by field, enums by member name."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cls = getattr(port_config_module, type(cfg).__name__)
        return cls(**{f.name: port_config(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg) if f.init})
    if isinstance(cfg, enum.Enum):
        return getattr(port_config_module, type(cfg).__name__)[cfg.name]
    return cfg
