"""The synthetic sprite envs of the port (counterpart of ocrl_tpu/envs):
numpy and the port's C++ rasterizer, no torch. CausalWorld
(ocrl_tpu/envs/cw.py) comes with a later slice."""

from .base import COLORS, SCALES, SHAPES, BaseEnv
from .tasks import MazeEnv, OddOneOutEnv, PushEnv, RandomObjsEnv, TargetEnv

ENVS = {cls.__name__: cls for cls in (TargetEnv, OddOneOutEnv, PushEnv, MazeEnv,
                                      RandomObjsEnv)}


def make_env(config, seed: int) -> BaseEnv:
    """The env class that ``config.env`` names, built with ``seed``."""
    if config.env not in ENVS:
        raise NotImplementedError(f"env '{config.env}' comes with a later slice "
                                  f"(ported: {', '.join(ENVS)})")
    return ENVS[config.env](config, seed)


__all__ = ["BaseEnv", "COLORS", "ENVS", "MazeEnv", "OddOneOutEnv", "PushEnv",
           "RandomObjsEnv", "SCALES", "SHAPES", "TargetEnv", "make_env"]
