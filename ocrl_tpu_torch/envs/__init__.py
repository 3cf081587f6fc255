"""The envs of the port (counterpart of ocrl_tpu/envs): the five synthetic
sprite envs (numpy and the port's C++ rasterizer) and the CausalWorld reach
envs on the fake TriFinger backend (numpy), no torch."""

from .base import COLORS, SCALES, SHAPES, BaseEnv
from .cw import CwTargetEnv
from .tasks import MazeEnv, OddOneOutEnv, PushEnv, RandomObjsEnv, TargetEnv

ENVS = {cls.__name__: cls for cls in (TargetEnv, OddOneOutEnv, PushEnv, MazeEnv,
                                      RandomObjsEnv, CwTargetEnv)}


def make_env(config, seed: int):
    """The env that ``config.env`` names, built with ``seed``."""
    if config.env not in ENVS:
        raise ValueError(f"unknown env '{config.env}' (available: {', '.join(ENVS)})")
    return ENVS[config.env](config, seed)


__all__ = ["BaseEnv", "COLORS", "CwTargetEnv", "ENVS", "MazeEnv", "OddOneOutEnv", "PushEnv",
           "RandomObjsEnv", "SCALES", "SHAPES", "TargetEnv", "make_env"]
