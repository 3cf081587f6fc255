"""RL surface of the port: building a policy, PPO and A2C (acting,
rollouts, updates), vectorised envs and evaluation."""

from .ac_nets import ActorCriticPolicy, CustomNetwork
from .evaluate import evaluate_policy
from .extractor import build_policy, inject_pretrained_ocr
from .ppo import A2C, PPO, OptaxChain
from .vec_env import SubprocVecEnv, VecEnv, make_vec_env

__all__ = ["A2C", "ActorCriticPolicy", "CustomNetwork", "OptaxChain", "PPO",
           "SubprocVecEnv", "VecEnv", "build_policy", "evaluate_policy",
           "inject_pretrained_ocr", "make_vec_env"]
