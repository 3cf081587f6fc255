"""RL surface of the port: building a policy, PPO and A2C (acting,
rollouts, updates), vmapped multi-seed PPO, SAC, vectorised envs,
evaluation and rollout videos."""

from .ac_nets import ActorCriticPolicy, CustomNetwork
from .evaluate import evaluate_policy
from .extractor import build_policy, build_sac_policy, inject_pretrained_ocr
from .multi_seed import MultiSeedPPO
from .ppo import A2C, PPO, OptaxChain
from .sac import SAC, ReplayBuffer, SACPolicy, sample_squashed
from .vec_env import SubprocVecEnv, VecEnv, make_multi_seed_vec_env, make_vec_env
from .video import VideoRecorder

__all__ = ["A2C", "ActorCriticPolicy", "CustomNetwork", "MultiSeedPPO", "OptaxChain", "PPO",
           "ReplayBuffer", "SAC", "SACPolicy", "SubprocVecEnv", "VecEnv", "VideoRecorder",
           "build_policy", "build_sac_policy", "evaluate_policy", "inject_pretrained_ocr",
           "make_multi_seed_vec_env", "make_vec_env", "sample_squashed"]
