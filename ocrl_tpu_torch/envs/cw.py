"""CausalWorld TriFinger reach environments on the fake backend
(counterpart of ocrl_tpu/envs/cw.py:41-311; numpy only: the colour table,
the Pillow resize and the spaces are the port's own).

Stack (reference target.py:13-50):
  finger_image: backend(pixel) -> SingleFingerCausalWorldWrapper
                -> CausalWorldFingerImageWrapper   (64x64, 3 cameras stacked)
  image:        backend(structured) -> SingleFinger -> RenderAndState
                -> SelectObsKey("image")
  state:        backend(structured) -> SingleFinger -> StateOnly
                -> SelectObsKey("gt")

Random draws as JAX makes them: ``CwTargetEnv`` seeds numpy's global
stream (``np.random.seed``), from which the wrappers draw the target and
the colours; the backend's stage draws the hard mode's positions from its
own ``default_rng(seed)``. In one process the envs share the global
stream: the last env built sets the seed and their draws interleave in step
order. JAX's ``RealCausalWorldBackend`` needs causal_world and pybullet and
is not ported: ``use_fake_sim`` false raises ``ImportError``.
"""

from __future__ import annotations

import numpy as np

from . import spaces
from .cw_sim import (JOINTS_RAISED_ACTION, JOINTS_RAISED_POSITIONS, N_OBJECTS,
                     FakeTriFingerBackend, SingleFingerReachTask, cart2cyl)
from .resize import resize_bilinear

# matplotlib's CSS4 hex value of every colour a configs/env/cw-*.yaml names;
# to_rgb gives each byte / 255 in double
_CW_HEX = {"blue": "#0000FF", "green": "#008000", "yellow": "#FFFF00", "red": "#FF0000",
           "orange": "#FFA500", "purple": "#800080", "brown": "#A52A2A", "pink": "#FFC0CB",
           "gray": "#808080", "olive": "#808000", "cyan": "#00FFFF"}
CW_RGB = {name: tuple(int(h[i:i + 2], 16) / 255 for i in (1, 3, 5))
          for name, h in _CW_HEX.items()}


def to_rgb(color_name: str) -> tuple[float, float, float]:
    """``matplotlib.colors.to_rgb`` of a CausalWorld config's colour."""
    try:
        return CW_RGB[color_name]
    except KeyError:
        raise ValueError(f"colour '{color_name}' is not in the table of the CausalWorld "
                         f"configs' colours: {sorted(CW_RGB)}") from None


def CwTargetEnv(config, seed):  # noqa: N802 - factory matching the class name
    """reference: target.py:13-50."""
    np.random.seed(seed)
    if config.mode not in ("easy", "hard") or config.rew_type != "sparse":
        raise ValueError(f"mode must be easy or hard and rew_type sparse, not "
                         f"'{config.mode}' and '{config.rew_type}'")
    task = SingleFingerReachTask(activate_sparse_reward=True)
    pixel = config.render_mode == "finger_image"
    if not config.use_fake_sim:
        raise ImportError(
            "CwTargetEnv requires the 'causal_world' and 'pybullet' packages "
            "(reference: envs/cw_envs/target.py), which the port does not use: set "
            "env.use_fake_sim=true to run the kinematic fake backend")
    env = FakeTriFingerBackend(task, seed=seed,
                               observation_mode="pixel" if pixel else "structured")
    env = SingleFingerCausalWorldWrapper(env, config)
    if pixel:
        return CausalWorldFingerImageWrapper(env, config)
    if config.render_mode == "state":
        env = CausalRLStateOnlyWrapper(env)
        obs_key = "gt"
    else:
        env = CausalRLRenderAndStateWrapper(env)
        obs_key = "image"
    return SelectObsKeyWrapper(env, obs_key=obs_key)


class _Wrapper:
    """Minimal wrapper base (stands in for gym.Wrapper): attribute access
    falls through to the wrapped env."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def close(self):
        return self.env.close()


class SingleFingerCausalWorldWrapper(_Wrapper):
    """3-DoF single-finger control + per-episode scene interventions
    (reference: target.py:93-230)."""

    def __init__(self, env, config):
        super().__init__(env)
        self._config = config
        self._COLORS = list(config.COLORS)
        if len(config.target) > 0:
            self._target_color = config.target[0]
        else:
            self._target_color = np.random.choice(self._COLORS)
        self._size = [0.055, 0.055, 0.055]
        self.action_space = spaces.Box(-1.0, 1.0, (3,), np.float32)
        self.num_objects = N_OBJECTS
        self.target_obj_idx = None

    def _get_random_positions(self):
        """Rejection-sample non-colliding cube positions (target.py:138-167)."""
        cube_size = 0.065

        def collides(p1, p2):
            return (abs(p1[0] - p2[0]) <= cube_size
                    and abs(p1[1] - p2[1]) <= cube_size)

        cart_positions = []
        for _ in range(self.num_objects):
            while True:
                cart = self.env.stage.random_position(
                    height_limits=(0.0325, 0.0325),
                    angle_limits=(-3.14, 3.14 / 4))
                if not any(collides(cart, p) for p in cart_positions):
                    break
            cart_positions.append(cart)
        return [cart2cyl(p) for p in cart_positions]

    def reset(self):
        self.env.reset()
        interventions = {"joint_positions": JOINTS_RAISED_POSITIONS}
        self.target_obj_idx = np.random.randint(self.num_objects)
        self.env.task.target_obj = f"obj_{self.target_obj_idx}"
        if self._config.mode == "easy":
            positions = [
                [0.14, -1.0, 0.0325],
                [0.15, -2.34, 0.0325],
                [0.15, 0.01, 0.0325],
                [0.03, -3.14, 0.0325],
            ]
        else:  # hard
            positions = self._get_random_positions()

        if self._config.task == "target":
            for n_idx in range(self.num_objects):
                if n_idx == self.target_obj_idx:
                    color = self._target_color
                else:
                    color = self._target_color
                    while color == self._target_color:
                        color = np.random.choice(self._COLORS)
                interventions[f"obj_{n_idx}"] = {
                    "color": to_rgb(color),
                    "cylindrical_position": positions[n_idx],
                    "size": np.asarray(self._size),
                }
        if self._config.task == "ooo":
            # odd-one-out: target uniquely colored, all others share one color
            self._target_color = np.random.choice(self._COLORS)
            other_color = self._target_color
            while other_color == self._target_color:
                other_color = np.random.choice(self._COLORS)
            for n_idx in range(self.num_objects):
                color = (self._target_color if n_idx == self.target_obj_idx
                         else other_color)
                interventions[f"obj_{n_idx}"] = {
                    "color": to_rgb(color),
                    "cylindrical_position": positions[n_idx],
                    "size": np.asarray(self._size),
                }
        _, obs = self.env.do_intervention(interventions)
        return obs

    def step(self, action):
        full = np.asarray(
            JOINTS_RAISED_ACTION + list(np.asarray(action).ravel())
            + JOINTS_RAISED_ACTION, dtype=np.float32)
        obs, reward, done, info = self.env.step(full)
        info = dict(info)
        info["label"] = self.target_obj_idx
        return obs, reward, done, info


class CausalWorldFingerImageWrapper(_Wrapper):
    """Tool-camera pixels -> uint8 [64, 64, 3 * num_cameras]
    (reference: target.py:53-90; goal-camera halves dropped)."""

    def __init__(self, env, config, height=64, width=64):
        super().__init__(env)
        self.height, self.width = height, width
        self.observation_space = spaces.Box(
            0, 255, (height, width, config.num_stacked_obss * 3), np.uint8)
        self.action_space = env.action_space

    def _get_frame(self, obs):
        frames = []
        for i in range(len(obs) // 2):  # first half: current; second: goals
            frames.append(resize_bilinear((obs[i] * 255).astype(np.uint8),
                                          self.width, self.height))
        frames = np.stack(frames)
        return frames.transpose(1, 2, 0, 3).reshape(self.height, self.width, -1)

    def reset(self):
        return self._get_frame(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        info = dict(info)
        info["is_success"] = bool(reward > 0)
        return self._get_frame(obs), reward, done, info


def _split_structured(obs):
    """(robot_state [28], object_states [40]) from the structured vector
    (reference: target.py:293-316)."""
    obs = np.asarray(obs, float)
    return obs[0:28], obs[28:68]


class CausalRLStateOnlyWrapper(_Wrapper):
    """Structured obs -> {robot_state, object_states, gt [5, 40]}
    (reference: target.py:275-333)."""

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = {
            "robot_state": spaces.Box(-1, 1, (28,), np.float64),
            "object_states": spaces.Box(-1, 1, (40,), np.float64),
            "gt": spaces.Box(-1, 1, (5, 40), np.float64),
        }
        self.action_space = env.action_space

    def _get_frame(self, obs):
        robot_state, object_states = _split_structured(obs)
        gt = np.zeros((5, 40))
        gt[0][:28] = robot_state
        gt[0][-1] = 0  # row type: robot arm
        for i in range(4):
            gt[i + 1][28:38] = object_states[i * 10:(i + 1) * 10]
            gt[i + 1][31] = 1
            gt[i + 1][-1] = 1  # row type: block
        return {"robot_state": robot_state, "object_states": object_states,
                "gt": gt}

    def reset(self):
        return self._get_frame(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        info = dict(info)
        info["is_success"] = bool(reward > 0)
        return self._get_frame(obs), reward, done, info


class CausalRLRenderAndStateWrapper(_Wrapper):
    """Structured obs + top-view render -> {image, robot_state, object_states,
    gt [5, 28]} (reference: target.py:338-402)."""

    def __init__(self, env, height=64, width=64):
        super().__init__(env)
        self.height, self.width = height, width
        self.observation_space = {
            "image": spaces.Box(0, 255, (height, width, 3), np.uint8),
            "robot_state": spaces.Box(-1, 1, (28,), np.float64),
            "object_states": spaces.Box(-1, 1, (40,), np.float64),
            "gt": spaces.Box(-1, 1, (5, 28), np.float64),
        }
        self.action_space = env.action_space

    def _get_frame(self, obs):
        frame = resize_bilinear(self.env.render().astype(np.uint8),
                                self.width, self.height)
        robot_state, object_states = _split_structured(obs)
        gt = np.zeros((5, 28))
        gt[0] = robot_state
        for i in range(4):
            gt[i + 1][:10] = object_states[i * 10:(i + 1) * 10]
        return {"image": frame, "robot_state": robot_state,
                "object_states": object_states, "gt": gt}

    def reset(self):
        return self._get_frame(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        info = dict(info)
        info["is_success"] = bool(reward > 0)
        return self._get_frame(obs), reward, done, info


class SelectObsKeyWrapper(_Wrapper):
    """reference: target.py:233-240."""

    def __init__(self, env, obs_key):
        super().__init__(env)
        self.obs_key = obs_key
        self.observation_space = env.observation_space[obs_key]
        self.action_space = env.action_space

    def reset(self):
        return self.env.reset()[self.obs_key]

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return obs[self.obs_key], reward, done, info
