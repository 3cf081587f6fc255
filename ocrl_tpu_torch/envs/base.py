"""Procedurally generated 2D sprite arena (counterpart of
ocrl_tpu/envs/base.py): host-side numpy; observations rendered as images
(``SpriteRenderer``), ground-truth state matrices or per-object masks; a
discrete 4-action agent moves in the unit square.

Every draw of ``np.random.RandomState`` is the JAX package's, call for call
and in the same order, so a seed gives the same episodes bit for bit.
Colours come from a table of the names the env configs use (the values of
``matplotlib.colors.to_rgb``), spaces from ``.spaces``. Background images
raise (``renderer.LATER``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import spaces
from .renderer import LATER, Sprite, SpriteRenderer

# Global index tables for GT-state encoding (reference: base.py:12-14).
COLORS = ["blue", "green", "yellow", "red", "cyan", "pink", "brown"]
SHAPES = ["square", "triangle", "star_4", "circle", "pentagon", "hexagon",
          "octagon", "star_5", "star_6", "spoke_4", "spoke_5", "spoke_6"]
SCALES = [0.15, 0.22]


def norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, dtype=np.float64)))


# int(c * 255) of matplotlib.colors.to_rgb(name), for every colour name used
# under configs/env/ and in AGENT
RGB255 = {
    "blue": (0, 0, 255), "green": (0, 128, 0), "yellow": (255, 255, 0),
    "red": (255, 0, 0), "cyan": (0, 255, 255), "pink": (255, 192, 203),
    "brown": (165, 42, 42), "orange": (255, 165, 0), "purple": (128, 0, 128),
    "gray": (128, 128, 128), "olive": (128, 128, 0),
}


def _to_rgb255(color_name: str) -> tuple[int, int, int]:
    try:
        return RGB255[color_name]
    except KeyError:
        raise ValueError(f"colour '{color_name}' is not in the table of the env "
                         f"configs' colours: {sorted(RGB255)}") from None


class BaseEnv:
    metadata = {"render.modes": ["rgb_array", "state", "image", "mask"]}

    def __init__(self, config, seed: int):
        self._rng = np.random.RandomState(seed)
        assert config.mode in ("easy", "normal", "hard")
        assert config.rew_type in ("sparse", "normal", "dense")
        self._name = config.name
        self._config = config
        self._mode = config.mode
        self._rew_type = config.rew_type
        self.render_mode = config.render_mode
        self._num_stacked_obss = config.num_stacked_obss
        self._obs_size = config.obs_size
        self._obs_channels = config.obs_channels
        self._num_objs_range = list(config.num_objects_range)
        self._renderer = SpriteRenderer((config.obs_size, config.obs_size), anti_aliasing=10)
        self._moving_step_size = config.moving_step_size
        self._wo_agent = config.wo_agent
        self._skewed = config.skewed
        self._occlusion = config.occlusion
        self._max_steps = config.max_steps
        self._agent_pos = config.agent_pos
        self._COLORS = list(config.COLORS)
        self._SHAPES = list(config.SHAPES)
        self._SCALES = list(config.SCALES)
        self._AGENT = list(config.AGENT)

        if config.background.use_bg:
            raise NotImplementedError(f"background.use_bg: background images come "
                                      f"with {LATER}")

        self.action_space = spaces.Discrete(4)
        if self.render_mode == "state":
            self.observation_space = spaces.Box(
                low=0, high=1,
                shape=(self._num_objs_range[1] + 1, config.state_size),
                dtype=np.float64,
            )
        else:
            self.observation_space = spaces.Box(
                low=0, high=255,
                shape=(self._obs_size, self._obs_size,
                       self._obs_channels * self._num_stacked_obss),
                dtype=np.uint8,
            )

        self._objs: Optional[np.ndarray] = None
        self.step_count = 0

    # -- placement ------------------------------------------------------------

    def _get_position(self, pos_min, pos_max, radius, eps):
        """Sample one coordinate inside [min,max], wall-clearance in hard/normal."""
        if pos_min == pos_max:
            return pos_min
        if self._mode == "easy":
            return self._rng.uniform(pos_min, pos_max)
        return self._rng.uniform(pos_min + radius + eps, pos_max - radius - eps)

    def _fill_positions(self, objs, agent_eps=0.08, objs_eps=0.08, wall_eps=0.08,
                        skew_mu=0.25, skew_sigma=0.1, occlusion_threshold=0.15):
        """Rejection-sample non-overlapping positions (reference: base.py:102-151)."""
        if self._agent_pos is not None:
            objs[-1, 3] = float(self._agent_pos[0])
            objs[-1, 4] = float(self._agent_pos[1])
        for i, obj in enumerate(objs):
            if i == len(objs) - 2 and "Push" in self._name:
                continue  # push goal position is fixed elsewhere
            if i == len(objs) - 1 and (self._agent_pos is not None or self._wo_agent):
                continue
            x_min, x_max, y_min, y_max = self._obj_poses[i]
            radius = obj[2] / 2
            while True:
                x = self._get_position(x_min, x_max, radius, wall_eps)
                if self._skewed:
                    y = float(np.clip(skew_sigma * self._rng.randn() + skew_mu,
                                      radius + wall_eps, 1 - radius - wall_eps))
                else:
                    y = self._get_position(y_min, y_max, radius, wall_eps)
                ok = True
                for j in range(objs.shape[0]):
                    if self._occlusion:
                        threshold = occlusion_threshold
                    else:
                        threshold = radius + objs[j, 2] / 2 + objs_eps
                    if norm(objs[j, 3:5] - np.array([x, y])) < threshold:
                        ok = False
                        break
                if ok and self._agent_pos is not None:
                    if self._occlusion:
                        threshold = occlusion_threshold
                    else:
                        threshold = radius + objs[-1, 2] / 2 + agent_eps
                    if norm(objs[-1, 3:5] - np.array([x, y])) < threshold:
                        ok = False
                if ok:
                    break
            objs[i, 3] = x
            objs[i, 4] = y
        return objs

    def _set_objs(self):
        """Allocate the object table and per-mode position regimes
        (reference: base.py:153-231)."""
        self._num_objects = int(self._rng.choice(
            list(range(self._num_objs_range[0], self._num_objs_range[1] + 1))))

        is_push = "Push" in self._name
        if self._mode == "easy":
            if is_push:
                assert self._num_objects == 3
                self._obj_poses = [
                    [0.25, 0.25, 0.75, 0.75],
                    [0.25, 0.25, 0.25, 0.25],
                    [0.75, 0.75, 0.25, 0.25],
                ]
                self._agent_pos = [0.75, 0.75]
            else:
                quadrants = {
                    2: [[0.15, 0.35, 0.65, 0.85], [0.15, 0.35, 0.15, 0.35]],
                    3: [[0.15, 0.35, 0.65, 0.85], [0.15, 0.35, 0.15, 0.35],
                        [0.65, 0.85, 0.15, 0.35]],
                    4: [[0.2, 0.3, 0.7, 0.8], [0.2, 0.3, 0.2, 0.3],
                        [0.7, 0.8, 0.2, 0.3], [0.7, 0.8, 0.7, 0.8]],
                }
                if self._num_objects not in quadrants:
                    raise NotImplementedError(
                        f"easy mode supports 2-4 objects, got {self._num_objects}")
                self._obj_poses = quadrants[self._num_objects]
                self._agent_pos = [0.5, 0.5]
        elif self._mode == "normal":
            if is_push:
                assert self._num_objects == 3
                self._obj_poses = [
                    [0.0, 0.5, 0.5, 1.0], [0.0, 0.5, 0.0, 0.5], [0.5, 1.0, 0.0, 0.5],
                ]
                self._agent_pos = [0.75, 0.75]
            else:
                assert self._num_objects == 4
                self._obj_poses = [
                    [0.0, 0.5, 0.5, 1.0], [0.0, 0.5, 0.0, 0.5],
                    [0.5, 1.0, 0.0, 0.5], [0.5, 1.0, 0.5, 1.0],
                ]
                self._agent_pos = [0.5, 0.5]
        else:  # hard: anywhere
            extra = 2 if is_push else 1
            self._obj_poses = [[0.0, 1.0, 0.0, 1.0]] * (self._num_objects + extra)

        # columns: color, shape, scale, x, y (agent in last row)
        objs = np.zeros((self._num_objects + 1, 5), dtype=object)
        objs[-1, :3] = self._AGENT
        self._target_obj_idx = 0
        return objs

    # -- rendering ------------------------------------------------------------

    def _sprite(self, obj) -> Sprite:
        return Sprite(x=float(obj[3]), y=float(obj[4]), shape=str(obj[1]),
                      scale=float(obj[2]), rgb=_to_rgb255(str(obj[0])))

    def _get_masks(self, objs) -> np.ndarray:
        """Per-object masks by differential rendering (reference: base.py:233-258)."""
        masks = []
        bg = self._renderer.render([]).astype(np.int64)
        rows = objs[:-1] if self._wo_agent else objs
        for obj in rows:
            single = self._renderer.render([self._sprite(obj)]).astype(np.int64)
            diff = np.abs(single - bg).sum(-1)
            mask = np.zeros((self._obs_size, self._obs_size, 1), dtype=int)
            mask[diff != 0] = 1
            masks.append(mask)
        fg = np.sum(np.array(masks), axis=0)
        bg_mask = np.zeros((self._obs_size, self._obs_size, 1), dtype=int)
        bg_mask[fg == 0] = 1
        masks.append(bg_mask)
        return np.array(masks)

    def _draw_objs(self, objs, mode="rgb_array") -> np.ndarray:
        rows = objs[:-1] if self._wo_agent else objs
        sprites = [self._sprite(o) for o in rows if o[0] != -1]
        obs = self._renderer.render(sprites)
        if mode == "rgb_array" or self._num_stacked_obss == 1:
            return obs
        self._stacked_obss.append(obs)
        return np.concatenate(self._stacked_obss[-self._num_stacked_obss:], axis=-1)

    # -- dynamics -------------------------------------------------------------

    def _get_dist(self, i: int, j: int) -> float:
        return norm(self._objs[i, 3:5] - self._objs[j, 3:5])

    def _cal_reward(self, reward, is_success, done):
        """Touch-the-target reward for Target/OddOneOut (reference: base.py:291-302)."""
        for i in range(self._num_objects):
            if norm(self._objs[i, 3:5] - self._objs[-1, 3:5]) < self._AGENT[2]:
                if i == self._target_obj_idx:
                    reward, is_success = 1.0, True
                else:
                    reward = 0.1 if self._rew_type == "normal" else 0.0
                    is_success = False
                done = True
                break
        return reward, is_success, done

    def reset(self):
        self._objs = self._set_objs()
        self.step_count = 0
        if self.render_mode == "state":
            blank = np.zeros((self._num_objs_range[1] + 1, self._config.state_size))
        else:
            blank = np.zeros((self._obs_size, self._obs_size, self._obs_channels))
        self._stacked_obss = [blank] * (self._num_stacked_obss - 1)
        return self.render()

    def step(self, act: int):
        """act in {0,1,2,3} = up, left, down, right (reference: base.py:328-360)."""
        reward, done = 0.0, False
        dist_before = self._get_dist(self._target_obj_idx, -1)
        deltas = {0: (4, +1), 1: (3, -1), 2: (4, -1), 3: (3, +1)}
        if act not in deltas:
            raise ValueError(f"action must be one of 0-3, not {act}")
        axis, sign = deltas[act]
        self._objs[-1, axis] += sign * self._moving_step_size
        half = self._AGENT[2] / 2
        self._objs[-1, 3] = np.clip(self._objs[-1, 3], half, 1 - half)
        self._objs[-1, 4] = np.clip(self._objs[-1, 4], half, 1 - half)
        self.step_count += 1
        if self.step_count >= self._max_steps:
            done = True
        if self._rew_type == "dense":
            closer = self._get_dist(self._target_obj_idx, -1) < dist_before
            reward = 0.01 if closer else -0.01
        return reward, False, done

    def render(self, mode=None, fill_empty=True):
        if mode is None:
            mode = self.render_mode
        if mode == "state":
            gt = np.zeros(self._objs.shape)
            for i in range(gt.shape[0]):
                if self._objs[i, 0] == -1:
                    gt[i, :3] = -1
                    continue
                gt[i, 0] = COLORS.index(self._objs[i, 0])
                gt[i, 1] = SHAPES.index(self._objs[i, 1])
                gt[i, 2] = SCALES.index(self._objs[i, 2])
                gt[i, 3:] = self._objs[i, 3:].astype(np.float64)
            gt = gt.astype(np.float32)
            if fill_empty:
                pad = self._num_objs_range[1] + 1 - gt.shape[0]
                if pad > 0:
                    gt = np.concatenate(
                        [gt, np.zeros((pad, self._config.state_size), dtype=np.float32)])
            if self._num_stacked_obss == 1:
                return gt
            self._stacked_obss.append(gt)
            return np.concatenate(self._stacked_obss[-self._num_stacked_obss:], axis=-1)
        if mode == "mask":
            masks = self._get_masks(self._objs)
            if fill_empty:
                pad = self._num_objs_range[1] + 2 - masks.shape[0]
                if pad > 0:
                    zeros = np.zeros((pad, self._obs_size, self._obs_size, 1))
                    masks = np.concatenate([masks[:-1], zeros, masks[-1:]], axis=0)
            return masks
        return self._draw_objs(self._objs, mode)

    def close(self):
        self._objs = None
        self.step_count = 0
