"""Task environments over the sprite arena (counterpart of
ocrl_tpu/envs/tasks.py, draw for draw): Target, RandomObjs, OddOneOut, Push
and Maze."""

from __future__ import annotations

import copy

import numpy as np

from . import spaces
from .base import BaseEnv, norm


class TargetEnv(BaseEnv):
    """Reach the object with the fixed target properties (reference: target.py)."""

    def __init__(self, config, seed):
        super().__init__(config, seed)
        self._target = list(config.target)

    def _random_nontarget_properties(self):
        while True:
            color = self._rng.choice(self._COLORS)
            shape = self._rng.choice(self._SHAPES)
            scale = self._rng.choice(self._SCALES)
            if not (color == self._target[0] and shape == self._target[1]
                    and scale == self._target[2]):
                return color, shape, scale

    def _set_objs(self):
        objs = super()._set_objs()
        self._target_obj_idx = self._rng.randint(self._num_objects)
        for i in range(self._num_objects):
            if i == self._target_obj_idx:
                objs[i, :3] = self._target
            else:
                objs[i, :3] = self._random_nontarget_properties()
        return self._fill_positions(
            objs,
            agent_eps=self._config.distance_to_agent,
            objs_eps=self._config.distance_to_objs,
            wall_eps=self._config.distance_to_wall,
        )

    def step(self, act):
        reward, is_success, done = super().step(act)
        reward, is_success, done = self._cal_reward(reward, is_success, done)
        return self.render(), reward, done, {"is_success": is_success}


class RandomObjsEnv(BaseEnv):
    """Task-free env for dataset generation (reference: randomobjs.py)."""

    def _set_objs(self):
        objs = super()._set_objs()
        for i in range(self._num_objects):
            objs[i, 0] = self._rng.choice(self._COLORS)
            objs[i, 1] = self._rng.choice(self._SHAPES)
            objs[i, 2] = self._rng.choice(self._SCALES)
        return self._fill_positions(
            objs,
            agent_eps=self._config.distance_to_agent,
            objs_eps=self._config.distance_to_objs,
            wall_eps=self._config.distance_to_wall,
        )

    def _cal_reward(self, reward, is_success, done):
        for i in range(self._num_objects):
            if norm(self._objs[i, 3:5] - self._objs[-1, 3:5]) < self._AGENT[2]:
                return 1.0, True, True
        return reward, is_success, done

    def step(self, act):
        reward, is_success, done = super().step(act)
        reward, is_success, done = self._cal_reward(reward, is_success, done)
        return self.render(), reward, done, {"is_success": is_success}


class OddOneOutEnv(BaseEnv):
    """Reach the property-unique object (reference: oddoneout.py).

    ``obj_comp=True`` makes all distractors identical (object comparison);
    ``unseen_combi_mode`` implements the train/test OOD property-pair splits.
    """

    def __init__(self, config, seed):
        super().__init__(config, seed)
        self._unseen_combi_mode = config.unseen_combi_mode
        self._unseen_combi = list(config.unseen_combi)
        self._obj_comp = config.obj_comp

    def _pick_distractor_prop(self, unique_property, properties, prop_idx):
        """Sample a distractor property value, honouring unseen-combi splits
        (reference: oddoneout.py:19-52)."""
        while True:
            prop = self._rng.choice(properties)
            if prop == unique_property:
                continue
            if self._unseen_combi_mode is None or prop_idx != 0:
                return prop
            in_combi = (
                (unique_property == self._unseen_combi[0] and prop == self._unseen_combi[1])
                or (unique_property == self._unseen_combi[1] and prop == self._unseen_combi[0])
            )
            if self._unseen_combi_mode == "train" and not in_combi:
                return prop
            if self._unseen_combi_mode == "test" and in_combi:
                return prop

    def _fill_properties(self, objs, unique_property, properties, idx):
        """Assign the remaining objects' property `idx` in random group sizes
        so no distractor is unique (reference: oddoneout.py:19-64)."""
        while np.sum(objs[:, idx] == 0) > 0:
            prop = self._pick_distractor_prop(unique_property, properties, idx)
            remaining = int(np.sum(objs[:, idx] == 0))
            count = self._rng.randint(2, remaining + 1)
            while count > 0:
                j = self._rng.randint(len(objs))
                if objs[j, idx] == 0:
                    objs[j, idx] = prop
                    count -= 1
            if np.sum(objs[:, idx] == 0) == 1:
                objs[objs[:, idx] == 0, idx] = prop
        return objs

    def _set_objs(self):
        objs = super()._set_objs()
        if self._unseen_combi_mode is not None:
            target_obj_idx = 0  # fixed index so the combi rule applies
        else:
            target_obj_idx = self._rng.randint(self._num_objects)

        types = []
        if len(self._COLORS) > 1:
            types.append("color")
        if len(self._SHAPES) > 1:
            types.append("shape")
        if len(self._SCALES) > 1:
            types.append("scale")
        rand_type = self._rng.choice(types)

        pools = {"color": (0, self._COLORS), "shape": (1, self._SHAPES),
                 "scale": (2, self._SCALES)}
        col, pool = pools[rand_type]
        unique_property = self._rng.choice(pool)
        if rand_type == "color" and self._unseen_combi_mode == "test":
            while unique_property not in self._unseen_combi:
                unique_property = self._rng.choice(pool)
        objs[target_obj_idx, col] = unique_property
        if self._obj_comp:
            # all distractors share every property except the unique one
            for other_col, other_pool in pools.values():
                if other_col != col:
                    objs[:-1, other_col] = self._rng.choice(other_pool)

        objs = self._fill_properties(objs, unique_property, self._COLORS, 0)
        objs = self._fill_properties(objs, unique_property, self._SHAPES, 1)
        objs = self._fill_properties(objs, unique_property, self._SCALES, 2)
        objs = self._fill_positions(
            objs,
            agent_eps=self._config.distance_to_agent,
            objs_eps=self._config.distance_to_objs,
            wall_eps=self._config.distance_to_wall,
        )
        self._target_obj_idx = target_obj_idx
        return objs

    def step(self, act):
        reward, is_success, done = super().step(act)
        reward, is_success, done = self._cal_reward(reward, is_success, done)
        return self.render(), reward, done, {"is_success": is_success}


class PushEnv(BaseEnv):
    """Push the target object into the corner goal zone (reference: push.py).

    Object table layout: [objects..., goal, agent]; goal lives in the GT state,
    hence the +2 row observation space.
    """

    def __init__(self, config, seed):
        super().__init__(config, seed)
        self._target = list(config.target)
        if self.render_mode == "state":
            self.observation_space = spaces.Box(
                low=0, high=1,
                shape=(self._num_objs_range[1] + 2, config.state_size),
                dtype=np.float64,
            )

    def _set_objs(self):
        objs = super()._set_objs()
        self._target_obj_idx = 0
        for i in range(self._num_objects):
            if i == self._target_obj_idx:
                objs[i, :3] = self._target
            else:
                while True:
                    color = self._rng.choice(self._COLORS)
                    shape = self._rng.choice(self._SHAPES)
                    scale = self._rng.choice(self._SCALES)
                    if not (color == self._target[0] and shape == self._target[1]
                            and scale == self._target[2]):
                        break
                objs[i, :3] = (color, shape, scale)
        goal = np.zeros(5, dtype=object)
        goal[:3] = objs[self._target_obj_idx, :3]
        radius = objs[self._target_obj_idx, 2] / 2
        goal[3:5] = [radius, radius]  # corner goal zone
        objs = np.insert(objs, self._num_objects, goal, axis=0)
        return self._fill_positions(
            objs,
            agent_eps=self._config.distance_to_agent,
            objs_eps=self._config.distance_to_objs,
            wall_eps=self._config.distance_to_wall,
        )

    def _cal_reward(self, reward, is_success, done, eps=1e-6):
        for i in range(self._num_objects):
            touch = (norm(self._objs[i, 3:5] - self._objs[-2, 3:5]) + eps
                     < self._objs[i, 2] / 2 + self._objs[-2, 2] / 2)
            if touch:
                if i == self._target_obj_idx:
                    reward, is_success = 1.0, True
                else:
                    reward = 0.1 if self._rew_type == "normal" else 0.0
                    is_success = False
                done = True
                break
        return reward, is_success, done

    def _check_can_move(self, obj_idx, axis, eps=1e-6):
        for i in range(self._num_objects):
            if i == obj_idx:
                continue
            if (norm(self._objs[i, 3:5] - self._objs[obj_idx, 3:5]) + eps
                    < self._objs[i, 2] / 2 + self._objs[obj_idx, 2] / 2):
                return False
        return True

    def _move_objs(self, axis, delta, eps=1e-6):
        """Agent push physics (reference: push.py:96-130)."""
        self._objs[-1, axis] += delta
        moves = [delta]
        for i in range(self._num_objects):
            touching = (norm(self._objs[i, 3:5] - self._objs[-1, 3:5]) + eps
                        < self._objs[i, 2] / 2 + self._AGENT[2] / 2)
            if not touching:
                continue
            at_wall = (self._objs[i, axis] == self._objs[i, 2] / 2
                       or self._objs[i, axis] == 1 - self._objs[i, 2] / 2)
            if at_wall:
                moves.append(0)
                break
            before = copy.deepcopy(self._objs[i, axis])
            self._objs[i, axis] += delta
            if not self._check_can_move(i, axis):
                self._objs[i, axis] -= delta
                moves.append(0)
                break
            self._objs[i, axis] = np.clip(
                self._objs[i, axis], self._objs[i, 2] / 2, 1 - self._objs[i, 2] / 2)
            moves.append(self._objs[i, axis] - before)
        # the agent only advances as far as the most-blocked pushed object
        if delta > 0:
            self._objs[-1, axis] = self._objs[-1, axis] - delta + np.min(moves)
        else:
            self._objs[-1, axis] = self._objs[-1, axis] - delta + np.max(moves)

    def step(self, act):
        reward, is_success, done = 0.0, False, False
        dist_before = self._get_dist(self._target_obj_idx, -2)
        moves = {0: (4, +1), 1: (3, -1), 2: (4, -1), 3: (3, +1)}
        if act not in moves:
            raise ValueError(f"action must be one of 0-3, not {act}")
        axis, sign = moves[act]
        self._move_objs(axis, sign * self._moving_step_size)
        half = self._AGENT[2] / 2
        self._objs[-1, 3] = np.clip(self._objs[-1, 3], half, 1 - half)
        self._objs[-1, 4] = np.clip(self._objs[-1, 4], half, 1 - half)
        self.step_count += 1
        if self.step_count >= self._max_steps:
            done = True
        if self._rew_type == "dense":
            moved = self._get_dist(self._target_obj_idx, -2) != dist_before
            reward = 0.01 if moved else 0.0
        reward, is_success, done = self._cal_reward(reward, is_success, done)
        return self.render(), reward, done, {"is_success": is_success}


class MazeEnv(BaseEnv):
    """Navigate to a goal point, optional walls (reference: maze.py)."""

    def __init__(self, config, seed):
        super().__init__(config, seed)
        self._walls: list = []
        self._task_types = [[None, None, 0.5, 0.5]]
        self._goal = None
        if self._rew_type == "dense":
            self._dense_rews = [0.1] * len(self._walls)
        if self.render_mode == "state":
            self.observation_space = spaces.Box(
                low=0, high=1,
                shape=(self._num_objs_range[1] + 2, config.state_size),
                dtype=np.float64,
            )

    def _set_objs(self):
        objs = super()._set_objs()
        for i in range(self._num_objects):
            objs[i, 0] = self._rng.choice(self._COLORS)
            objs[i, 1] = self._rng.choice(self._SHAPES)
            objs[i, 2] = self._rng.choice(self._SCALES)
        objs = self._fill_positions(
            objs,
            agent_eps=self._config.distance_to_agent,
            objs_eps=self._config.distance_to_objs,
            wall_eps=self._config.distance_to_wall,
        )
        task = self._task_types[self._rng.randint(len(self._task_types))]
        self._goal = task[-2:]
        if task[0] is not None:
            objs[-1, 3:5] = task[:2]
        goal = np.zeros(5, dtype=object) - 1
        goal[3:5] = task[-2:]
        return np.insert(objs, self._num_objects, goal, axis=0)

    def _cal_reward(self, reward, is_success, done):
        if norm(np.asarray(self._goal) - self._objs[-1, 3:5]) < self._AGENT[2] / 2:
            return 1.0, True, True
        return reward, is_success, done

    def reset(self):
        self._dense_rews = [0.1] * len(self._walls)
        return super().reset()

    def _move_agent(self, axis, delta):
        before = copy.deepcopy(self._objs[-1, axis])
        self._objs[-1, axis] += delta
        half = self._AGENT[2] / 2
        self._objs[-1, axis] = np.clip(self._objs[-1, axis], half, 1 - half)
        for wall in self._walls:
            crosses_x = (self._objs[-1, 3] - half < wall[0] < self._objs[-1, 3] + half)
            if crosses_x:
                in_gap = (wall[1][0] <= self._objs[-1, 4] - half
                          and self._objs[-1, 4] + half <= wall[1][1])
                if not in_gap:
                    self._objs[-1, axis] = before
                break

    def step(self, act):
        reward, is_success, done = 0.0, False, False
        moves = {0: (4, +1), 1: (3, -1), 2: (4, -1), 3: (3, +1)}
        if act not in moves:
            raise ValueError(f"action must be one of 0-3, not {act}")
        axis, sign = moves[act]
        self._move_agent(axis, sign * self._moving_step_size)
        self.step_count += 1
        if self.step_count >= self._max_steps:
            done = True
        if self._rew_type == "dense":
            for w_idx, wall in enumerate(self._walls):
                low = 0.0 if w_idx == 0 else self._walls[w_idx - 1][0]
                if low <= self._objs[-1, 3] <= wall[0]:
                    reward = self._dense_rews[w_idx]
                    self._dense_rews[w_idx] = 0.0
                    break
        reward, is_success, done = self._cal_reward(reward, is_success, done)
        return self.render(), reward, done, {"is_success": is_success}
