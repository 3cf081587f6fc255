"""The TriFinger backend interface and its fake kinematic backend for the
CausalWorld reach tasks (counterpart of ocrl_tpu/envs/cw_sim.py:31-262,
numpy only, draw for draw).

``envs.cw`` builds its task and wrapper logic on this small interface;
``FakeTriFingerBackend`` is a kinematic stand-in for causal_world's
simulator (which neither needs nor has pybullet), so the reach envs run on
any host. Its only difference from JAX's: ``render`` takes the optional
``mode`` argument that the vec envs pass (``render("rgb_array")``) and
ignores it; JAX's takes none and raises ``TypeError`` there.

Structured observation layout (reference: target.py:293-321):
  [0]      time left for task
  [1:10]   9 joint positions        [10:19] 9 joint velocities
  [19:28]  9 end-effector positions
  [28:68]  4 objects x (cartesian position 3, type 1, size 3, color 3)
"""

from __future__ import annotations

import numpy as np

ARENA_RADIUS = 0.15
FLOOR_HEIGHT = 0.0325
N_OBJECTS = 4

# raised single-finger joint pose (reference: target.py:105-120)
JOINTS_RAISED_POSITIONS = [-1.56, -0.08, -2.7] * 3
JOINTS_RAISED_ACTION = [-1.56, -0.08, -2.7]


def cart2cyl(position):
    """Cartesian [x, y, z] -> cylindrical [radius, angle, z]
    (causal_world.utils.rotation_utils.cart2cyl)."""
    x, y, z = position
    return np.array([np.hypot(x, y), np.arctan2(y, x), z])


def cyl2cart(position):
    r, theta, z = position
    return np.array([r * np.cos(theta), r * np.sin(theta), z])


class FakeStage:
    """Silhouette-object registry with CausalWorld's random_position surface
    (reference usage: target.py:161-167, cw stage.random_position)."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self.objects: dict[str, dict] = {}
        for i in range(N_OBJECTS):
            self.objects[f"obj_{i}"] = {
                "cartesian_position": np.array([0.0, -0.15 + 0.1 * i, 0.0]),
                "color": np.array([1.0, 0.0, 0.0]),
                "size": np.array([0.065, 0.065, 0.065]),
                "type": 1.0,
            }

    def random_position(self, height_limits=(FLOOR_HEIGHT, FLOOR_HEIGHT),
                        angle_limits=(-np.pi, np.pi)):
        radius = self._rng.uniform(0.04, 0.13)
        angle = self._rng.uniform(*angle_limits)
        z = self._rng.uniform(*height_limits)
        return cyl2cart([radius, angle, z])

    def get_object_state(self, name: str, key: str):
        return np.array(self.objects[name][key])

    def apply_interventions(self, interventions: dict) -> None:
        for name, change in interventions.items():
            if name not in self.objects:
                continue
            obj = self.objects[name]
            if "cylindrical_position" in change:
                obj["cartesian_position"] = cyl2cart(change["cylindrical_position"])
            if "cartesian_position" in change:
                obj["cartesian_position"] = np.asarray(change["cartesian_position"],
                                                       float)
            if "color" in change:
                obj["color"] = np.asarray(change["color"], float)
            if "size" in change:
                obj["size"] = np.asarray(change["size"], float)


class SingleFingerReachTask:
    """Sparse single-finger reach (reference: target.py:405-697).

    Reward is +1 when the controlled finger tip's mean |coordinate error| to
    the target object is below 0.021, else 0; an episode is done early when
    ANY object is reached (reference is_done, target.py:612-623)."""

    finger_idx = 1
    reach_threshold = 0.021

    def __init__(self, activate_sparse_reward: bool = True):
        self.activate_sparse_reward = activate_sparse_reward
        self.target_obj: str | None = None

    def _finger_tip(self, ee_positions):
        i = self.finger_idx * 3
        return np.asarray(ee_positions[i:i + 3])

    def goal_reward(self, ee_positions, goal_position):
        return float(np.mean(np.abs(np.asarray(goal_position)
                                    - self._finger_tip(ee_positions))))

    def fractional_success(self, goal_reward: float) -> float:
        clipped = np.clip(goal_reward, 0.01, 0.03)
        return float(1 - (clipped - 0.01) / 0.02)

    def reward(self, ee_positions, stage: "FakeStage") -> float:
        if self.target_obj is None:
            return 0.0
        goal = stage.get_object_state(self.target_obj, "cartesian_position")
        dist = self.goal_reward(ee_positions, goal)
        return 1.0 if dist < self.reach_threshold else 0.0

    def is_done(self, ee_positions, stage: "FakeStage") -> bool:
        for i in range(N_OBJECTS):
            goal = stage.get_object_state(f"obj_{i}", "cartesian_position")
            if self.goal_reward(ee_positions, goal) < self.reach_threshold:
                return True
        return False


class FakeTriFingerBackend:
    """Kinematic TriFinger stand-in implementing the backend interface.

    Joint-position control: each step moves joints toward the commanded
    positions with a velocity cap, and finger tips follow an explicit
    forward-kinematics map covering the arena, so a policy moving joint
    targets genuinely steers the controlled tip across the floor.
    """

    camera_size = 128
    n_cameras = 3

    def __init__(self, task: SingleFingerReachTask, seed: int = 0,
                 max_episode_length: int = 100, observation_mode="structured"):
        self._task = task
        self._rng = np.random.default_rng(seed)
        self._stage = FakeStage(self._rng)
        self._max_episode_length = max_episode_length
        self._observation_mode = observation_mode
        self._max_joint_step = 0.25
        self.joints = np.array(JOINTS_RAISED_POSITIONS)
        self.prev_joints = self.joints.copy()
        self.t = 0

    # -- kinematics -------------------------------------------------------------

    def _finger_tip_of(self, joints3, finger: int) -> np.ndarray:
        """Forward kinematics of one finger.  The raised pose maps high above
        the floor; sweeping the joints covers an annulus of the arena."""
        j0, j1, j2 = joints3
        base_angle = 2 * np.pi * finger / 3
        angle = base_angle + 0.6 * j0
        radius = np.clip(0.02 + 0.05 * (j1 + 1.56), 0.0, ARENA_RADIUS)
        z = np.clip(FLOOR_HEIGHT + 0.12 * (j2 + 2.7) / 2.7, 0.0, 0.4)
        return np.array([radius * np.cos(angle), radius * np.sin(angle), z])

    def end_effector_positions(self) -> np.ndarray:
        return np.concatenate([
            self._finger_tip_of(self.joints[3 * f:3 * f + 3], f)
            for f in range(3)])

    # -- backend interface --------------------------------------------------------

    @property
    def stage(self) -> FakeStage:
        return self._stage

    @property
    def task(self) -> SingleFingerReachTask:
        return self._task

    def reset(self):
        self.joints = np.array(JOINTS_RAISED_POSITIONS)
        self.prev_joints = self.joints.copy()
        self.t = 0
        return self._observation()

    def do_intervention(self, interventions: dict):
        if "joint_positions" in interventions:
            self.joints = np.asarray(interventions["joint_positions"], float)
        self._stage.apply_interventions(interventions)
        return True, self._observation()

    def step(self, action9):
        target = np.asarray(action9, float)
        self.prev_joints = self.joints.copy()
        delta = np.clip(target - self.joints,
                        -self._max_joint_step, self._max_joint_step)
        self.joints = self.joints + delta
        self.t += 1
        ee = self.end_effector_positions()
        reward = self._task.reward(ee, self._stage)
        done = (self.t >= self._max_episode_length
                or self._task.is_done(ee, self._stage))
        info = {"fractional_success": self._task.fractional_success(
            self._task.goal_reward(
                ee, self._stage.get_object_state(self._task.target_obj,
                                                 "cartesian_position"))
            if self._task.target_obj else 1.0)}
        return self._observation(), reward, done, info

    def _observation(self):
        if self._observation_mode == "pixel":
            return self.camera_images()
        ee = self.end_effector_positions()
        time_left = 1.0 - self.t / self._max_episode_length
        joint_vel = (self.joints - self.prev_joints)
        objs = []
        for i in range(N_OBJECTS):
            o = self._stage.objects[f"obj_{i}"]
            objs += [*o["cartesian_position"], o["type"], *o["size"], *o["color"]]
        return np.concatenate([[time_left], self.joints, joint_vel, ee, objs]
                              ).astype(np.float64)

    # -- rendering ----------------------------------------------------------------

    def _draw_top_view(self, size: int, with_finger: bool) -> np.ndarray:
        """Orthographic top-down view: colored squares on a gray arena floor,
        plus the controlled finger tip when requested."""
        img = np.full((size, size, 3), 40, np.uint8)

        def to_px(xy):
            return (int((xy[0] / ARENA_RADIUS * 0.5 + 0.5) * (size - 1)),
                    int((xy[1] / ARENA_RADIUS * 0.5 + 0.5) * (size - 1)))

        for i in range(N_OBJECTS):
            o = self._stage.objects[f"obj_{i}"]
            cx, cy = to_px(o["cartesian_position"][:2])
            half = max(1, int(o["size"][0] / (2 * ARENA_RADIUS) * size / 2))
            rgb = (np.asarray(o["color"]) * 255).astype(np.uint8)
            img[max(0, cy - half):cy + half, max(0, cx - half):cx + half] = rgb
        if with_finger:
            tip = self.end_effector_positions()[3:6]
            cx, cy = to_px(tip[:2])
            # finger drawn darker the higher it is
            shade = int(np.clip(255 - 600 * (tip[2] - FLOOR_HEIGHT), 60, 255))
            img[max(0, cy - 2):cy + 2, max(0, cx - 2):cx + 2] = (shade, shade, shade)
        return img

    def render(self, mode: str = "rgb_array") -> np.ndarray:
        """The 256x256 top view with the controlled finger tip; ``mode`` is
        taken for the vec envs' sake and ignored."""
        return self._draw_top_view(256, with_finger=True)

    def camera_images(self) -> np.ndarray:
        """[2 * n_cameras, H, W, 3] float in [0, 1]: first half tool cameras
        (scene with robot), second half goal cameras (silhouettes only) —
        the MyCausalWorld pixel layout (reference: cw.py:109-153)."""
        size = self.camera_size
        tool = self._draw_top_view(size, with_finger=True)
        goal = self._draw_top_view(size, with_finger=False)
        frames = []
        for cam in range(self.n_cameras):
            frames.append(np.roll(tool, cam * 7, axis=1))  # distinct viewpoints
        for cam in range(self.n_cameras):
            frames.append(np.roll(goal, cam * 7, axis=1))
        return np.stack(frames).astype(np.float32) / 255.0

    def close(self) -> None:
        return None
