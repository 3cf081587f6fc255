"""Rollout videos (counterpart of ocrl_tpu/rl/video.py:12-47): GIFs of the
first env's frames during training, written by ``utils.gif`` (no imageio).

JAX's trigger rule: recording starts at the first call with
``num_timesteps`` at or past the next trigger (0 at first), takes one frame
a call (``vec_env.render_frame()``) and, after ``length`` frames, writes
``<out_dir>/rollout_step{start}.gif`` (``start`` the ``num_timesteps`` at
which it began). The next trigger is then ``num_timesteps + interval``,
counted from the flush, not from the start: with many envs a vector step
advances ``num_timesteps`` by the number of envs, and ``start + interval``
may already lie behind. ``close`` writes what a recording holds so far.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import gif


class VideoRecorder:
    """Records ``length`` frames from env 0 every ``interval`` timesteps."""

    def __init__(self, out_dir: str | Path, interval: int, length: int):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.interval = max(int(interval), 1)
        self.length = int(length)
        self.frames: list[np.ndarray] = []
        self.recording = False
        self.next_trigger = 0
        self.start_step = 0
        self.written: list[Path] = []

    def maybe_record(self, vec_env, num_timesteps: int) -> None:
        if not self.recording and num_timesteps >= self.next_trigger:
            self.recording = True
            self.start_step = num_timesteps
        if self.recording:
            self.frames.append(np.asarray(vec_env.render_frame(), np.uint8))
            if len(self.frames) >= self.length:
                self._flush()
                self.next_trigger = num_timesteps + self.interval

    def _flush(self) -> None:
        if self.frames:
            path = self.out_dir / f"rollout_step{self.start_step}.gif"
            gif.write(path, self.frames)
            self.written.append(path)
        self.frames = []
        self.recording = False

    def close(self) -> None:
        if self.recording:
            self._flush()
