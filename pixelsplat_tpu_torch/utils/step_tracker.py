"""Global-step channel from the trainer to data-loader worker processes.

Port of `pixelsplat_tpu/utils/step_tracker.py`: a lock-protected shared
int64, so forked `DataLoader` workers observe the trainer's step (it drives
the view sampler's curriculum).
"""

from __future__ import annotations

import multiprocessing as mp


class StepTracker:
    def __init__(self, initial_step: int = 0):
        self._value = mp.Value("q", initial_step)  # int64 + built-in lock

    def set_step(self, step: int) -> None:
        with self._value.get_lock():
            self._value.value = int(step)

    def get_step(self) -> int:
        with self._value.get_lock():
            return int(self._value.value)
