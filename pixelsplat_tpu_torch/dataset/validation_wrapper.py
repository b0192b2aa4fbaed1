"""Validation wrapper: a fixed number of examples per validation pass,
drawn from one stream kept across passes.

Port of `pixelsplat_tpu/dataset/validation_wrapper.py`.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional


class ValidationWrapper:
    def __init__(self, make_stream: Callable[[], Iterator[dict]], length: int):
        self.make_stream = make_stream
        self.length = length
        self._stream: Optional[Iterator[dict]] = None

    def __len__(self) -> int:
        return self.length

    def __iter__(self) -> Iterator[dict]:
        if self._stream is None:
            self._stream = iter(self.make_stream())
        for _ in range(self.length):
            yield next(self._stream)
