"""The encoder's stages as CUDA graphs, captured once per input signature and
replayed on every call.

An evaluation encode is a few hundred kernel launches, and on an H100 the
host issues them more slowly than the card runs them, so without graphs the
card idles through most of the encode. A graph replay issues a stage's
launches at once. Each stage (`encoder.backbone`, `encoder.epipolar`,
`encoder.refine`, `encoder.heads` of the epipolar encoder; six of the
cost-volume encoder; three of GS-LRM's) is its own graph, so that each keeps its span around
its replay and its device time. A signature's graphs share one memory pool
and replay in order on the current stream.

Capture runs the stages once eagerly on a side stream (kernel builds,
library handles, the device constants of `utils/device_constants.py`), then
captures each stage on static copies of the inputs, with the tracer held
(`tracing.held`): the launches each graph holds are counted at each replay.
A replay copies the call's inputs into the static ones, replays, and clones
the outputs, so that nothing returned aliases graph memory.

An encoder asks `EncoderGraphs.replays` whether a call may run graphs and
hands `EncoderGraphs.run` its stages, its inputs and the Python values its
stages read: the graphs are valid for one set of input shapes, strides and
dtypes, those values, the TF32 switches, and the weights' storage. In-place
updates of the weights are read by the replays.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ...utils import tracing


class Stage(NamedTuple):
    """One stage: `run(*inputs)` -> the value stored under `output`, read
    from and written to the names of the encode's inputs and outputs."""

    span: str
    run: Callable[..., Any]
    inputs: tuple[str, ...]
    output: str


def run_eagerly(stages: list[Stage], inputs: dict[str, Optional[torch.Tensor]]):
    """The last stage's output for `inputs`, each stage run as it comes,
    under its span."""
    values = dict(inputs)
    for stage in stages:
        with tracing.span(stage.span):
            values[stage.output] = stage.run(*(values[name] for name in stage.inputs))
    return values[stages[-1].output]


def _clone(value):
    if isinstance(value, tuple):  # the Gaussians, a NamedTuple of tensors or None
        return type(value)(*(None if t is None else t.clone() for t in value))
    return value.clone()


class _Captured:
    """One signature's graphs, their static inputs and output."""

    def __init__(self, stages: list[Stage], inputs: dict[str, Optional[torch.Tensor]], weights: tuple):
        self.weights = weights
        self.inputs = {name: None if t is None else t.clone() for name, t in inputs.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with tracing.held(), torch.cuda.stream(side):
            values = dict(self.inputs)
            for stage in stages:
                values[stage.output] = stage.run(*(values[name] for name in stage.inputs))
        torch.cuda.current_stream().wait_stream(side)
        del values
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        values = dict(self.inputs)
        for stage in stages:
            graph = torch.cuda.CUDAGraph()
            # Thread-local: a data loader's thread may pin memory meanwhile.
            with tracing.held() as launches, torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                values[stage.output] = stage.run(*(values[name] for name in stage.inputs))
            self.graphs.append((stage.span, graph, launches))
        self.output = values[stages[-1].output]

    def replay(self, inputs: dict[str, Optional[torch.Tensor]]):
        for name, t in inputs.items():
            if t is not None:
                self.inputs[name].copy_(t)
        for span, graph, launches in self.graphs[:-1]:
            with tracing.span(span):
                graph.replay()
            tracing.count_launches(launches)
        span, graph, launches = self.graphs[-1]
        with tracing.span(span):
            graph.replay()
            output = _clone(self.output)
        tracing.count_launches(launches)
        return output


class EncoderGraphs:
    """The captured graphs of one encoder, by signature."""

    def __init__(self):
        self._captured: dict = {}
        self._weight_slots: Optional[list] = None

    @staticmethod
    def replays(image: torch.Tensor, u: Optional[torch.Tensor], visualization_dump: Optional[dict],
                capturing: bool) -> bool:
        """Whether an encode of `image` replays graphs: only where nothing
        outside the returned Gaussians reads the stages (autograd, the
        visualization dump, an encoder's own capture of intermediates,
        `capturing`, a caller's own stream capture) and the inputs would run
        on one CUDA device eagerly too."""
        return (
            image.is_cuda
            and not torch.is_grad_enabled()
            and visualization_dump is None
            and not capturing
            and not torch.is_autocast_enabled()
            and not torch.cuda.is_current_stream_capturing()
            and (u is None or u.device == image.device)
        )

    def _weight_storage(self, module: torch.nn.Module) -> tuple:
        """Where each parameter and buffer of `module` lives now: a replaced
        tensor or storage changes it, an in-place update does not."""
        if self._weight_slots is None:
            self._weight_slots = [
                (slots, name)
                for sub in module.modules()
                for slots in (sub._parameters, sub._buffers)
                for name, t in slots.items()
                if t is not None
            ]
        return tuple(slots[name].data_ptr() for slots, name in self._weight_slots)

    def run(self, module: torch.nn.Module, stages: list[Stage], inputs: dict[str, Optional[torch.Tensor]],
            values: tuple):
        """The last stage's output for `inputs`: replayed from the graphs of
        this call's signature (`values`, the Python values the stages read,
        the TF32 switches and the inputs' shapes, strides, dtypes and
        devices), captured first where there are none or the storage of
        `module`'s weights changed since."""
        key = (
            *values,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            tuple(None if t is None else (n, t.shape, t.stride(), t.dtype, t.device) for n, t in inputs.items()),
        )
        weights = self._weight_storage(module)
        captured = self._captured.get(key)
        if captured is None or captured.weights != weights:
            self._captured.pop(key, None)  # free the stale graphs' pool first
            captured = self._captured[key] = _Captured(stages, inputs, weights)
            tracing.count_always("encoder_graph_captures")
        tracing.count_always("encoder_graph_scenes")
        return captured.replay(inputs)
