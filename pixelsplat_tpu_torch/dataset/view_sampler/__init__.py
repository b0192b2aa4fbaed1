"""View samplers and their registry.

Port of `pixelsplat_tpu/dataset/view_sampler/__init__.py`.
"""

from typing import Any, Optional, Union

from ...utils.step_tracker import StepTracker
from ..types import Stage
from .view_sampler import ViewSampler
from .view_sampler_all import ViewSamplerAll, ViewSamplerAllCfg
from .view_sampler_arbitrary import ViewSamplerArbitrary, ViewSamplerArbitraryCfg
from .view_sampler_bounded import ViewSamplerBounded, ViewSamplerBoundedCfg
from .view_sampler_evaluation import ViewSamplerEvaluation, ViewSamplerEvaluationCfg

VIEW_SAMPLERS = {
    "all": ViewSamplerAll,
    "arbitrary": ViewSamplerArbitrary,
    "bounded": ViewSamplerBounded,
    "evaluation": ViewSamplerEvaluation,
}

ViewSamplerCfg = Union[
    ViewSamplerArbitraryCfg,
    ViewSamplerBoundedCfg,
    ViewSamplerEvaluationCfg,
    ViewSamplerAllCfg,
]


def get_view_sampler(
    cfg: ViewSamplerCfg,
    stage: Stage,
    overfit: bool,
    cameras_are_circular: bool,
    step_tracker: Optional[StepTracker],
) -> ViewSampler[Any]:
    return VIEW_SAMPLERS[cfg.name](cfg, stage, overfit, cameras_are_circular, step_tracker)
