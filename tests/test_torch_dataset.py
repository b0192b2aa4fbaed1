"""The port's data pipeline against the JAX package's, on the CPU.

The evaluation protocol's batches (the repo's re10k fixture under the
evaluation index, `+experiment=re10k` at 256x256) must equal the JAX
`DataModule`'s bit for bit, float32 cameras included. The other samplers,
the crop and augmentation shims and the training stream are held on
synthetic chunks built as `tests/test_dataset.py` builds them, with the same
seeds on both sides. The port's `DataLoader` workers must give the same
examples as the inline stream.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pixelsplat_tpu import config as jx_config
from pixelsplat_tpu.dataset import get_dataset as jx_get_dataset
from pixelsplat_tpu.dataset import data_module as jx_data_module
from pixelsplat_tpu.dataset.dataset_re10k import DatasetRE10kCfg as JxDatasetCfg
from pixelsplat_tpu.dataset.shims import augmentation_shim as jx_augmentation
from pixelsplat_tpu.dataset.shims import crop_shim as jx_crop
from pixelsplat_tpu.dataset import view_sampler as jx_samplers
from pixelsplat_tpu.utils.step_tracker import StepTracker as JxStepTracker
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.dataset import get_dataset as pt_get_dataset
from pixelsplat_tpu_torch.dataset import data_module as pt_data_module
from pixelsplat_tpu_torch.dataset.dataset_re10k import DatasetRE10kCfg as PtDatasetCfg
from pixelsplat_tpu_torch.dataset.shims import augmentation_shim as pt_augmentation
from pixelsplat_tpu_torch.dataset.shims import crop_shim as pt_crop
from pixelsplat_tpu_torch.dataset import view_sampler as pt_samplers
from pixelsplat_tpu_torch.utils.step_tracker import StepTracker as PtStepTracker

import test_dataset as jx_dataset_tests

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures"
EVAL_OVERRIDES = [
    "+experiment=re10k",
    "mode=test",
    f"dataset.roots=[{FIXTURE / 're10k'}]",
    "dataset/view_sampler=evaluation",
    f"dataset.view_sampler.index_path={FIXTURE / 'evaluation_index_fixture.json'}",
]


def assert_examples_equal(got, want, where=""):
    """Nested dicts of arrays equal bit for bit, dtypes included; other
    leaves (scene names) equal."""
    assert set(got) == set(want), where
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            assert_examples_equal(g, w, f"{where}/{key}")
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, f"{where}/{key}"
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{key}")
        else:
            assert g == w, f"{where}/{key}"


def data_modules(overrides, **module_kwargs):
    """The two packages' DataModules from the same overrides."""
    jcfg = jx_config.load_config(overrides)
    pcfg = pt_config.load_config(overrides)
    jdm = jx_data_module.DataModule(jcfg.dataset, jcfg.data_loader, JxStepTracker(), **module_kwargs)
    pdm = pt_data_module.DataModule(pcfg.dataset, pcfg.data_loader, PtStepTracker(), **module_kwargs)
    return jdm, pdm


# ---------------------------------------------------------------------------
# The evaluation protocol's data: the fixture under the evaluation index


def test_evaluation_batches_equal_jax():
    inline = ["data_loader.test.num_workers=0"]
    jdm, pdm = data_modules(EVAL_OVERRIDES + inline)
    want = list(jdm.test_dataloader())
    got = list(pdm.test_dataloader())
    assert [b["scene"] for b in got] == [["fixture_scene_a"], ["fixture_scene_b"]]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_examples_equal(g, w, g["scene"][0])
        assert g["context"]["image"].shape == (1, 2, 3, 256, 256)
        assert g["target"]["image"].shape == (1, 3, 3, 256, 256)
        assert g["target"]["extrinsics"].dtype == g["target"]["intrinsics"].dtype == np.float32
    index = json.loads((FIXTURE / "evaluation_index_fixture.json").read_text())
    for batch in got:
        entry = index[batch["scene"][0]]
        np.testing.assert_array_equal(batch["context"]["index"][0], entry["context"])
        np.testing.assert_array_equal(batch["target"]["index"][0], entry["target"])


# Loaders with worker processes run in a fresh interpreter without JAX: the
# workers are forked, and this process holds JAX's threads. Each compares
# the workers' batches with the inline stream's there and prints the scenes.
WORKERS_VS_INLINE = """
import sys
import numpy as np
from pixelsplat_tpu_torch.config import load_config
from pixelsplat_tpu_torch.dataset.data_module import DataModule

def batches(overrides):
    cfg = load_config(overrides)
    return list(DataModule(cfg.dataset, cfg.data_loader).test_dataloader())

def leaves(tree, prefix=""):
    for k, v in tree.items():
        yield from leaves(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)]

overrides, workers = sys.argv[2:], int(sys.argv[1])
with_workers = batches(overrides + [f"data_loader.test.num_workers={workers}"])
inline = batches(overrides + ["data_loader.test.num_workers=0"])
got = {b["scene"][0]: dict(leaves(b)) for b in with_workers}
want = {b["scene"][0]: dict(leaves(b)) for b in inline}
assert sorted(got) == sorted(want) and len(with_workers) == len(inline), (sorted(got), sorted(want))
for scene in want:
    for key, value in want[scene].items():
        if isinstance(value, np.ndarray):
            assert got[scene][key].dtype == value.dtype and np.array_equal(got[scene][key], value), (scene, key)
        else:
            assert got[scene][key] == value, (scene, key)
print(" ".join(b["scene"][0] for b in with_workers))
"""


def workers_vs_inline(workers, overrides):
    proc = subprocess.run(
        [sys.executable, "-c", WORKERS_VS_INLINE, str(workers), *overrides],
        env={**os.environ, "PYTHONPATH": str(ROOT)}, cwd=ROOT, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.split()


def test_evaluation_loader_with_configured_workers_ends_and_equals_inline():
    """`config/main.yaml`'s 4 test workers over the fixture's one chunk:
    workers 1-3 get no chunk and yield nothing; the loader ends and gives
    the inline stream's batches, in its order."""
    assert pt_config.load_config(EVAL_OVERRIDES).data_loader.test.num_workers == 4
    assert workers_vs_inline(4, EVAL_OVERRIDES) == ["fixture_scene_a", "fixture_scene_b"]


@pytest.mark.parametrize("rank", [0, 1])
def test_test_stage_shards_chunks_across_ranks_like_jax(rank, synthetic_root):
    """Two ranks of two inline workers each: the same chunks, in the global
    (rank x worker) id space, as the JAX DataModule."""
    overrides = [
        f"dataset.roots=[{synthetic_root}]", "dataset/view_sampler=bounded", "dataset.image_shape=[64,96]",
        "dataset.view_sampler.max_distance_between_context_views=6", "data_loader.test.num_workers=0",
    ]
    jdm, pdm = data_modules(overrides, global_rank=rank, world_size=2)
    want = list(jdm.test_dataloader())
    got = list(pdm.test_dataloader())
    assert [b["scene"] for b in got] == [b["scene"] for b in want] == [[s] for s in SCENES["test"][rank]]
    for g, w in zip(got, want):
        assert_examples_equal(g, w)


# ---------------------------------------------------------------------------
# Synthetic chunks (tests/test_dataset.py's make_chunk): two test chunks so that
# two workers both get one.

SCENES = {"train": [["a", "b"]], "test": [["c", "d"], ["e", "f"]]}


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    import torch

    root = tmp_path_factory.mktemp("re10k")
    rng = np.random.default_rng(0)
    for stage, chunks in SCENES.items():
        d = root / stage
        d.mkdir()
        index = {}
        for i, scenes in enumerate(chunks):
            torch.save(jx_dataset_tests.make_chunk(scenes, rng), d / f"{i:06d}.torch")
            index.update({s: f"{i:06d}.torch" for s in scenes})
        json.dump(index, (d / "index.json").open("w"))
    return root


def bounded(pkg, **kw):
    return pkg.ViewSamplerBoundedCfg(**{
        "num_context_views": 2, "num_target_views": 2,
        "min_distance_between_context_views": 3, "max_distance_between_context_views": 6, **kw,
    })


SAMPLERS = {
    "bounded": lambda pkg: bounded(pkg),
    "bounded_3_views": lambda pkg: bounded(pkg, num_context_views=3),
    "bounded_curriculum": lambda pkg: bounded(
        pkg, warm_up_steps=100, initial_min_distance_between_context_views=2,
        initial_max_distance_between_context_views=2,
    ),
    "arbitrary": lambda pkg: pkg.ViewSamplerArbitraryCfg(num_context_views=2, num_target_views=3),
    "arbitrary_pinned_third": lambda pkg: pkg.ViewSamplerArbitraryCfg(
        num_context_views=3, num_target_views=2, context_views=[1, 9], target_views=[4, 6]
    ),
    "all": lambda pkg: pkg.ViewSamplerAllCfg(),
}


def dataset_pair(root, sampler_cfgs, stage, seed, step=0, **cfg_kw):
    jtracker, ptracker = JxStepTracker(step), PtStepTracker(step)
    common = dict(image_shape=(64, 96), roots=(root,), **cfg_kw)
    jds = jx_get_dataset(JxDatasetCfg(view_sampler=sampler_cfgs[0], **common), stage, jtracker, seed=seed)
    pds = pt_get_dataset(PtDatasetCfg(view_sampler=sampler_cfgs[1], **common), stage, ptracker, seed=seed)
    return jds, pds


# (sampler, stage): every sampler in the test stage, and those that draw
# from the generator in the train stage too.
SAMPLER_STAGES = [(name, "test") for name in sorted(SAMPLERS)] + [
    (name, "train") for name in sorted(SAMPLERS) if name != "all"
]


@pytest.mark.parametrize("sampler, stage", SAMPLER_STAGES)
def test_samplers_and_shims_equal_jax(synthetic_root, sampler, stage):
    """Every example of a stage through each sampler, the augmentation shim
    (train) and the crop shim: bit-equal, with the same generator draws."""
    make = SAMPLERS[sampler]
    step = 50 if sampler == "bounded_curriculum" else 0
    jds, pds = dataset_pair(synthetic_root, (make(jx_samplers), make(pt_samplers)), stage, seed=7, step=step)
    want, got = list(jds), list(pds)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_examples_equal(g, w, f"{sampler}/{g['scene']}")
    assert jds.rng.random() == pds.rng.random()  # the generators drew alike


def test_evaluation_sampler_skips_scenes_without_an_entry(synthetic_root, tmp_path):
    index_path = tmp_path / "eval_index.json"
    json.dump({"c": {"context": [0, 5], "target": [1, 2, 3]}, "d": None, "e": {"context": [2, 8], "target": [4]}},
              index_path.open("w"))
    jds, pds = dataset_pair(
        synthetic_root,
        (jx_samplers.ViewSamplerEvaluationCfg(index_path=index_path, num_context_views=3),
         pt_samplers.ViewSamplerEvaluationCfg(index_path=index_path, num_context_views=3)),
        "test", seed=0,
    )
    want, got = list(jds), list(pds)
    assert [g["scene"] for g in got] == ["c", "e"]
    np.testing.assert_array_equal(got[1]["context"]["index"], [2, 5, 8])  # the third view added
    for g, w in zip(got, want):
        assert_examples_equal(g, w, g["scene"])


def test_add_third_context_index_equals_jax():
    indices = np.random.default_rng(3).integers(0, 100, (5, 2))
    np.testing.assert_array_equal(
        pt_samplers.view_sampler_evaluation.add_third_context_index(indices),
        jx_samplers.view_sampler_evaluation.add_third_context_index(indices),
    )


def test_arbitrary_sampler_refuses_a_config_that_disagrees_with_itself():
    cfg = pt_samplers.ViewSamplerArbitraryCfg(num_context_views=2, context_views=[0, 1, 2])
    with pytest.raises(ValueError, match="context views"):
        pt_samplers.get_view_sampler(cfg, "train", False, False, None)


@pytest.mark.parametrize(
    "shape", [(64, 96), (256, 256), (180, 320), (66, 98)], ids=lambda s: f"{s[0]}x{s[1]}"
)
def test_crop_shim_equals_jax(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    views = {
        "image": rng.uniform(0, 1, (2, 3, 3, 90, 160)).astype(np.float32),
        "intrinsics": np.tile(np.asarray([[0.9, 0, 0.5], [0, 1.6, 0.5], [0, 0, 1]], np.float32), (2, 3, 1, 1)),
        "extrinsics": rng.normal(size=(2, 3, 4, 4)).astype(np.float32),
    }
    small = tuple(s // 4 for s in shape)
    example = {"context": views, "target": views, "scene": "s"}
    assert_examples_equal(pt_crop.apply_crop_shim(example, small), jx_crop.apply_crop_shim(example, small))


def test_augmentation_shim_equals_jax():
    rng = np.random.default_rng(11)
    flips = 0
    j_rng, p_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(8):
        views = {
            "image": rng.uniform(0, 1, (2, 3, 8, 12)).astype(np.float32),
            "extrinsics": rng.normal(size=(2, 4, 4)).astype(np.float32),
        }
        example = {"context": views, "target": dict(views), "scene": "s"}
        got = pt_augmentation.apply_augmentation_shim(example, p_rng)
        want = jx_augmentation.apply_augmentation_shim(example, j_rng)
        assert_examples_equal(got, want)
        flips += got is not example
    assert 0 < flips < 8  # both branches ran


@pytest.mark.parametrize("seed", [1234, 99])
def test_training_batch_equals_jax(synthetic_root, seed):
    """The train stage's first batch of 2 (inline, shuffled chunks and
    scenes, augmentation on) equals the JAX DataModule's. Past the first
    pass the streams part: the JAX inline stream builds its dataset anew,
    re-seeded, for every pass, while the port's stream (like the JAX worker
    processes) goes on drawing from one generator."""
    overrides = [
        f"dataset.roots=[{synthetic_root}]", "dataset.image_shape=[64,96]",
        "dataset.view_sampler.min_distance_between_context_views=3",
        "dataset.view_sampler.max_distance_between_context_views=6",
        "dataset.view_sampler.num_target_views=2", "dataset.view_sampler.warm_up_steps=0",
        "data_loader.train.num_workers=0", "data_loader.train.batch_size=2", f"data_loader.train.seed={seed}",
    ]
    jdm, pdm = data_modules(overrides)
    got, want = next(iter(pdm.train_dataloader())), next(iter(jdm.train_dataloader()))
    assert got["context"]["image"].shape == (2, 2, 3, 64, 96) and sorted(got["scene"]) == ["a", "b"]
    assert_examples_equal(got, want)


def test_two_workers_give_the_inline_examples(synthetic_root):
    """`num_workers=2` over the test stage's two chunks: each worker reads
    one, and together they give exactly the inline stream's examples."""
    overrides = [
        f"dataset.roots=[{synthetic_root}]", "dataset/view_sampler=bounded", "dataset.image_shape=[64,96]",
        "dataset.view_sampler.max_distance_between_context_views=6",
    ]
    assert sorted(workers_vs_inline(2, overrides)) == ["c", "d", "e", "f"]


def test_collate_keeps_scene_names_as_a_list():
    examples = [{"context": {"image": np.full((2, 3), i, np.float32)}, "scene": f"s{i}"} for i in range(3)]
    got = pt_data_module.collate(examples)
    want = jx_data_module.collate(examples)
    assert got["scene"] == want["scene"] == ["s0", "s1", "s2"]
    assert_examples_equal(got, want)
