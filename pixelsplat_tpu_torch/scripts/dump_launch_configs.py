"""Print ready-to-paste launch commands for the standard workflows.

    python -m pixelsplat_tpu_torch.scripts.dump_launch_configs

Port of `pixelsplat_tpu/scripts/dump_launch_configs.py`: the CLI
invocations for debugging (one process, batch 1) and the standard
configurations, run through `python -m pixelsplat_tpu_torch.main`, and the
same training with one process per GPU under torchrun.
"""

from __future__ import annotations

LAUNCHES = {
    "train re10k (debug)": (
        "python -m pixelsplat_tpu_torch.main +experiment=re10k "
        "data_loader.train.num_workers=0 data_loader.train.batch_size=1 "
        "wandb.mode=disabled"
    ),
    "train re10k": "python -m pixelsplat_tpu_torch.main +experiment=re10k",
    "train re10k (8 GPUs)": "torchrun --nproc_per_node=8 -m pixelsplat_tpu_torch.main +experiment=re10k",
    "eval re10k": (
        "python -m pixelsplat_tpu_torch.main +experiment=re10k mode=test "
        "dataset/view_sampler=evaluation checkpointing.load=<ckpt>"
    ),
    "eval acid video": (
        "python -m pixelsplat_tpu_torch.main +experiment=acid mode=test "
        "dataset/view_sampler=evaluation "
        "dataset.view_sampler.index_path=assets/evaluation_index_acid_video.json "
        "checkpointing.load=<ckpt>"
    ),
    "ablation no epipolar": (
        "python -m pixelsplat_tpu_torch.main "
        "+experiment=re10k_ablation_no_epipolar_transformer"
    ),
    "3-view": "python -m pixelsplat_tpu_torch.main +experiment=re10k_3_view",
    "compute metrics": (
        "python -m pixelsplat_tpu_torch.scripts.compute_metrics +evaluation=re10k"
    ),
    "generate eval index": (
        "python -m pixelsplat_tpu_torch.scripts.generate_evaluation_index"
    ),
}


def render() -> str:
    return "".join(f"# {name}\n{cmd}\n\n" for name, cmd in LAUNCHES.items())


if __name__ == "__main__":
    print(render(), end="")
