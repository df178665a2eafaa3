"""Tiny configurations of the cells for CPU tests: the same code paths at
widths a test run holds."""

from __future__ import annotations

def tiny_v2_config(**moco) -> dict:
    """ResNet-50 at an eighth of its width on 72-px images (above 64 px, so
    the ImageNet recipe and statistics apply), batch 8, a 64-row queue."""
    return {"global_batch": 8, "num_filters": 8, "residual_gamma": 0.2,
            "moco": {"arch": "resnet50", "dim": 16, "num_negatives": 64, "momentum": 0.999,
                     "temperature": 0.2, "mlp": True, "shuffle": "gather_perm",
                     "compute_dtype": "float32", **moco},
            "optim": {"optimizer": "sgd", "lr": 0.03, "momentum": 0.9, "weight_decay": 1e-4,
                      "cos": True, "epochs": 200},
            "data": {"dataset": "synthetic", "image_size": 72, "aug_plus": True,
                     "num_workers": 2}}


def tiny_v3_config() -> dict:
    """ViT-tiny (width 192, depth 4) with 16-px patches on 80-px images, batch 8."""
    return {"global_batch": 8, "mlp_hidden": 32,
            "vit": {"patch": 16, "width": 192, "depth": 4, "heads": 3, "mlp": 768},
            "moco": {"arch": "vit_tiny", "dim": 16, "num_negatives": 0, "momentum": 0.99,
                     "momentum_cos": True, "temperature": 0.2, "v3": True, "shuffle": "none",
                     "vit_flash_attention": True, "vit_patch_size": 16,
                     "compute_dtype": "float32"},
            "optim": {"optimizer": "adamw", "lr": 0.0024, "weight_decay": 0.1, "cos": True,
                      "epochs": 300, "warmup_epochs": 40},
            "data": {"dataset": "synthetic", "image_size": 80, "aug_plus": True,
                     "num_workers": 2}}


TINY_TRAIN_TRAFFIC = {"driver": "train", "warm_steps": 2, "profile_steps": 2, "probe_steps": 4,
                      "probe_skip": 1, "dataset_rows": 8 * 200}
