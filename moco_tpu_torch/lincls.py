"""The linear probe (the counterpart of moco_tpu/lincls.py, `main_lincls.py`).

    python -m moco_tpu_torch.lincls PRETRAIN_WORKDIR --num-classes 1000 \\
        --data imagefolder --data-dir /data/imagenet [--evaluate]

Reference semantics:

- checkpoint surgery: only the pretrained query encoder's backbone is kept
  (`module.encoder_q.*` without the `fc` head, `main_lincls.py:~L170-195`);
  the architecture and the backbone's width come from the checkpoint;
- a fresh classifier, weight ~ N(0, 0.01), bias 0 (`~L160-165`);
- only the classifier trains: SGD(lr 30, momentum 0.9, wd 0), the lr cut
  x0.1 at epochs 60 and 80 of 100 (`~L200-210`);
- the backbone runs in eval mode under no_grad: BN normalizes with its
  running statistics, which never move (`train()` calls `model.eval()`);
- `sanity_check`: after training every backbone weight and BN statistic
  is bit-identical to the checkpoint's (`~L380-400`);
- a checkpoint per epoch and `model_best` by val top-1 (`~L250-260`);
  `evaluate_lincls` scores `model_best`, or the latest epoch without one.

The backbone is a ResNet or a ViT, as the checkpoint's config says
(`moco_tpu/lincls.py:169-175`); a ViT has no BN, so only its weights are
frozen and checked. `restore_pretrain_state` is the eval side's shared
restore: the probe, `convert_pretrain` and the serving engine
(`serve/engine.py::load_serving_encoder`) all read a checkpoint through it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from moco_tpu_torch.core.moco import build_encoder
from moco_tpu_torch.data.pipeline import EvalPipeline, LabeledPipeline
from moco_tpu_torch.models.heads import LinearClassifier
from moco_tpu_torch.models.resnet import create_resnet
from moco_tpu_torch.models.vit import create_vit
from moco_tpu_torch.ops.losses import cross_entropy, topk_accuracy
from moco_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    best_exists,
    load_encoder_reference,
    restore_best,
    save_best,
)
from moco_tpu_torch.utils.config import (
    DataConfig,
    MocoConfig,
    OptimConfig,
    ProbeConfig,
    TrainConfig,
    config_from_dict,
    config_to_dict,
    dataclass_from_dict,
)
from moco_tpu_torch.utils.device import resolve_device
from moco_tpu_torch.utils.metrics import AverageMeter, MetricWriter, ProgressMeter
from moco_tpu_torch.utils.schedules import build_optimizer, make_lr_schedule

FC_KEYS = ("fc.weight", "fc.bias")


SIDES = ("q", "k")


class PretrainState(NamedTuple):
    """What the eval side reads from a pretraining checkpoint."""

    encoders: dict  # side -> MoCoEncoder (backbone + head), loaded, in eval mode
    tensors: dict  # side -> the checkpoint's reference-named tensors of that encoder
    queue: Optional[torch.Tensor]  # (K, dim) f32 rows on the CPU; None for v3
    queue_ptr: int
    step: int
    config: TrainConfig


def _widths(sd: dict) -> dict:
    """The widths `build_encoder` takes, read off an encoder's
    reference-named tensors: a ResNet's stem width and a v3 head's hidden
    width (tests narrow both)."""
    out = {}
    if "conv1.weight" in sd:
        out["num_filters"] = int(sd["conv1.weight"].shape[0])
    if "fc.fc0.weight" in sd:
        out["mlp_hidden"] = int(sd["fc.fc0.weight"].shape[0])
    return out


def restore_pretrain_state(workdir: str, config: Optional[TrainConfig] = None,
                           sides=("q",), device="cuda") -> PretrainState:
    """The newest good pretraining checkpoint under `workdir`
    (`CheckpointManager.restore`, which falls back past a corrupt file),
    read for evaluation: the encoder of each requested side rebuilt by
    `build_encoder(config.moco)` at the checkpoint's widths and loaded
    through `load_encoder_reference` (every key accounted for), on `device`
    in eval mode; the queue's rows (stored (dim, K), returned (K, dim)) and
    its pointer. The config comes from the checkpoint's extras unless one
    is given.

    The counterpart of `moco_tpu/lincls.py:68`. The port has no ZeRO, so a
    checkpoint always holds whole tensors and nothing is unsharded."""
    sides = tuple(sides)
    if not sides or any(s not in SIDES for s in sides):
        raise ValueError(f"sides must be drawn from {SIDES}, got {sides!r}")
    device = resolve_device(device)
    payload, extra = CheckpointManager(workdir).restore()
    if config is None:
        if "config" not in extra:
            raise KeyError(f"checkpoint under {workdir} carries no config: pass one")
        config = config_from_dict(extra["config"])
    sd = payload["state_dict"]
    encoders, tensors = {}, {}
    for side in sides:
        prefix = f"module.encoder_{side}."
        tensors[side] = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        encoder = build_encoder(config.moco, **_widths(tensors[side]))
        load_encoder_reference(encoder, tensors[side])
        encoders[side] = encoder.to(device).eval()
    queue = sd.get("module.queue")
    queue_ptr = int(sd["module.queue_ptr"].reshape(-1)[0]) if queue is not None else 0
    queue = queue.t().contiguous().float() if queue is not None else None
    return PretrainState(encoders, tensors, queue, queue_ptr, int(payload["step"]), config)


def build_backbone(moco: MocoConfig, sd: dict, device, image_size: int = 224) -> nn.Module:
    """The backbone the checkpoint's `sd` (reference names, no head) shapes,
    loaded from it, on `device`, frozen and in eval mode: a ResNet
    (`moco.arch` resnet*, its width read off `conv1`, channels-last) or a
    ViT (`create_vit` with the config's patch size, pooling and attention,
    for `image_size`). A missing BN `num_batches_tracked` is allowed; any
    other missing or extra key raises."""
    if moco.arch.startswith("vit"):
        kw = {"patch_size": moco.vit_patch_size} if moco.vit_patch_size else {}
        backbone = create_vit(moco.arch, image_size=image_size, pool=moco.vit_pool,
                              use_flash_attention=moco.vit_flash_attention, **kw)
    else:
        backbone = create_resnet(moco.arch, num_filters=int(sd["conv1.weight"].shape[0]),
                                 cifar_stem=moco.cifar_stem)
    names = set(backbone.state_dict())
    missing = sorted(k for k in names - set(sd) if not k.endswith("num_batches_tracked"))
    if missing or set(sd) - names:
        raise KeyError(f"backbone keys differ: missing {missing[:5]}, "
                       f"unexpected {sorted(set(sd) - names)[:5]}")
    backbone.load_state_dict(sd, strict=False)
    backbone = backbone.to(device, memory_format=torch.channels_last)
    return backbone.eval().requires_grad_(False)


def load_pretrained_backbone(workdir: str, config: Optional[TrainConfig] = None,
                             side: str = "q", device="cuda") -> tuple[nn.Module, dict, TrainConfig]:
    """Checkpoint surgery on the newest good pretraining checkpoint, through
    `restore_pretrain_state`: the backbone of encoder `side` ("q", the
    probe's and the reference's, or "k", the EMA key encoder) without its
    head, on `device` channels-last, frozen and in eval mode; returns
    (backbone, its checkpoint tensors, the config, from the checkpoint's
    extras unless given)."""
    if side not in SIDES:
        raise ValueError(f"side must be 'q' or 'k', got {side!r}")
    restored = restore_pretrain_state(workdir, config, sides=(side,), device=device)
    backbone = restored.encoders[side].backbone
    backbone = backbone.to(memory_format=torch.channels_last).eval().requires_grad_(False)
    sd = {k: v for k, v in restored.tensors[side].items() if not k.startswith("fc.")}
    return backbone, sd, restored.config


def _autocast(device: torch.device, compute_dtype: str):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=compute_dtype == "bfloat16")


def make_probe_step(backbone: nn.Module, classifier: nn.Module, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    compute_dtype: str = "float32") -> Callable[[int, torch.Tensor, torch.Tensor], dict]:
    """`step(n, images, labels) -> metrics`: the frozen backbone's features
    in eval mode under no_grad (autocast under bfloat16, as the JAX
    backbone runs in its dtype), the classifier in float32, cross-entropy,
    and an SGD step of the classifier alone at lr `schedule(n)`. Metrics:
    loss, acc1, acc5 (0-dim tensors) and lr."""

    def step(n: int, images: torch.Tensor, labels: torch.Tensor) -> dict:
        backbone.eval()  # the reference's model.eval(): BN on running statistics
        with torch.no_grad(), _autocast(images.device, compute_dtype):
            feats = backbone(images)
        logits = classifier(feats.float())
        loss = cross_entropy(logits, labels)
        acc = topk_accuracy(logits.detach(), labels)
        lr = schedule(n)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "acc1": acc["acc1"], "acc5": acc["acc5"], "lr": lr}

    return step


def make_eval_step(backbone: nn.Module, classifier: nn.Module,
                   compute_dtype: str = "float32") -> Callable[..., dict]:
    """`eval(images, labels, mask) -> sums`: masked *sums* (not means) of
    the loss and the top-1 / top-5 hits, and the count, so a padded tail
    batch scores exactly its real rows."""

    @torch.no_grad()
    def evaluate(images, labels, mask) -> dict:
        backbone.eval()
        with _autocast(images.device, compute_dtype):
            feats = backbone(images)
        logits = classifier(feats.float())
        per_ex = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[:, None])[:, 0]
        top5 = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
        correct = top5 == labels[:, None]
        return {"loss": (per_ex * mask).sum(), "correct1": (correct[:, 0] * mask).sum(),
                "correct5": (correct.any(dim=1) * mask).sum(), "count": mask.sum()}

    return evaluate


def sanity_check(backbone: nn.Module, pretrained: dict) -> None:
    """Every backbone weight and BN statistic must be bit-identical to the
    checkpoint's (`main_lincls.py:~L380-400`)."""
    for k, v in backbone.state_dict().items():
        if k in pretrained and not torch.equal(v.cpu(), pretrained[k].cpu()):
            raise AssertionError(f"backbone weight changed during probe training: {k}")


def _probe_optim_config(probe: ProbeConfig) -> OptimConfig:
    return OptimConfig(optimizer="sgd", lr=probe.lr, momentum=probe.momentum,
                       weight_decay=probe.weight_decay, cos=False, schedule=probe.schedule,
                       epochs=probe.epochs)


def _probe_tx(probe: ProbeConfig, steps_per_epoch: int, params):
    """The probe's optimizer over `params` and its lr schedule
    (`main_lincls.py:~L200-210`: SGD, x0.1 at each schedule epoch)."""
    cfg = _probe_optim_config(probe)
    return build_optimizer(cfg, params), make_lr_schedule(cfg, steps_per_epoch)


def _probe_payload(backbone, classifier, optimizer, arch: str, epoch: int, best_acc1: float):
    """The reference's lincls checkpoint: the whole model's state_dict
    (backbone keys bare, the classifier as `fc.*`)."""
    sd = dict(backbone.state_dict())
    sd.update({f"fc.{k}": v for k, v in classifier.state_dict().items()})
    return {"epoch": int(epoch), "arch": arch, "state_dict": sd, "best_acc1": float(best_acc1),
            "optimizer": optimizer.state_dict()}


def validate(eval_fn, val_pipe: EvalPipeline) -> dict:
    """Loss, top-1 and top-5 (%) over the whole split (`~L330-370`)."""
    sums = None
    for images, labels, mask in val_pipe:
        s = eval_fn(images, labels, mask)
        sums = s if sums is None else {k: sums[k] + s[k] for k in s}
    sums = {k: float(v) for k, v in (sums or {}).items()}
    n = max(sums.get("count", 0.0), 1.0)
    return {"loss": sums.get("loss", 0.0) / n, "acc1": 100.0 * sums.get("correct1", 0.0) / n,
            "acc5": 100.0 * sums.get("correct5", 0.0) / n, "count": n}


def train_lincls(pretrain_workdir: str, probe: ProbeConfig,
                 pretrain_config: Optional[TrainConfig] = None,
                 data: Optional[DataConfig] = None, workdir: Optional[str] = None,
                 train_dataset=None, val_dataset=None, log_every: int = 10,
                 device="cuda") -> dict:
    """A whole probe run; returns {"best_acc1", "acc1", "acc5", "loss",
    "count"} of the last epoch's validation. `workdir` defaults to
    `<pretrain_workdir>_lincls`; `data` to the pretraining config's. The
    training batches come through the prefetch ring."""
    device = resolve_device(device)
    workdir = workdir or (pretrain_workdir.rstrip("/") + "_lincls")
    backbone, pretrained, pretrain_config = load_pretrained_backbone(
        pretrain_workdir, pretrain_config, device=device)
    data = data or pretrain_config.data
    compute_dtype = pretrain_config.moco.compute_dtype
    classifier = LinearClassifier(backbone.num_features, probe.num_classes,
                                  generator=torch.Generator().manual_seed(2)).to(device)
    with LabeledPipeline(data, seed=1, dataset=train_dataset, device=device) as train_pipe, \
            EvalPipeline(data, train=False, dataset=val_dataset, device=device) as val_pipe:
        steps_per_epoch = train_pipe.steps_per_epoch
        optimizer, schedule = _probe_tx(probe, steps_per_epoch, classifier.parameters())
        step_fn = make_probe_step(backbone, classifier, optimizer, schedule, compute_dtype)
        eval_fn = make_eval_step(backbone, classifier, compute_dtype)
        writer = MetricWriter(workdir)
        ckpt = CheckpointManager(workdir, keep=1)
        best_acc1, last_val, n = 0.0, {}, 0
        try:
            for epoch in range(probe.epochs):
                meters = [AverageMeter("Loss", ":.4e"), AverageMeter("Acc@1", ":6.2f"),
                          AverageMeter("Acc@5", ":6.2f")]
                progress = ProgressMeter(steps_per_epoch, meters, prefix=f"Epoch: [{epoch}]")
                it = train_pipe.epoch(epoch, device=True)
                try:
                    for i, (images, labels) in enumerate(it):
                        m = step_fn(n, images, labels)
                        n += 1
                        if i % log_every == 0 or i == steps_per_epoch - 1:
                            m = {k: float(v) for k, v in m.items()}
                            for meter, k in zip(meters, ("loss", "acc1", "acc5")):
                                meter.update(m[k], data.global_batch)
                            progress.display(i)
                            writer.write(n, {"epoch": epoch, "split": "train", **m})
                finally:
                    it.close()
                last_val = validate(eval_fn, val_pipe)
                writer.write(n, {"epoch": epoch, "split": "val", "lr": schedule(max(n - 1, 0)),
                                 **last_val})
                print(f" * Acc@1 {last_val['acc1']:.3f} Acc@5 {last_val['acc5']:.3f}", flush=True)
                improved = last_val["acc1"] > best_acc1
                best_acc1 = last_val["acc1"] if improved else best_acc1
                payload = _probe_payload(backbone, classifier, optimizer,
                                         pretrain_config.moco.arch, epoch + 1, best_acc1)
                # config-carrying, like the pretraining checkpoints: evaluation
                # rebuilds the model and scores the same data from these alone
                ckpt.save(epoch, payload, extra={
                    "epoch": epoch, "acc1": last_val["acc1"], "probe": dataclasses.asdict(probe),
                    "pretrain_config": config_to_dict(pretrain_config),
                    "data": dataclasses.asdict(data)})
                if improved:
                    save_best(workdir, payload, metric=best_acc1)
        finally:
            writer.close()
    sanity_check(backbone, pretrained)
    return {"best_acc1": best_acc1, **last_val}


def evaluate_lincls(pretrain_workdir: str, workdir: Optional[str] = None, val_dataset=None,
                    data_overrides: Optional[dict] = None, device="cuda") -> dict:
    """Validation only (`main_lincls.py --evaluate`): the probe run's
    `model_best`, or its latest epoch's checkpoint without one, scored
    over the whole val split. The probe checkpoint carries the pretraining
    and the data config, so nothing else is read; `data_overrides`
    replace fields of the data config. `workdir` is the probe's (default
    `<pretrain_workdir>_lincls`)."""
    device = resolve_device(device)
    workdir = workdir or (pretrain_workdir.rstrip("/") + "_lincls")
    mgr = CheckpointManager(workdir, keep=1)
    extra = mgr.read_extra()
    pretrain_config = config_from_dict(extra["pretrain_config"])
    data = dataclass_from_dict(DataConfig, extra["data"])
    if data_overrides:
        data = dataclasses.replace(data, **data_overrides)
    if best_exists(workdir):
        payload, metric = restore_best(workdir)
        print(f"evaluating model_best (saved Acc@1 {metric:.3f})", flush=True)
    else:
        payload, saved = mgr.restore()
        print(f"no model_best; evaluating latest epoch {saved.get('epoch')}", flush=True)
    sd = payload["state_dict"]
    backbone = build_backbone(pretrain_config.moco,
                              {k: v for k, v in sd.items() if k not in FC_KEYS}, device,
                              image_size=pretrain_config.data.image_size)
    classifier = LinearClassifier(backbone.num_features, int(sd["fc.weight"].shape[0]))
    classifier.load_state_dict({"weight": sd["fc.weight"], "bias": sd["fc.bias"]})
    classifier = classifier.to(device)
    with EvalPipeline(data, train=False, dataset=val_dataset, device=device) as val_pipe:
        out = validate(make_eval_step(backbone, classifier, pretrain_config.moco.compute_dtype),
                       val_pipe)
    print(f" * Acc@1 {out['acc1']:.3f} Acc@5 {out['acc5']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="MoCo linear probe (PyTorch port)")
    ap.add_argument("pretrained", help="pretraining workdir (the port's checkpoints)")
    ap.add_argument("--lr", type=float, default=30.0)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--wd", type=float, default=0.0)
    ap.add_argument("--schedule", type=int, nargs="*", default=[60, 80])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--data", dest="dataset", default=None,
                    help="dataset name (default: the pretraining checkpoint's)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--batch-size", "-b", type=int, default=None)
    ap.add_argument("--workers", "-j", type=int, default=None)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--workdir", default=None, help="probe workdir (default: <pretrained>_lincls)")
    ap.add_argument("--evaluate", "-e", action="store_true",
                    help="score the probe's model_best (or latest) on the val split, no training")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    probe = ProbeConfig(lr=args.lr, momentum=args.momentum, weight_decay=args.wd,
                        schedule=tuple(args.schedule), epochs=args.epochs,
                        num_classes=args.num_classes)
    overrides = {k: v for k, v in {
        "dataset": args.dataset, "data_dir": args.data_dir, "image_size": args.image_size,
        "global_batch": args.batch_size, "num_workers": args.workers,
        "cache_dir": args.cache_dir}.items() if v is not None}
    if args.evaluate:
        result = evaluate_lincls(args.pretrained, workdir=args.workdir,
                                 data_overrides=overrides, device=args.device)
        print(f"Acc@1: {result['acc1']:.3f}")
        return 0
    resolve_device(args.device)  # refuse before reading anything
    extra = CheckpointManager(args.pretrained).read_extra()
    base = config_from_dict(extra["config"]).data if "config" in extra else DataConfig()
    result = train_lincls(args.pretrained, probe, data=dataclasses.replace(base, **overrides),
                          workdir=args.workdir, device=args.device)
    print(f"best Acc@1: {result['best_acc1']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
