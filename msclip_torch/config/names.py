"""Run-name composition, the port of ``msclip_tpu/config/names.py``
(reference ``lib/config/default.py:194-276``): the same strings from the
same config.

The reference's builders crash for CLIP model names (its ``get_model_name``
only knows the legacy HRNet/ResNeXt families, ``lib/config/models.py:
54-86``); the JAX package's, and these, support the CLIP family and
otherwise preserve the template semantics.
"""

from __future__ import annotations


def get_model_name(config) -> str:
    name = config.MODEL.NAME
    if name.startswith(("clip", "cls_clip")):
        spec = config.MODEL.SPEC
        vision = spec.get("VISION", {})
        if isinstance(vision.get("LAYERS", 12), (list, tuple)):
            return f"{name}-rn{sum(vision['LAYERS'])}"
        return f"{name}-b{vision.get('PATCH_SIZE', 32)}w{vision.get('WIDTH', 768)}"
    return name


def get_lr_scheduler_name(config) -> str:
    sched = config.TRAIN.LR_SCHEDULER
    method = sched.get("METHOD", "timm")
    if method == "timm":
        args = sched.get("ARGS", {})
        setting = f"warm{args.get('warmup_epochs', 5)}"
    elif method == "MultiStep":
        setting = "_".join(str(i) for i in sched.get("MILESTONES", [])) \
            + f"factor{sched.get('GAMMA', 0.1)}"
    elif method == "CosineAnnealing":
        setting = f"eta{sched.get('ETA_MIN', 0.0)}"
    elif method == "WarmupCosine":
        setting = str(sched.get("WARMUP_EPOCH", 5))
    else:
        setting = ""
    return f"{method}{setting}Ep{config.TRAIN.END_EPOCH}"


def get_train_name(config, world_size: int = 1) -> str:
    aug = ""
    if config.AUG.MIXUP > 0.0:
        aug = f"mixup{config.AUG.MIXUP}"
    elif config.AUG.MIXCUT > 0.0:
        aug = f"mixcut{config.AUG.MIXCUT}"
    return (
        "labelsmooth{ls}{aug}{optim}-lr{lr:.5g}wd{wd}bs{bs}X{ws}-{sched}"
    ).format(
        ls=config.LOSS.LABEL_SMOOTHING,
        aug=aug,
        optim=config.TRAIN.OPTIMIZER,
        lr=config.TRAIN.LR,
        wd=config.TRAIN.WD,
        bs=config.TRAIN.BATCH_SIZE_PER_GPU,
        ws=world_size,
        sched=get_lr_scheduler_name(config),
    )


def get_config_name(config, world_size: int = 1) -> str:
    w, h = config.TRAIN.IMAGE_SIZE
    aug = ""
    cj = config.AUG.COLOR_JITTER
    if cj[-1] > 0.0:
        aug += "cj{}".format("_".join(str(i) for i in cj))
    if config.AUG.GRAY_SCALE > 0.0:
        aug += f"gs{config.AUG.GRAY_SCALE}"
        aug += f"gb{config.AUG.GAUSSIAN_BLUR}"
    if config.AUG.DROPBLOCK_KEEP_PROB < 1.0:
        aug += f"db{config.AUG.DROPBLOCK_KEEP_PROB}"
    name = f"{get_model_name(config)}-{w}x{h}-{aug}-" \
        f"{get_train_name(config, world_size)}"
    if config.TRAIN.EMA_DECAY > 0.0:
        name += f"ema{config.TRAIN.EMA_DECAY}"
    return name
