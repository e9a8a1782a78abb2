"""MS-CLIP-S (``MODEL.NAME clip_openai_pe_res_v1``), the released layout:
the EarlyconvRes stem as visual block 0, the parallel conv branch and its
lateral adapters, the trunk shared by both towers. The reference is
``benchmark/reference.py``."""

import json
from dataclasses import dataclass

from benchmark import flops
from benchmark import reference as R

param_layout = R.param_layout
zero_shot_logits = R.zero_shot_logits


@dataclass(frozen=True)
class Arch(R.Arch):
    @property
    def attention_blocks(self):
        """Block 0 is the stem; the blocks after it attend."""
        return self.layers - 1

    def image_flops(self):
        return flops.msclips_image_flops(self)


def arch_from_file(path):
    """The :class:`Arch` of a configuration file (the release's keys)."""
    with open(path) as f:
        cfg = json.load(f)
    spec, custom = cfg["MODEL"]["SPEC"], cfg["CUSTOM"]
    vis, txt = spec["VISION"], spec["TEXT"]
    released = ("EARLY_CONV", "EARLY_CONV_RES", "EARLY_CONV_NEW_IMPLEMENT",
                "PARALLEL_IN_V", "PRALLEL_T2B_USECLS")
    if not (all(custom.get(k) for k in released)
            and custom.get("PARALLEL_RESNET_LAYERS") == [0, 1, 1, 1, 1]
            and not custom.get("VISUAL_LAYER_MINUS1", False)):
        raise ValueError(f"{path}: the reference covers the released "
                         "MS-CLIP-S layout only")
    return Arch(
        embed=spec["EMBED_DIM"], width=vis["WIDTH"], layers=vis["LAYERS"],
        heads=vis["WIDTH"] // 64, resolution=cfg["TRAIN"]["IMAGE_SIZE"][0],
        context=txt["CONTEXT_LENGTH"], vocab=txt["VOCAB_SIZE"],
        text_width=txt["WIDTH"], text_heads=txt["HEADS"],
        text_layers=txt["LAYERS"],
        first_k=custom["EARLY_CONV_RES_FIRSTCONV_KERNEL"],
        stem_strides=tuple(custom.get("EARLY_CONV_RES_STRIDES", [2] * 4)),
        lateral_layers=tuple(custom["PARALLEL_LATERAL_LAYER"]),
        par_kernels=tuple(custom.get("PARALLEL_KERNELS", [3] * 5)),
        par_paddings=tuple(custom.get("PARALLEL_PADDINGS", [1] * 5)),
        par_strides=tuple(custom.get("PARALLEL_STRIDES", [2] * 5)),
        t2b_kernels=tuple(custom["PRALLEL_T2B_KERNELS"]),
        t2b_paddings=tuple(custom["PRALLEL_T2B_PADDINGS"]),
        t2b_strides=tuple(custom["PRALLEL_T2B_STRIDES"]),
        share_from=custom.get("N_LAYERS", -1) if custom.get("N_LAYERS", -1)
        > 0 else 1)


def train_reference(params, a, config_path, steps_per_epoch, prec=R.FP32,
                    fault=None):
    """The release's contrastive step with its AdamW groups and warm-up
    (``reference.TrainReference``)."""
    return R.TrainReference(params, a,
                            R.optim_from_file(config_path, steps_per_epoch),
                            prec, fault)
