"""Cells at a size the CPU holds, for the harness's tests.

``small.json`` is the released B/32 configuration at width 256 (4 heads),
96 px, an embedding of 128 and a vocabulary of 1,000; every module of the
released layout is there. Its limits were set as the cells' are, from CPU
readings of the program (bfloat16, seeds 1-4) against the control and the
faults at this size: logits rms gap 0.168-0.213 against int8's
0.866-1.070; loss gap 0.002-0.0085 against float8's 0.044-0.057 and half
a batch's 0.189-0.402; gradient gap 0.015-0.023 against 0.067-0.099 and
0.159-0.348; the change gap does not part the program (0.006-0.017) from
float8 (0.024-0.029), so its limit only catches a state left unchanged,
which reads 1. The running statistics' worst change gap read
0.0018-0.0040 against float8's 0.031-0.060; statistics left unchanged
read 1.

``small_clip.json`` is the plain CLIP ViT layout (``MODEL.NAME
clip_openai``) at the same widths, patch 16 at 96 px (37 tokens), with no
MS-CLIP-S key. Its eval limit was set the same way (CPU, bfloat16, seeds
1-5 and ``SEED``): logits rms gap 0.193-0.223 against int8's 0.894-1.222,
an image given its neighbour's answer 5.50-7.28 and a step given the
previous step's 5.74-7.87. The worst image's rms gap (0.278-0.522 against
int8's 1.401-2.171, under three times) is read, not compared.
"""

import os

from benchmark import manifest

SEED = 2 ** 31 + 11
HERE = os.path.dirname(os.path.abspath(__file__))
SMALL = os.path.join(HERE, "small.json")
SMALL_CLIP = os.path.join(HERE, "small_clip.json")


def eval_cell():
    return manifest.Cell(
        name="small.eval", config="small", config_path=SMALL,
        traffic_name="eval.small",
        traffic={"kind": "eval", "batch": 8, "ring": 2, "classes": 100,
                 "trace_steps": 2},
        limits={"logit_rms_gap": 0.45}, chips=1)


def clip_eval_cell():
    return manifest.Cell(
        name="small_clip.eval", config="small_clip", config_path=SMALL_CLIP,
        traffic_name="eval.small",
        traffic={"kind": "eval", "batch": 8, "ring": 2, "classes": 100,
                 "trace_steps": 2},
        limits={"logit_rms_gap": 0.45}, chips=1)


def train_cell(cards=1):
    """16 pairs a step, on ``cards`` processes."""
    return manifest.Cell(
        name="small.train", config="small", config_path=SMALL,
        traffic_name="train.small",
        traffic={"kind": "train", "cards": cards, "batch": 16 // cards,
                 "ring": 4, "caption_tokens": [5, 40],
                 "steps_per_epoch": 100, "check_steps": 3, "trace_steps": 2},
        limits={"loss_gap": 0.02, "grad_gap": 0.04, "change_gap": 0.1,
                "bn_stat_gap": 0.015},
        chips=cards)
