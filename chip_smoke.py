"""Smoke run of the PyTorch/CUDA port (msclip_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                # every path and every check
    python3 chip_smoke.py --measure      # also the re-measurements below
    python3 chip_smoke.py --zoo-faults   # phase 19's check on planted faults
    python3 chip_smoke.py --serve-split  # live serving over two cards

The default run drives every path and holds every kernel against its
plain version. ``--measure`` adds the phases that only re-measure numbers
PERF.md records: the in-turns ratios of K5, K6, E1, E2 and the hybrid
against their yardsticks (``traced_turns``; without it phases 3 and 12
time each of these kernels alone by CUDA events and leave the ratios
out), the measurements behind ``ops/tuning.py``'s ``sm_90`` row
(``tuning``) and the ``torch.compile`` yardsticks (``compile_baselines``).
``--serve-split`` needs two cards: full-width B/32 served live over
``cuda:0`` and ``cuda:1`` (``run_serve_split``), its features against one
card's, K1 captured on each card, and the serve CLI split, on every
visible card and on one card, each at 1 and 32 clients.

Phases, each printed on its own line and each fatal on failure:

1. device and packages: the card's name and power limit, and which of the
   optional host packages (yaml, regex, PIL, ftfy) import;
2. build: compile every CUDA kernel of the port from the sources in this
   checkout (one ``nvcc`` per source, all started together), and print
   what ``ptxas -v`` reports for each instantiation by name, the wgmma
   instructions in each K5/K6/E1/E2 instantiation and K3's and K4's SASS
   instructions an element (``cuobjdump -sass``); a bf16 instantiation of
   K1, K2, K5, K6, E1 or E2 that spills registers, wgmma that ptxas
   serializes in K1, K2, K5, K6, E1 or E2, or a bf16 K5/K6/E1/E2
   instantiation without wgmma fails the run; then, with ``--measure``,
   in a fresh process, the fp32 and bf16 turns of K5, K6, E1, E2 and the
   hybrid against their yardsticks that phases 3 and 12 report
   (``traced_turns``: the profiler
   traced none of them in a process that had run the other phases
   first), and in two more fresh processes the measurements that set
   ``ops/tuning.py``'s ``sm_90`` row (``measure_tuning``: K1 and K2 with
   lane pack 2 against 1 at 256 x 50, and B/16's int8 text tower with
   the fused int8 gate at 77 against 96, each pair in turns by device
   time);
3. kernels: call each kernel's wrapper at the shapes the main paths give
   it, hold the result against its plain PyTorch version, and time the
   kernel, the plain version and the nearest PyTorch library call: the
   attention forward (K1) and the attention backward (K2), each in turns
   with SDPA (SDPA, kernel, kernel, SDPA; event time as ``ms``, and device
   time from the profiler, held to a full count of records and to the event
   time, beside it, or null where no trace counts) and its ``vs_library``
   ratio of device times printed per shape; in bf16 both also against a
   mean limit (K2's per gradient), with faults planted into a copy of each
   plain version (K1 also under a random additive mask);
4. slice: zero-shot eval of MS-CLIP-S ViT-B/32 at full width through
   ``msclip_torch.eval.zero_shot.run_zero_shot`` (random weights from a
   seed, bf16, BN folded, synthetic images), with each kernel's launches
   counted over that run;
5. card against CPU: the same fp32 weights through both towers on the card
   (kernels) and on the CPU (plain versions);
6. train slice: full-width B/32 bf16 training steps at batch 256 through
   ``msclip_torch.tools.train.train`` (synthetic pairs), with each kernel's
   launches counted over the run, then the step time on a batch resident
   on the card;
7. card against CPU, training: one fp32 train step's loss and every
   gradient of full-width B/32 on 4 synthetic pairs, the card (kernels)
   against the CPU (plain versions), same weights, each gradient beside
   how far fp32 rounding alone moves it on the CPU;
8. int8 slice: zero-shot eval of MS-CLIP-S ViT-B/16 with ``TPU.INT8_EVAL``
   (W8A8 trunk GEMMs; the fused quantizers K3/K4 in the image tower at
   L=197) through ``run_zero_shot``, with each kernel's launches counted
   over that run, then the same configuration in bf16 and the drift of the
   int8 image features from the bf16 ones;
9. card against CPU, int8: full-width fp32 B/16 int8 features of 4
   images and 16 prompts, the card (kernels) against the CPU (plain
   versions), same weights, beside how far fp32 rounding alone moves them;
10. fused slice: zero-shot eval of MS-CLIP-S ViT-B/32 with
   ``TPU.USE_FUSED_BLOCK`` (every trunk and text block through the fused
   attention half-block K5, the MLP half unfused) through ``run_zero_shot``,
   with each kernel's launches counted over that run, then the fused
   image features of one batch against the unfused ones, same weights;
11. card against CPU, fused: full-width fp32 B/32 features of 8 images and
   16 prompts with ``TPU.USE_FUSED_BLOCK``, the card (K5) against the CPU
   (its plain version), same weights;
12. half-block tuning: the tuning kernels E1 (the attention half-block's
   variants, ``ops.halfblock_tuning.attention_halfblock_variant``) and E2
   (the core + out-projection of the hybrid, ``core_out_halfblock``)
   against their plain versions in fp32 and bf16 with planted faults, timed
   beside their plain versions, K5, the unfused half with K1 and, for E2,
   K1 or SDPA with the out-projection in torch (E1 and the whole hybrid
   in turns with the unfused half, E2 in turns with K1 and the
   out-projection, each by event and device time, ``vs_unfused`` and
   ``vs_k1_matmul`` ratios of device times); then the tool's full-width
   sweep, ``msclip_torch.tools.halfblock_tuning.main``, with each row's
   launches counted;
13. transfer: the transfer-eval surface at full B/32 width in bf16 on
   fixtures it writes in each dataset's real layout (VOC2007, HatefulMemes,
   Caltech-101, CIFAR-10, a Karpathy retrieval split; 256 evaluated images
   each, 2,048 probe train images): ``run_zero_shot`` with 11-point mAP,
   ROC-AUC and mean-per-class, ``run_linear_probe(probe="torch")`` and
   ``run_retrieval``, K1's launches in each run held to 11 x image batches
   + 12 x text chunks and each metric to its recomputation from the saved
   logits; fp32 VOC logits of 16 images, the card against the CPU (within
   0.1); and the dispatcher ``msclip_torch.tools.eval_zeroshot --device
   cuda`` as a subprocess;
14. train data: full-width B/32 bf16 training at batch 256 through
   ``msclip_torch.tools.train.train`` on 4 WebDataset tar shards of 256
   JPEG + caption pairs (``DATASET.SAMPLER chunk``, one epoch of 4 steps)
   and one step on a 256-row TSV, fixtures it writes; K1 and K2 held to
   23 launches a step; samples/s end to end, peak memory and the host's
   share of a step (against phase 6's resident step); then ``native``
   (``run_native``): the native JPEG pipeline (``msclip_torch.native``)
   built on this host through the link route it names (the run fails if
   it does not build); its uint8 crops of 32 photo-sized JPEGs against
   ``pil_eval_uint8`` within ``tests/test_native_pipeline.py``'s tolerance,
   all served natively; B/32 bf16 zero-shot through ``run_zero_shot`` on
   1,536 photos of 1024 x 768 by the native route, PIL and the native
   route with the DCT scale, images/s each, K1 held to 11 x image batches
   + 12 x text chunks; fp32 logits of 64 photos, native against PIL
   within ``NATIVE_LOGIT_REL``, which channels reversed must fail; one
   epoch of the shards with the native decode and with PIL (the fill and
   steady step ms, every member decoded natively in the native run, K1
   and K2 held to 23 a step);
15. GradCache and REMAT: the fp32 ``ACCUM_STEPS 4`` gradients of every
   tensor against the one-shot step's on the card (frozen BN, TF32 off,
   batch 32) beside the fp32 noise floor; then bf16 at batch 1024 with
   ``ACCUM_STEPS 4`` and ``TPU.REMAT`` at batch 256, 3 steps each: peak
   memory, ms a step and samples/s beside phase 6's; K1 held to 46a and
   K2 to 23a launches a step under ``ACCUM_STEPS a``, 46 and 23 under
   REMAT;
16. resume: the train CLI as a subprocess at full width in bf16 (batch
   32, 2 epochs of 5 steps, ``SAVE_EVERY_STEPS 3``, EMA, SWA), SIGKILLed
   once its step-3 checkpoint exists and rerun: it resumes at step 3,
   fast-forwards and finishes at step 10, its losses within 4x of the gap
   between two uninterrupted runs; the EMA and SWA shadows through
   ``checkpoint_load`` into ``run_zero_shot``, the EMA one exported by
   ``export_torch_checkpoint --ckpt`` and read back to the same features
   bit for bit, and ``msclip_torch.tools.finetune`` on phase 13's CIFAR-10
   fixture, K1 counted in each;
17. serve (in a process of its own, ``run_serve``): a B/32 bundle (bf16,
   BN folded, buckets 1/4/16/64, the ImageNet classifier of 1,000 x 80
   prompts) exported by the ``export_serving`` CLI (run beside phase 16)
   and loaded on the card with a CUDA graph a tower and
   bucket; each replay against an eager call bit for bit, both timed (CUDA
   events, and device time from the profiler), with each graph's capture
   seconds, pool and launches; ``InferenceServer`` on 256 JPEGs of 96-320
   px with 1 and 32 clients (256 requests each: requests/s, p50/p99, mean
   batch), every served embedding against an eager batch-1 call (least
   cosine > 0.999), and every other route; then a ``TPU.USE_FUSED_BLOCK``
   bundle (buckets 1/64) the same way against the unfused one, and a burst
   through the server. The replays of the server's traffic times each
   graph's launches are K1's and K5's serving launches;
18. distributed (``run_distributed``): the train CLI under ``torchrun
   --nproc_per_node 1`` (NCCL, world 1) at full B/32 width in bf16, batch
   256, 3 steps, in five modes (the gathered loss, ``TPU.SHARDED_LOSS`` at
   64-column chunks, ``+ TPU.RING_LOSS``, ``TPU.ZERO1``, ``TPU.FSDP``;
   cuDNN deterministic), against the same run without a process group in
   this process, run twice for the card's own run-to-run gap: losses, the
   parameters and AdamW's moments of the epoch-end checkpoint bit for bit
   where every collective is a copy (held to 4x the run-to-run gap if the
   card does not repeat itself); for the sharded losses step 1 within
   1e-5 relative, steps 2-3 within 5e-5, the parameters within AdamW's
   envelope and its first moment (the gradients) within bounds over the
   parts whose gradient is not nought but rounding (``moment_gaps``); K1
   and K2 at 23 launches a step in every run (the CLI's
   ``attention_launches``), samples/s, peak memory and bytes kept; then
   the zero-shot CLI under ``torchrun`` against phase 4's top-1 and every
   image's predicted class. The six CLI runs share one ``torchrun``
   process (``dist_worker``), started before phase 15 and run beside
   phase 16 (which measures no time; phase 18's samples/s then share the
   card, and every check holds its runs to references made alone);
19. zoo (``run_zoo``): plain CLIP ViT-B/32 (``experiments/model/b32.yaml``,
   its text tower 512 wide with 8 heads) and OpenAI's RN50 geometry over
   it (``msclip_torch/config/rn50.json``): zero-shot on 512 synthetic
   images, 100 classes x 80 templates, batch 256, bf16, K1 held to 12 a
   batch in each tower (RN50: the text tower only); fp32 features of 8
   images and 8 prompts, the card against the CPU within ``ZOO_ATOL``
   (``--zoo-faults`` shows it catching planted card-side faults); 3 bf16
   train steps of b32.yaml at batch 256, K1 and K2 held to 24 a step;
   then the same two with ``TPU.USE_FUSED_BLOCK`` (``run_zoo_fused``):
   zero-shot with K5 held to 12 a batch at E = 768 (b32.yaml's image
   tower) and 12 a text chunk at E = 512 (both text towers), K1 to none;
   fp32 features of 8 images and 16 prompts, the card against the CPU
   within ``ZOO_ATOL``; bf16 fused image and text features against
   unfused, least cosine > 0.999; then each [off] family over
   b32-yfcc-msclips.json at full width, cut to 6 layers (adapters,
   LoRA+MoE, CvT outside and inside, ConViT, Container, Gumbel, the
   Perceiver latents, the three bottom-to-top paths, windowed fusion, the
   four ``PRALLEL_T2B_*``/pooling variants, the plain and
   outside-the-trunk stems, conv1d pooling): one fp32 forward, the card
   against the CPU, K1 held to the blocks no plug-in sits inside; and one
   bf16 train step of the Gumbel family (the logits must move). Phases 2-3
   also hold and time K1 and K2 at E = 512, H = 8 (``ZOO_ATTN_SHAPES``,
   ``ZOO_BWD_SHAPES``).

Phase 1 also logs whether ``g++`` finds ``<jpeglib.h>`` and links
``-ljpeg``, where Pillow's libjpeg-62 is and whether the port's vendored
headers compile and link against it (the native pipeline's two routes),
and the CUDA toolkit's ``<nvjpeg.h>`` and ``-lnvjpeg`` (``jpeg_probe``),
without failing the run.

Phase 3 also holds the trunk block's elementwise chain (K7: ``ln``,
``bias``, ``bias_residual_ln``, ``bias_gelu``, ``bias_residual``) against
its plain versions at the B/32 and B/16 image batches' rows in fp32 and
bf16 (the bias kernels bit for bit, the LayerNorms within
``tests/block_chain_checks.assert_ln_close``), times each in turns with
its plain version, the eager ops it replaces, against its bytes bound,
reads each wrapper's host cost, and times whole blocks, eager against
``layers.chain_block`` (``check_block_chain``); phase 4 holds each K7
kernel to 11 launches an image batch and 12 a text chunk.

Phase 3 also holds the int8 quantizers, LayerNorm + quant (K3) and
QuickGELU + quant (K4), against their plain versions in fp32 and bf16
(K4 bit for bit, and on every bf16 bit pattern, ``k4_exhaustive``; the
edge rows of both bit for bit, K3's non-finite rows among them),
reads faults planted into a torch copy of the plain versions against the
same check, and times both in turns with the plain version (event and
device time, ``vs_plain``) and beside ``torch.compile`` of it;
and it holds the fused half-blocks, attention (K5) and MLP (K6), against
their plain versions in fp32 and bf16, reads faults planted into a torch
copy of the plain versions against the same check, and times both beside
the port's unfused half (with K1, and with SDPA in K1's place, for K5) and
``torch.compile`` of the plain version; K5 and K6 each in turns with its
unfused half (K1's; the cuBLAS MLP half), by event and device time, with
``vs_unfused``, the ratio of their device times; at E = 768 and, at the
text shapes of b32.yaml and RN50, at E = 512 (``HALF_SHAPES_512``). A ``k5_design`` line
gives, apart from the measurements, the bytes K5's groups stage from the
L2 as the design reckons them (``staged_l2_bytes``; no counter reads
them), a ``k6_design`` line K6's plan (``mlp_plan``).

The ``[seconds]`` line gives each phase's time. The line before the last
is a JSON object with one entry per kernel; the last line is ``{"ok":
true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from msclip_torch.ops import attention as A
from msclip_torch.ops import block_chain as K7
from msclip_torch.ops import block_fused as BF
from msclip_torch.ops import cuda_build
from msclip_torch.ops import halfblock_tuning as HT
from msclip_torch.ops import quant as Q

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K1 in bf16 also mean |got - plain| <= 2^-10 mean |plain|, as K2 below: a
# weight left unrounded before P V moves a share of the outputs by an ulp,
# which the elementwise limit lets through
FWD_MEAN_TOL = 2.0 ** -10
# the faults planted into a copy of the plain forward (bf16 only), each of
# which must read above the mean limit: the weights left in fp32 before
# P V, and the scale applied after the mask, (s + mask) D^-1/2, a fault
# only where the mask holds finite values other than 0 (FWD_FAULT_SHAPE)
FWD_FAULTS = ("w_unrounded", "scale_after_mask")
# K2, elementwise |got - plain| <= atol + rtol |plain|: fp32 as the JAX
# package's grad tests; bf16 with room for one bf16 ulp of the output
# (2^-7 relative at most) where kernel and plain round to neighbours
BWD_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
# and in bf16 mean |got - plain| <= 2^-10 mean |plain| for each of dQ, dK
# and dV, a quarter of bf16's unit roundoff: sums in another order move a
# few outputs by an ulp, a rounding point moved or dropped (W or dS left in
# fp32) moves a share of one gradient's outputs, which the elementwise
# limit lets through
BWD_MEAN_TOL = 2.0 ** -10
# the faults planted into a copy of the plain backward (bf16 only), and the
# limit each must read above at every bf16 shape
BWD_FAULTS = {"no_D": "elementwise", "no_mask": "elementwise",
              "w_unrounded": "mean", "ds_unrounded": "mean"}
B32_CONFIG = os.path.join(REPO, "msclip_torch", "config",
                          "b32-yfcc-msclips.json")
B16_CONFIG = os.path.join(REPO, "msclip_torch", "config",
                          "b16-yfcc-msclips.json")
# K3/K4 against their plain versions: q within 1; per row |s - s_plain| <=
# S_RTOL s_plain (fp32: the LayerNorm's sums in another order; bf16: one
# bf16 ulp of the row's largest |h|, 2^-7 relative at most); q s within one
# quantization step of q_plain s_plain: the step of the larger scale, plus
# what the two scales' difference moves the largest value, 127 |s - s_p|
S_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
QUANT_FAULTS = ("roundf", "no_floor", "fused_affine", "reciprocal")
TIES = (127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5)
L2_BYTES = 50 * 2 ** 20
# K5/K6, elementwise |got - plain| <= atol + rtol max(|plain|, |plain - x|):
# fp32 at the JAX package's block tolerance (tests/test_kernels.py:250);
# bf16 with room for a few bf16 ulps (2^-7 relative at most each) of the
# residual branch, plain - x, where kernel and plain, summing in another
# order, round it to neighbours: where the branch cancels x, one ulp of the
# branch is many ulps of the result
HALF_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
# and in bf16 mean |got - plain| <= 2^-10 mean |plain - x|, a quarter of
# bf16's unit roundoff of the branch: sums in another order move a few
# elements by an ulp, a rounding point moved or dropped moves most of them.
# In fp32 the planted rounding faults change nothing and the sums' order
# alone sets the mean, so fp32 has no such limit
HALF_MEAN_TOL = {torch.bfloat16: 2.0 ** -10}
# the faults planted into a copy of the plain half-blocks
HALF_FAULTS = {"attention_halfblock": ("bias_after_cast", "no_mask",
                                       "weights_unrounded"),
               "mlp_halfblock": ("bias_after_cast", "gelu_rounded_first")}


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def device_and_packages():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to check")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi:  # one line a card
        print(line, flush=True)
    smi = smi[0]
    found = {}
    for mod in ("yaml", "regex", "PIL", "ftfy"):
        try:
            __import__(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        packages=json.dumps(found))
    jpeg_probe()
    return smi


def jpeg_probe():
    """What this host offers a JPEG decoder, logged only (it never fails
    the run; phase ``native`` builds and fails): ``g++`` finding the
    system's ``<jpeglib.h>`` and linking ``-ljpeg``; the libjpeg-62 that
    Pillow ships (its path) and whether the port's vendored headers
    (``msclip_torch/native/include``) compile and link against it, the
    native pipeline's second route; and, for a decoder on the card
    instead, the CUDA toolkit's nvJPEG (``<nvjpeg.h>``, ``-lnvjpeg``)."""
    from msclip_torch import native as N

    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    jpeg_src = ("#include <cstdio>\n#include <jpeglib.h>\nint main() { "
                "jpeg_error_mgr e; jpeg_std_error(&e); return 0; }\n")
    probes = {
        "jpeglib": (jpeg_src, [], ["-ljpeg"]),
        "nvjpeg": ("#include <nvjpeg.h>\nint main() { nvjpegHandle_t h; "
                   "return (int)nvjpegCreateSimple(&h); }\n",
                   ["-I", os.path.join(cuda, "include")],
                   ["-L", os.path.join(cuda, "lib64"), "-lnvjpeg"]),
    }
    found = {"pillow_libjpeg": json.dumps(N.pillow_libjpeg())}
    if N.pillow_libjpeg():
        d = os.path.dirname(N.pillow_libjpeg())
        probes["pillow"] = (jpeg_src, ["-I", N.INCLUDE_DIR],
                            [f"-L{d}",
                             f"-l:{os.path.basename(N.pillow_libjpeg())}",
                             f"-Wl,-rpath,{d}"])
    try:
        with tempfile.TemporaryDirectory() as d:
            for name, (src, inc, libs) in probes.items():
                path = os.path.join(d, f"{name}.cc")
                with open(path, "w") as f:
                    f.write(src)
                for key, extra in ((f"{name}_h", ["-fsyntax-only"]),
                                   (f"{name}_link",
                                    ["-o", path + ".out", *libs])):
                    r = subprocess.run(["g++", path, *inc, *extra],
                                       capture_output=True, text=True,
                                       timeout=120)
                    found[key] = r.returncode == 0
                    if r.returncode:
                        found[f"{key}_error"] = json.dumps(
                            (r.stderr.strip().splitlines() or [""])[0][:160])
    except Exception as e:  # noqa: BLE001 (a probe: logged, never fatal)
        found["error"] = json.dumps(repr(e)[:200])
    log("jpeg_probe", **found)
    return found


# kernels held to the build check: no bf16 instantiation of these may spill
# registers, and none of K1, K2, K5, K6, E1 or E2 may have its wgmma
# serialized (ptxas C7510-C7515); every bf16 K5, K6, E1 and E2
# instantiation must hold wgmma
SPILL_CHECKED = ("attention_fwd_bf16_kernel", "attention_bwd_bf16_kernel",
                 "attention_halfblock_kernel<bf16", "mlp_halfblock_kernel<bf16",
                 "attn_half_variant_kernel<bf16", "core_out_kernel<bf16")
WGMMA_CHECKED = ("attention_fwd", "attention_bwd", "attention_halfblock_kernel",
                 "mlp_halfblock_kernel", "attn_half_variant_kernel", "core_out_kernel")
WGMMA_REQUIRED = ("attention_halfblock_kernel<bf16", "mlp_halfblock_kernel<bf16",
                  "attn_half_variant_kernel<bf16", "core_out_kernel<bf16")


def kernel_name(mangled):
    """A readable name of a mangled kernel of the port: ``name<args>``."""
    m = re.search(r"(attention_(?:fwd|bwd)_(?:bf16|f32)_kernel)I((?:Li\d+E)+)E",
                  mangled)
    if m:
        return f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"
    m = re.search(r"((?:ln|gelu)_quant_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                  mangled)
    if m:
        return f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}>"
    m = re.search(r"((?:attention|mlp)_halfblock_kernel|attn_half_variant_kernel|"
                  r"core_out_kernel)I(f|13__nv_bfloat16)((?:Li\d+E)*)", mangled)
    if m:
        ints = "".join("," + n for n in re.findall(r"Li(\d+)E", m[3]))
        return f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'}{ints}>"
    return mangled


def sass_functions(path):
    """``{function name: [SASS opcodes]}`` of a built library
    (``cuobjdump -sass``), NOPs left out."""
    nvcc = cuda_build.find_nvcc()
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m[1])
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", ln)
        if name is not None and m and not m[1].startswith("NOP"):
            funcs[name].append(m[1])
    return funcs


def wgmma_counts(path):
    """``{kernel name: wgmma instructions}`` of a built library, from its
    SASS (HGMMA is the SASS of wgmma)."""
    return {k: sum(op.startswith("HGMMA") for op in ops)
            for k, ops in sass_functions(path).items()}


def quant_sass_per_element(path, kernel="gelu_quant_kernel"):
    """K4's (``gelu_quant_kernel``) or K3's (``ln_quant_kernel``) SASS in a
    built ``quant.cu`` library: per instantiation, the instructions of its
    main path (static count: from its first instruction to its last
    ``EXIT``, the loop over a thread's chunks unrolled, so each instruction
    once) over the elements a thread (or lane) of it holds, 8 a chunk, and
    how many of those are MUFU (``ex2``, ``rcp``, ``rsq``), fp32 arithmetic
    and conversions; the subroutines placed after it (the slow path of an
    IEEE division, or K4's rare exact row ``gelu_quant_row_wide``), which
    the main path reaches only through ``CALL``, are counted apart.
    ``python3 -c "import chip_smoke as C;
    print(C.quant_sass_per_element('<lib>.so', 'ln_quant_kernel'))"``
    reads any build of ``quant.cu``."""
    out = {}
    for name, ops in sass_functions(path).items():
        m = re.match(kernel + r"<\w+,(\d+)>", name)
        if not m:
            continue
        n = 8 * int(m[1])
        end = max(i for i, op in enumerate(ops) if op.startswith("EXIT")) + 1
        main = ops[:end]

        def count(*prefixes):
            return sum(op.startswith(prefixes) for op in main) / n

        out[name] = {
            "main_instructions": len(main), "elements_a_thread": n,
            "per_element": len(main) / n, "mufu_per_element": count("MUFU"),
            "fp32_per_element": count("FFMA", "FMUL", "FADD", "FMNMX",
                                      "FSETP", "FSEL", "FCHK"),
            "conversions_per_element": count("F2I", "I2F", "FRND", "F2F",
                                             "F2FP"),
            "calls_in_main": sum(op.startswith("CALL") for op in main),
            "subroutine_instructions": len(ops) - end}
    return out


def build_kernels():
    """Every source at once, one nvcc each. Prints what ``ptxas -v`` reports
    for each kernel instantiation (registers, shared memory, spills), the
    wgmma instructions of K5's, K6's, E1's and E2's, and K3's and K4's SASS
    instructions an element (:func:`quant_sass_per_element`). Fails if a
    bf16 instantiation of K1, K2, K5, K6, E1 or E2 spills registers, if
    ptxas serializes the wgmma of a K1, K2, K5, K6, E1 or E2 instantiation
    (C7510-C7515), or if a bf16 K5, K6, E1 or E2 instantiation holds no
    wgmma."""
    t0 = time.time()
    sources = (A.SOURCE, A.BWD_SOURCE, Q.SOURCE, K7.SOURCE, BF.SOURCE,
               HT.SOURCE)

    def build_and_read(source):
        """One source's build, then its ptxas report and SASS readings
        (each source read as soon as it is built, beside the others)."""
        path = cuda_build.build(source)
        spilled, serialized, no_wgmma = [], [], []
        with open(path + ".log") as f:
            lines = f.read().splitlines()
        # per kernel: "Function properties for <mangled name>", then its
        # stack and spills, then "Used <n> registers ..."
        report = []
        for i, ln in enumerate(lines):
            if re.search(r"\(C751[0-5]\)", ln):
                m = re.search(r"'(\w+)'", ln)  # a warning that names no
                # kernel counts against the checked ones
                if m is None or any(k in kernel_name(m[1])
                                    for k in WGMMA_CHECKED):
                    serialized.append(ln.strip())
            if "ptxas info" in ln and "Used" in ln:
                name = kernel_name(lines[i - 2])
                spills = re.findall(r"(\d+) bytes spill", lines[i - 1])
                if any(k in name for k in SPILL_CHECKED) \
                        and any(int(n) for n in spills):
                    spilled.append(name)
                report.append(f"{name}: {ln.split(':', 1)[-1].strip()}; "
                              f"{lines[i - 1].strip()}")
        extra = {}
        if source == Q.SOURCE:
            extra["k3_sass"] = json.dumps(quant_sass_per_element(
                path, "ln_quant_kernel"))
            extra["k4_sass"] = json.dumps(quant_sass_per_element(path))
        if source in (BF.SOURCE, HT.SOURCE):
            wgmma = wgmma_counts(path)
            extra["wgmma"] = json.dumps(wgmma)
            no_wgmma += [k for k, n in wgmma.items()
                         if n == 0 and any(r in k for r in WGMMA_REQUIRED)]
            if not any(any(r in k for r in WGMMA_REQUIRED) for k in wgmma):
                no_wgmma.append(f"no bf16 K5/K6/E1/E2 kernel in {source}")
        return (report, extra, f"{time.time() - t0:.1f}",
                (spilled, serialized, no_wgmma))

    with cf.ThreadPoolExecutor(len(sources)) as pool:
        results = list(pool.map(build_and_read, sources))
    faults = [[], [], []]
    for source, (report, extra, seconds, found) in zip(sources, results):
        log("build", source=source, seconds=seconds,
            ptxas=json.dumps(report), **extra)
        for kept, new in zip(faults, found):
            kept += new
    spilled, serialized, no_wgmma = faults
    if spilled or serialized or no_wgmma:
        raise AssertionError(f"build check: spills {spilled}; serialized wgmma "
                             f"{serialized}; bf16 K5/K6/E1/E2 without wgmma "
                             f"{no_wgmma}")


def halfblock_jobs(B, L, causal, dtype, p, gen, tuning=False):
    """The inputs and the calls of ``i`` (the input set) that phases 3 and
    12 time at one shape, defined here once: ``xs``, ``n`` input sets of x
    cycled past the L2 (a timing touches at most 33); ``k5``; ``unfused``,
    the port's unfused half with K1; ``unfused_sdpa``, the same with SDPA
    in K1's place; ``k6``; ``unfused_mlp``, the port's unfused MLP half
    (``layer_norm`` + cuBLAS ``c_fc`` + QuickGELU + cuBLAS ``c_proj`` +
    residual). With ``tuning`` also ``qkvs``, E2's input for each x
    (the hybrid's LayerNorm and library GEMM); ``e1``, a function of the
    variant; ``e2``; ``k1_matmul`` and ``sdpa_matmul``, K1 or SDPA on the
    same qkv with the out-projection, bias and residual in torch; and
    ``hybrid``."""
    from msclip_torch.models import layers as TL

    F = torch.nn.functional
    E = p["ln_1.weight"].shape[0]  # the block's width: 768 or 512
    H = E // 64
    mask = TL.build_causal_mask(L, device="cuda") if causal else None
    nbytes = B * L * E * torch.finfo(dtype).bits // 8 * (4 if tuning else 1)
    n = min(33, max(1, math.ceil(2 * L2_BYTES / nbytes)))
    xs = [torch.randn(B, L, E, device="cuda", generator=gen).to(dtype)
          for _ in range(n)]

    def ln(x):
        return TL.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"])

    def out_proj(i, ctx):
        return xs[i] + TL.linear(ctx, p["attn.out_proj.weight"],
                                 p["attn.out_proj.bias"])

    def sdpa(qkv):
        q, k, v = qkv.view(B, L, 3, H, 64).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return o.transpose(1, 2).reshape(B, L, E)

    jobs = {"xs": xs, "n": n, "mask": mask,
            "k5": lambda i: BF.fused_attention_halfblock(xs[i], p, H, mask),
            "unfused": lambda i: xs[i] + TL.attention(p, ln(xs[i]), H, mask),
            "unfused_sdpa": lambda i: out_proj(i, sdpa(TL.linear(
                ln(xs[i]), p["attn.in_proj_weight"], p["attn.in_proj_bias"]))),
            "k6": lambda i: BF.fused_mlp_halfblock(xs[i], p),
            "unfused_mlp": lambda i: xs[i] + TL.mlp(p, TL.layer_norm(
                xs[i], p["ln_2.weight"], p["ln_2.bias"]))}
    if tuning:
        qkvs = [(ln(x) @ p["attn.in_proj_weight"].t()
                 + p["attn.in_proj_bias"]).contiguous() for x in xs]
        jobs.update(
            qkvs=qkvs,
            e1=lambda v: lambda i: HT.attention_halfblock_variant(xs[i], p, v),
            e2=lambda i: HT.core_out_halfblock(xs[i], qkvs[i], p),
            k1_matmul=lambda i: out_proj(i, A.fused_attention_qkv(qkvs[i], H)),
            sdpa_matmul=lambda i: out_proj(i, sdpa(qkvs[i])),
            hybrid=lambda i: HT.hybrid_b(xs[i], p))
    return jobs


def traced_turns():
    """The turns (:func:`turns`) of phases 3 and 12 in fp32 and bf16: K5
    against the unfused half with K1 at ``HALF_SHAPES`` and
    ``TUNING_SHAPES``, and at E = 512 at ``HALF_SHAPES_512``; K6 against
    the unfused MLP half at ``HALF_SHAPES`` and ``HALF_SHAPES_512``;
    at ``TUNING_SHAPES`` each E1 variant and the whole hybrid against the
    unfused half, E2 against K1 with the out-projection; the calls of
    :func:`halfblock_jobs`. Every call is
    made once before the first trace. ``{key: turns}``, keys as
    :func:`turn_key`. Runs in a process of its own
    (:func:`traced_turns_in_subprocess`): on the card, in a process that
    had run the other phases first (many other kernels, and
    ``torch.compile``), torch.profiler traced none of these calls; why is
    not known. The fp32 turns time ``FP32_TURN_ITERS`` calls a timing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    jobs = {}
    for dtype in (torch.float32, torch.bfloat16):
        p512 = half_params(gen, dtype, 512)
        for B, L, causal in HALF_SHAPES_512[dtype]:
            j = halfblock_jobs(B, L, causal, dtype, p512, gen)
            for kind, other in (("k5", "unfused"), ("k6", "unfused_mlp")):
                jobs[turn_key(kind, B, L, dtype, causal, E=512)] = (
                    j[kind], j[other], j["n"], "unfused")
        p = half_params(gen, dtype)
        for B, L, causal in sorted(set(HALF_SHAPES) | {
                (B, L, False) for B, L in TUNING_SHAPES}):
            tuning = not causal and (B, L) in TUNING_SHAPES
            j = halfblock_jobs(B, L, causal, dtype, p, gen, tuning)
            key = lambda kind, v=None: turn_key(  # noqa: E731
                kind, B, L, dtype, causal, v)
            jobs[key("k5")] = (j["k5"], j["unfused"], j["n"], "unfused")
            if (B, L, causal) in HALF_SHAPES:
                jobs[key("k6")] = (j["k6"], j["unfused_mlp"], j["n"],
                                   "unfused")
            if tuning:
                for v in TUNING_VARIANTS:
                    jobs[key("e1", v)] = (j["e1"](v), j["unfused"], j["n"],
                                          "unfused")
                jobs[key("e2")] = (j["e2"], j["k1_matmul"], j["n"],
                                   "k1_matmul")
                jobs[key("hybrid")] = (j["hybrid"], j["unfused"], j["n"],
                                       "unfused")
    for kernel, other, _, _ in jobs.values():
        kernel(0)
        other(0)
    torch.cuda.synchronize()
    per_call = {}  # a yardstick's records, traced once for all its turns
    return {key: turns(kernel, other, n, name, per_call,
                       FP32_TURN_ITERS if "float32" in key.split() else 30)
            for key, (kernel, other, n, name) in jobs.items()}


# the measurements that set ops/tuning.py's sm_90 row: K1 and K2 with
# MSCLIP_ATTN_PACK 2 against 1 at the B/32 image tower's attention (bf16),
# and B/16's int8 text tower (a classifier chunk of 1024 prompts, L = 77)
# with the fused int8 gate at 77 (K3/K4 in every block) against 96 (none)
TUNING_PACK_SHAPE = (256, 50)
TUNING_TEXT_CHUNK = 1024
# calls of 140-270 ms a timing (at 30 the measurements took 307 s; 6 in
# PR 15; 3 since PR 16, a depth cut for the time limit: the pair differs
# by 2x)
TUNING_TEXT_ITERS = 3


def int8_text_quantizers():
    """``(K3, K4)`` launches of one B/16 int8 text block on the card: the
    fused int8 block's two LayerNorm quantizers and one GELU quantizer
    where the card's gate (``ops/tuning.py``) admits L = 77, else none."""
    from msclip_torch.models.layers import int8_min_seq

    return (2, 1) if 77 >= int8_min_seq(torch.device("cuda")) else (0, 0)


def verdict(row):
    """Whether the candidate (an :func:`in_turns` row's kernel) beat the
    default (its yardstick): by device time, or by event time where the
    profiler gave no trace that counts (for calls of many milliseconds
    the two agree within 1%); ``basis`` says which."""
    if row["vs_library"] is not None:
        return {"wins": row["vs_library"] < 1, "basis": "device"}
    return {"wins": row["ms"] < row["library_ms"],
            "basis": "event (device not measured)"}


def measure_tuning(part):
    """The tuning row's measurements, each pair in turns by event and
    device time (:func:`in_turns`: the candidate as the kernel, the
    table's default as the yardstick): ``part`` "gate", ``int8_gate``,
    ``encode_text`` of the B/16 int8 model at gate 77 against 96; or
    "pack", ``pack_fwd`` and ``pack_bwd``, K1 and K2 at pack 2 against 1
    on the same rows. Each entry carries ``wins`` and its ``basis``
    (:func:`verdict`). Each part runs in a fresh process of its
    own (:func:`tuning_in_subprocess`): in a process that had traced the
    other part first, the profiler lost records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return measure_int8_gate() if part == "gate" else measure_lane_pack()


def measure_int8_gate():
    """:func:`measure_tuning`'s ``int8_gate``."""
    from msclip_torch.data import ClipTokenizer, get_classnames, get_templates
    from msclip_torch.eval.zero_shot import load_eval_model
    from msclip_torch.models.msclip import build_spec

    cfg = b16_config("TPU.COMPUTE_DTYPE", "bfloat16", "TPU.INT8_EVAL", True)
    model = load_eval_model(cfg, build_spec(cfg), "cuda")
    names, templates = get_classnames("imagenet"), get_templates("imagenet")
    texts = [t.format(c) for c in names for t in templates]
    tok = ClipTokenizer()
    chunks = [torch.from_numpy(tok(texts[i * TUNING_TEXT_CHUNK:
                                         (i + 1) * TUNING_TEXT_CHUNK])).cuda()
              for i in range(2)]
    kept = os.environ.get("MSCLIP_INT8_MIN_SEQ")

    def text(gate):
        def f(i):
            os.environ["MSCLIP_INT8_MIN_SEQ"] = str(gate)
            with torch.inference_mode():
                return model.encode_text(chunks[i % 2])
        return f

    try:
        reset_launches()
        text(77)(0)
        text(96)(1)
        torch.cuda.synchronize()
        k3 = Q.ln_quant.launches
        row = in_turns(text(77), text(96), 2, one_record=False,
                       iters=TUNING_TEXT_ITERS)
    finally:
        if kept is None:
            os.environ.pop("MSCLIP_INT8_MIN_SEQ", None)
        else:
            os.environ["MSCLIP_INT8_MIN_SEQ"] = kept
    out = {"int8_gate": {
        "model": "b16-yfcc-msclips", "tower": "text", "B": TUNING_TEXT_CHUNK,
        "L": 77, "dtype": "bfloat16", "candidate": 77, "default": 96,
        "k3_launches_at_77": k3, "ms": row["ms"],
        "default_ms": row["library_ms"], "device_ms": row["device_ms"],
        "default_device_ms": row["library_device_ms"], **verdict(row)}}
    if k3 == 0:
        raise AssertionError("gate 77 launched no K3 in the text tower")
    return out


def measure_lane_pack():
    """:func:`measure_tuning`'s ``pack_fwd`` and ``pack_bwd``."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, L = TUNING_PACK_SHAPE
    E, H, dt = 768, 12, torch.bfloat16
    n = min(33, max(1, math.ceil(2 * L2_BYTES / (B * L * 3 * E * 2))))
    qkvs = [torch.randn(B, L, 3 * E, device="cuda", generator=gen).to(dt)
            for _ in range(n)]
    gs = [torch.randn(B, L, E, device="cuda", generator=gen).to(dt)
          for _ in range(n)]
    mask = A.pack_mask(L, 2, qkvs[0].device)  # the wrapper's cached mask
    jobs = {
        "fwd": (lambda i: A.fused_attention_qkv(qkvs[i], H, lane_pack=2),
                lambda i: A.fused_attention_qkv(qkvs[i], H, lane_pack=1)),
        "bwd": (lambda i: A.fused_attention_qkv_bwd(
                    qkvs[i].view(B // 2, 2 * L, 3 * E),
                    gs[i].view(B // 2, 2 * L, E), H, mask),
                lambda i: A.fused_attention_qkv_bwd(qkvs[i], gs[i], H))}
    out = {}
    for name, (packed, plain) in jobs.items():
        row = in_turns(packed, plain, n)
        out["pack_" + name] = {
            "B": B, "L": L, "E": E, "dtype": "bfloat16", "candidate": 2,
            "default": 1, "ms": row["ms"], "default_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "default_device_ms": row["library_device_ms"], **verdict(row)}
    return out


def tuning_in_subprocess():
    """:func:`measure_tuning`'s two parts, each in a fresh Python process
    on the same card; logs each measurement and the row it supports
    beside the table's."""
    out = {}
    for part in ("gate", "pack"):
        r = subprocess.run(
            [sys.executable, "-c", "import json, chip_smoke as C; "
             f"print('TUNING ' + json.dumps(C.measure_tuning('{part}')))"],
            cwd=REPO, capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("TUNING ")]
        if r.returncode or not lines:
            raise AssertionError(f"tuning measurements ({part}) failed "
                                 f"({r.returncode}): {r.stderr[-3000:]}")
        out.update(json.loads(lines[-1][len("TUNING "):]))
    for name, row in out.items():
        log("tuning", measure=name, **row)
    from msclip_torch.ops import tuning as T

    pack = 2 if out["pack_fwd"]["wins"] and out["pack_bwd"]["wins"] else 1
    gate = 77 if out["int8_gate"]["wins"] else 96
    row = T._TABLE["sm_90"]
    log("tuning_row", measured_attn_lane_pack=pack, measured_int8_min_seq=gate,
        table_attn_lane_pack=row.attn_lane_pack,
        table_int8_min_seq=row.int8_min_seq,
        origin="the table keeps the default unless both (pack) or the one "
               "(gate) measurement wins")
    return out


# calls a timing of the fp32 turns (30 in the bf16 ones): the fp32 rows are
# on no main path, and their calls of 1-30 ms took most of the traced
# turns' time; a depth cut that keeps the script within its limit
FP32_TURN_ITERS = 5  # PR 15: 10; a depth cut for the time limit


def turn_key(kind, B, L, dtype, causal=False, variant=None, E=768):
    return " ".join(str(k) for k in (
        kind, variant, B, L, E != 768 and f"E{E}",
        str(dtype).replace("torch.", ""), causal and "causal")
        if k not in (None, False))


def traced_turns_in_subprocess():
    """:func:`traced_turns` in a fresh Python process on the same card."""
    r = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke as C; "
         "print('TRACED ' + json.dumps(C.traced_turns()))"],
        cwd=REPO, capture_output=True, text=True)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("TRACED ")]
    if r.returncode or not lines:
        raise AssertionError(f"traced turns failed ({r.returncode}): "
                             f"{r.stderr[-3000:]}")
    return json.loads(lines[-1][len("TRACED "):])


def cuda_ms(fn, n_inputs, iters=30, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls, cycling
    through ``n_inputs`` input sets so that each call finds its inputs
    out of the L2 cache."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_records(fn, n_inputs, iters):
    """``{name: (count, us)}``: the device records (kernels, memsets) of
    ``iters`` calls ``fn(i)`` as ``torch.profiler`` traces them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_inputs)
        torch.cuda.synchronize()
    records = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            records[e.key] = (e.count,
                              e.self_cuda_time_total if t is None else t)
    return records


def records_per_call(fn, n_inputs, iters=30, tries=6):
    """``{name: count}`` of the device records one call ``fn(i)`` makes:
    from traces of ``iters`` calls, the first counts that two traces agree
    on, each a whole multiple of ``iters``; None if no two of ``tries``
    agree. A trace now and then comes back with no device records, or
    could lose some; two that lost the same ones are not expected."""
    seen = []
    for _ in range(tries):
        counts = {k: n for k, (n, _) in
                  device_records(fn, n_inputs, iters).items()}
        if counts and all(n % iters == 0 for n in counts.values()):
            if counts in seen:
                return {k: n // iters for k, n in counts.items()}
            seen.append(counts)
    return None


def device_ms(fn, n_inputs, event_ms, per_call, iters=30, tries=5):
    """Device time of ``fn(i)`` per call: the summed durations of the
    device records of ``iters`` calls cycling through ``n_inputs`` input
    sets. Unlike the event time of :func:`cuda_ms` it leaves out the time
    the card waits for the host, which calls of a few tens of microseconds,
    or an autograd backward, show on a busy host. A trace counts only if it
    holds ``iters`` times ``per_call`` records of each name
    (:func:`records_per_call`; a trace that lost records reads low) and if
    its time is at most ``event_ms``, the event time of the same calls, and
    5% more; else it is taken again. None if no trace of ``tries`` counts."""
    want = {k: iters * n for k, n in per_call.items()}
    for _ in range(tries):
        records = device_records(fn, n_inputs, iters)
        ms = sum(us for _, us in records.values()) / iters / 1e3
        if {k: n for k, (n, _) in records.items()} == want \
                and 0 < ms <= 1.05 * event_ms:
            return ms
    return None


def in_turns(kernel, library, n_inputs, one_record=True, per_call=None,
             iters=30):
    """The kernel and its one-call yardstick timed in turns, library,
    kernel, kernel, library, so that a drift of the card's clock between
    the two reads on both. Each turn takes the event time (:func:`cuda_ms`,
    the yardstick of every kernel's ``ms``), then the device time
    (:func:`device_ms`, held to that event time). ``ms`` and
    ``library_ms`` are the means of each pair of event times,
    ``device_ms`` and ``library_device_ms`` of device times; ``vs_library``
    is ``device_ms / library_device_ms``: where a call is short, the host's
    launch rate bounds the event times of both from below. With
    ``one_record`` a call of the kernel's wrapper must show one device
    record, its kernel. ``per_call``, where given, keeps each call's
    records (:func:`records_per_call`) across turns, so that a yardstick
    shared by several kernels is traced for them once. Where the
    profiler gives no trace that counts, the device times and
    ``vs_library`` are None (not measured) and ``device_error`` says why.
    ``iters``: calls a timing and a trace (fewer for calls of many
    milliseconds)."""
    per_call = {} if per_call is None else per_call
    for fn in (kernel, library):
        if fn not in per_call:
            per_call[fn] = records_per_call(fn, n_inputs, iters)
    if one_record and per_call[kernel] is not None \
            and sum(per_call[kernel].values()) != 1:
        raise AssertionError(f"a kernel call traced {per_call[kernel]}")
    turns = []
    for fn in (library, kernel, kernel, library):
        event = cuda_ms(fn, n_inputs, iters)
        turns.append((event, None if per_call[fn] is None else
                      device_ms(fn, n_inputs, event, per_call[fn], iters)))

    def mean(i, j, k):
        t = (turns[i][k], turns[j][k])
        return None if None in t else sum(t) / 2

    row = {"ms": mean(1, 2, 0), "library_ms": mean(0, 3, 0),
           "device_ms": mean(1, 2, 1), "library_device_ms": mean(0, 3, 1),
           "turns_ms": turns, "kernel_records": per_call[kernel],
           "library_records_per_call": per_call[library]}
    row["vs_library"] = None
    if row["device_ms"] is not None and row["library_device_ms"] is not None:
        row["vs_library"] = row["device_ms"] / row["library_device_ms"]
    else:
        row["device_error"] = (
            "not measured: torch.profiler gave no trace with every record "
            "within the event time")
    return row


def attention_bound(B, L, E, H, dtype, mask, backward=False):
    """``(ms, by)``: the least time for the attention function, the larger
    of its I/O (each input byte read once, each output byte written once:
    ``B L 4E`` elements forward, qkv and g read and dqkv written ``B L 7E``
    backward, plus the mask) over the memory rate and its matrix work (two
    products of ``2 D`` flops per (query, key) pair and head forward, five
    backward, over the pairs this mask leaves: masked -inf pairs need no
    product) over the peak rate of ``dtype``."""
    item = torch.finfo(dtype).bits // 8
    io_cols, products = (7, 5) if backward else (4, 2)
    nbytes = B * L * io_cols * E * item + (0 if mask is None else L * L * 4)
    pairs = L * L if mask is None else int(torch.isfinite(mask).sum())
    flops = 2 * products * B * H * pairs * (E // H)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


ATTN_SHAPES = [  # (B, L, causal): image tower, text chunk, B/16 (the int8
    # slice's image batch, and a smaller one), odd batch
    (256, 50, False), (1024, 77, True), (256, 197, False), (64, 197, False),
    (5, 77, True)]
# (B, L) where K1 is also held under a random additive mask: finite values
# N(0, 1) and a random -inf pattern that leaves a finite score in each row
FWD_FAULT_SHAPE = (64, 77)
# (B, L, causal) at b32.yaml's and RN50's text width (E = 512, H = 8, the
# zoo phase's text tower: the classifier's chunks and the train batch), and
# a 512-wide tower at L = 50 unmasked; checked and timed as ATTN_SHAPES
ZOO_E, ZOO_H = 512, 8
ZOO_ATTN_SHAPES = [(1024, 77, True), (256, 77, True), (256, 50, False)]
ZOO_BWD_SHAPES = [(256, 77, True), (256, 50, False)]
# phase 17's batch buckets: K1 in every block of a bundle's towers, K5 in
# every block of a fused bundle's
SERVE_BUCKETS = (1, 4, 16, 64)
FUSED_BUCKETS = (1, 64)
# (B, L, causal) of the served towers, image (50) and text (77), where K1
# and K5 are also held to their plain versions, untimed: every bucket's
# launch takes a plan of its own
SERVE_ATTN_SHAPES = [(b, L, L == 77) for L in (50, 77) for b in SERVE_BUCKETS]
SERVE_HALF_SHAPES = [(b, L, L == 77) for L in (50, 77) for b in FUSED_BUCKETS]


def fwd_mean_reading(got, want):
    """``mean |got - want|`` over ``FWD_MEAN_TOL mean |want|``: at most 1
    passes."""
    got, want = got.float(), want.float()
    return ((got - want).abs().mean()
            / (FWD_MEAN_TOL * want.abs().mean())).item()


def fwd_with_fault(qkv, n_head, mask, fault):
    """``attention_qkv_plain`` with one fault planted: ``w_unrounded``
    keeps the weights in fp32 for P V, ``scale_after_mask`` adds the mask
    before the scale."""
    B, L, three_e = qkv.shape
    E = three_e // 3
    q, k, v = qkv.float().view(B, L, 3, n_head, E // n_head).unbind(2)
    s = torch.einsum("blhd,bmhd->bhlm", q, k)
    scale = (E // n_head) ** -0.5
    if mask is None:
        s = s * scale
    elif fault == "scale_after_mask":
        s = (s + mask) * scale
    else:
        s = s * scale + mask
    w = torch.softmax(s, dim=-1)
    if fault != "w_unrounded":
        w = w.to(qkv.dtype).float()
    return torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, E).to(
        qkv.dtype)


def fwd_check(qkv, n_head, mask, dtype):
    """K1 against its plain version: the worst element within ``TOL``,
    and in bf16 the mean within ``FWD_MEAN_TOL`` with every planted fault
    of :func:`fwd_with_fault` that the mask allows above it. Returns the
    readings."""
    got = A.fused_attention_qkv(qkv, n_head, mask)
    want = A.attention_qkv_plain(qkv, n_head, mask)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    row = {"max_abs_err": err}
    if dtype == torch.bfloat16:
        row["mean_reading"] = fwd_mean_reading(got, want)
        finite = mask is not None and bool(
            (torch.isfinite(mask) & (mask != 0)).any())
        row["planted_faults"] = {
            f: fwd_mean_reading(fwd_with_fault(qkv, n_head, mask, f), want)
            for f in FWD_FAULTS if f != "scale_after_mask" or finite}
    if not (err <= TOL[dtype] and row.get("mean_reading", 0.0) <= 1.0
            and all(r > 1.0 for r in row.get("planted_faults", {}).values())):
        raise AssertionError(
            f"attention kernel {tuple(qkv.shape)} {dtype}: max |err| {err} "
            f"(limit {TOL[dtype]}), mean and planted faults against "
            f"{FWD_MEAN_TOL} mean |plain|: {row}")
    return row


def check_attention(E=768, H=12):
    """K1 against its plain version (:func:`fwd_check`) at each shape of
    ``ATTN_SHAPES`` and, at E = 512 and 8 heads, ``ZOO_ATTN_SHAPES``,
    timed in turns with SDPA and beside the plain version, then held,
    untimed, under a random mask at ``FWD_FAULT_SHAPE`` and at the served
    shapes ``SERVE_ATTN_SHAPES``."""
    from msclip_torch.models.layers import build_causal_mask

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(*x, E, H) for x in ATTN_SHAPES] + [
        (*x, ZOO_E, ZOO_H) for x in ZOO_ATTN_SHAPES]
    for B, L, causal, E, H in shapes:
        mask = build_causal_mask(L, device="cuda") if causal else None
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.finfo(dtype).bits // 8
            n_inputs = max(1, math.ceil(2 * L2_BYTES / (B * L * 3 * E * item)))
            qkv = [torch.randn(B, L, 3 * E, device="cuda", generator=gen)
                   .to(dtype) for _ in range(n_inputs)]
            heads = [t.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
                     for t in qkv]
            row = {
                "B": B, "L": L, "causal": causal, "E": E, "H": H,
                "dtype": str(dtype).replace("torch.", ""),
                **fwd_check(qkv[0], H, mask, dtype),
                **in_turns(
                    lambda i: A.fused_attention_qkv(qkv[i], H, mask),
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        heads[i][0], heads[i][1], heads[i][2],
                        is_causal=causal), n_inputs),
                "plain_ms": cuda_ms(lambda i: A.attention_qkv_plain(
                    qkv[i], H, mask), n_inputs, iters=10),
            }
            row["bound_ms"], row["bound_by"] = attention_bound(
                B, L, E, H, dtype, mask)
            log("kernel", name="attention_fwd", **row,
                bound_us=row["bound_ms"] * 1e3)
            rows.append(row)
            del qkv, heads
    E, H = shapes[0][3:]  # the random mask and the served shapes: E = 768
    B, L = FWD_FAULT_SHAPE
    off = torch.rand(L, L, device="cuda", generator=gen) < 0.3
    off[torch.arange(L, device="cuda"),
        torch.randint(0, L, (L,), device="cuda", generator=gen)] = False
    mask = torch.where(off, -torch.inf, torch.randn(
        L, L, device="cuda", generator=gen)).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(B, L, 3 * E, device="cuda", generator=gen).to(dtype)
        row = {"B": B, "L": L, "mask": "random",
               "dtype": str(dtype).replace("torch.", ""),
               **fwd_check(qkv, H, mask, dtype)}
        log("kernel", name="attention_fwd", **row)
        rows.append(row)
    for B, L, causal in SERVE_ATTN_SHAPES:
        mask = build_causal_mask(L, device="cuda") if causal else None
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, L, 3 * E, device="cuda",
                              generator=gen).to(dtype)
            row = {"B": B, "L": L, "causal": causal, "served": True,
                   "dtype": str(dtype).replace("torch.", ""),
                   **fwd_check(qkv, H, mask, dtype)}
            log("kernel", name="attention_fwd", **row)
            rows.append(row)
    return rows


BWD_SHAPES = [  # (B, L, causal): image and text at the train batch, B/16,
    (256, 50, False), (256, 77, True), (64, 197, False), (5, 77, True)]


def bwd_reading(got, want, dtype):
    """The worst ``|got - want| / (atol + rtol |want|)``: at most 1 passes."""
    atol, rtol = BWD_TOL[dtype]
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())
            ).max().item()


def bwd_mean_reading(got, want):
    """The worst over dQ, dK and dV of ``mean |got - want|`` over
    ``BWD_MEAN_TOL mean |want|``: at most 1 passes."""
    E = got.shape[-1] // 3
    got, want = got.float(), want.float()
    return max(((got[..., i * E:(i + 1) * E] - want[..., i * E:(i + 1) * E])
                .abs().mean() / (BWD_MEAN_TOL * want[..., i * E:(i + 1) * E]
                                 .abs().mean())).item() for i in range(3))


def bwd_with_fault(qkv, g, n_head, mask, fault):
    """``attention_qkv_bwd_plain`` with one fault planted, to show what the
    bf16 limit catches: ``no_D`` drops ``rowsum(dW * W)`` from dS,
    ``no_mask`` ignores the mask, ``w_unrounded`` and ``ds_unrounded`` keep
    W (for dV) and dS (for dQ and dK) in fp32."""
    B, L, three_e = qkv.shape
    E, dt = three_e // 3, qkv.dtype
    q, k, v = qkv.float().view(B, L, 3, n_head, E // n_head).unbind(2)
    gh = g.float().view(B, L, n_head, E // n_head)
    scale = (E // n_head) ** -0.5
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    if mask is not None and fault != "no_mask":
        s = s + mask
    w = torch.softmax(s, dim=-1)
    wc = w if fault == "w_unrounded" else w.to(dt).float()
    dv = torch.einsum("bhlm,blhd->bmhd", wc, gh)
    dw = torch.einsum("blhd,bmhd->bhlm", gh, v)
    ds = dw * w if fault == "no_D" else (
        dw - (dw * w).sum(-1, keepdim=True)) * w
    if fault != "ds_unrounded":
        ds = ds.to(dt).float()
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q) * scale
    return torch.cat([t.reshape(B, L, E) for t in (dq, dk, dv)],
                     dim=-1).to(dt)


def check_attention_bwd(E=768, H=12):
    """K2 against its plain version (elementwise, and in bf16 the mean of
    each gradient), then the times of K2 and SDPA's backward in turns and
    of the plain version. SDPA's backward reuses the softmax statistics its
    forward saved; K2 recomputes them from qkv. In bf16, each planted
    fault of :func:`bwd_with_fault` is read against both limits: dropping
    D or the mask must read above the elementwise one, leaving W or dS
    unrounded above the mean one."""
    from msclip_torch.models.layers import build_causal_mask

    F = torch.nn.functional
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, L, causal, E, H in [(*x, E, H) for x in BWD_SHAPES] + [
            (*x, ZOO_E, ZOO_H) for x in ZOO_BWD_SHAPES]:
        mask = build_causal_mask(L, device="cuda") if causal else None
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.finfo(dtype).bits // 8
            n_inputs = max(1, math.ceil(2 * L2_BYTES / (B * L * 4 * E * item)))
            qkv = [torch.randn(B, L, 3 * E, device="cuda", generator=gen)
                   .to(dtype) for _ in range(n_inputs)]
            g = [torch.randn(B, L, E, device="cuda", generator=gen).to(dtype)
                 for _ in range(n_inputs)]
            got = A.fused_attention_qkv_bwd(qkv[0], g[0], H, mask)
            want = A.attention_qkv_bwd_plain(qkv[0], g[0], H, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            reading = bwd_reading(got, want, dtype)
            mean_reading = bwd_mean_reading(got, want) \
                if dtype == torch.bfloat16 else None
            tol = "atol {} rtol {}".format(*BWD_TOL[dtype])
            if not (reading <= 1.0 and torch.isfinite(got.float()).all()
                    and (mean_reading is None or mean_reading <= 1.0)):
                raise AssertionError(
                    f"attention bwd kernel B={B} L={L} {dtype}: max |err| "
                    f"{err}, {reading} of the limit {tol}, {mean_reading} "
                    f"of the mean limit")
            faults = {}
            if dtype == torch.bfloat16:
                tol += f", mean {BWD_MEAN_TOL} per gradient"
                for fault, limit in BWD_FAULTS.items():
                    if fault == "no_mask" and mask is None:
                        continue
                    bad = bwd_with_fault(qkv[0], g[0], H, mask, fault)
                    faults[fault] = {
                        "reading": bwd_reading(bad, want, dtype),
                        "mean_reading": bwd_mean_reading(bad, want)}
                missed = [f for f, limit in BWD_FAULTS.items() if f in faults
                          and not faults[f]["reading" if limit == "elementwise"
                                            else "mean_reading"] > 1.0]
                if missed:
                    raise AssertionError(
                        f"bf16 limits {tol} miss planted faults {missed} at "
                        f"B={B} L={L}: {faults}")
            # SDPA on head-split views; its forward runs once per input
            sdpa = []
            for t, gi in zip(qkv, g):
                q, k, v = (x.detach().requires_grad_() for x in
                           t.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4))
                out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
                sdpa.append((out, (q, k, v),
                             gi.view(B, L, H, E // H).transpose(1, 2)))
            row = {
                "B": B, "L": L, "causal": causal, "E": E, "H": H,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "tolerance": tol,
                "limit_reading": reading, "mean_reading": mean_reading,
                "planted_faults": faults,
                **in_turns(
                    lambda i: A.fused_attention_qkv_bwd(qkv[i], g[i], H, mask),
                    lambda i: torch.autograd.grad(
                        sdpa[i][0], sdpa[i][1], sdpa[i][2], retain_graph=True),
                    n_inputs),
                "plain_ms": cuda_ms(lambda i: A.attention_qkv_bwd_plain(
                    qkv[i], g[i], H, mask), n_inputs, iters=10),
            }
            row["bound_ms"], row["bound_by"] = attention_bound(
                B, L, E, H, dtype, mask, backward=True)
            log("kernel", name="attention_bwd", **row,
                bound_us=row["bound_ms"] * 1e3)
            rows.append(row)
            del qkv, g, sdpa
    return rows


QUANT_SHAPES = [(256, 197), (5, 77), (1, 1)]  # (B, L): B/16 image batch, ...
QUANT_WIDTH = {"ln_quant": 768, "gelu_quant": 3072}  # E, and 4E after c_fc


def quant_plain_with_fault(name, x, w, b, fault):
    """The plain version of K3 (``ln_quant``) or K4 (``gelu_quant``) with
    one fault planted: ``roundf`` rounds half away from zero, ``no_floor``
    drops the 1e-8 floor of the scale, ``fused_affine`` rounds ``w n + b``
    once (K3 only), ``reciprocal`` multiplies by ``1 / s``."""
    xf = x.float()
    if name == "ln_quant":
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        normed = ((xf - mean) * torch.rsqrt(var + 1e-12)).to(x.dtype)
        if fault == "fused_affine":
            h = (w.double() * normed.double() + b.double()).to(x.dtype)
        else:
            h = w.to(x.dtype) * normed + b.to(x.dtype)
        h = h.float()
    else:
        h = xf / (1.0 + torch.exp(-1.702 * xf))
    s = Q.div127(h.abs().amax(dim=-1, keepdim=True))
    if fault != "no_floor":
        s = torch.clamp_min(s, 1e-8)
    r = h * (1.0 / s) if fault == "reciprocal" else h / s
    r = torch.sign(r) * torch.floor(r.abs() + 0.5) if fault == "roundf" \
        else torch.round(r)
    return torch.clamp(r, -127, 127).to(torch.int8), s[..., 0]


def quant_reading(got, want, dtype):
    """What the K3/K4 check reads: the worst dequantized error |q s - q_p
    s_p|, the share of q that differ, the worst |dq|, the worst per-row
    |s - s_plain| / (S_RTOL s_plain) and the worst |q s - q_p s_p| over
    one step, max(s, s_p) + 127 |s - s_p|; the check passes when the last
    three are at most 1. Over the rows where the plain scale is finite (a
    non-finite row is held bit for bit, :func:`quant_bitwise`); a kernel's
    non-finite scale on such a row reads NaN and fails."""
    (q, s), (qp, sp) = got, want
    finite = torch.isfinite(sp)
    q, s, qp, sp = q[finite], s[finite], qp[finite], sp[finite]
    if s.numel() == 0:
        return {"max_abs_err": 0.0, "q_mismatch_share": 0.0, "max_dq": 0,
                "s_reading": 0.0, "dequant_reading": 0.0}
    dq = (q.int() - qp.int()).abs()
    # in fp64, where q s is exact: one step reads exactly 1
    q, s, qp, sp = q.double(), s.double(), qp.double(), sp.double()
    abs_err = (q * s[..., None] - qp * sp[..., None]).abs()
    step = torch.maximum(s, sp) + 127 * (s - sp).abs()
    deq = abs_err / step[..., None]
    s_read = ((s - sp).abs() / (S_RTOL[dtype] * sp)).max().item()
    return {"max_abs_err": abs_err.max().item(),
            "q_mismatch_share": (dq > 0).float().mean().item(),
            "max_dq": dq.max().item(), "s_reading": s_read,
            "dequant_reading": deq.max().item()}


def quant_passes(r):
    return (r["max_dq"] <= 1 and r["s_reading"] <= 1.0
            and r["dequant_reading"] <= 1.0)


def quant_edge_inputs(name, W, dtype):
    """Rows whose results are exact, ``[(x, w, b, (k, q_k, s_k))]`` with
    the known q and s of the first k rows. K3: constant rows (h = bias
    exactly) with the ties as bias (s = 1, q half to even: 127, 0, 2, 2,
    0, -2, -2), then rows of zeros with one outlier W (mean 1 and variance
    W - 1 are exact sums of integers); zero rows with a zero bias (s =
    1e-8, q = 0); the rows of :func:`ln_quant_nonfinite_rows` (an inf, a
    NaN, a -inf, w n + b overflowing to inf, a scale near the largest).
    K4: rows of exact GELUs (x >= 61) with max 254 (s = 2,
    the others on ties: 61 -> 30, 63 -> 32, 65 -> 32, 67 -> 34), zero rows,
    and zero rows with one outlier."""
    dev = "cuda"

    def pattern(values, n):
        return torch.tensor(values, device=dev).repeat(W // 7 + 1)[:W] \
            .expand(n, W)

    outlier = torch.zeros(3, W, device=dev)
    outlier[torch.arange(3), torch.tensor([0, W // 2, W - 1])] = \
        float(W) if name == "ln_quant" else 100.0
    if name == "ln_quant":
        w = torch.linspace(-2, 2, W, device=dev).to(dtype)
        consts = torch.tensor([0.0, 1.0, -3.0, 0.5, 1024.0], device=dev)
        x = torch.cat([consts[:, None].expand(5, W), outlier])[None]
        x = x.to(dtype).contiguous()
        zeros = torch.zeros(W, device=dev, dtype=dtype)
        return [(x, w, pattern(TIES, 1)[0].to(dtype).contiguous(),
                 (5, torch.round(pattern(TIES, 5)), 1.0)),
                (torch.zeros_like(x), w, zeros, (8, torch.zeros(8, W), 1e-8)),
                (*ln_quant_nonfinite_rows(W, dtype), (0, None, None))]
    gelu = [254.0, 61.0, 63.0, 65.0, 67.0, 0.0, -61.0]
    x = torch.cat([pattern(gelu, 4), torch.zeros(4, W, device=dev),
                   outlier])[None].to(dtype).contiguous()
    q_known = torch.cat([pattern([127.0, 30.0, 32.0, 32.0, 34.0, 0.0, 0.0], 4),
                         torch.zeros(4, W, device=dev)])
    s_known = torch.tensor([2.0] * 4 + [1e-8] * 4, device=dev)
    return [(x, None, None, (8, q_known, s_known))]


def ln_quant_nonfinite_rows(W, dtype, device="cuda"):
    """K3's rows whose LayerNorm or affine is not finite, ``(x [1, 5, W],
    w, b)`` in ``dtype``: random rows holding one +inf, one NaN and one
    -inf (mean or variance NaN or infinite: h NaN, s NaN, q 0), then rows
    of +-1 (mean 0, variance 1) whose column 0 meets w = 2^126 and b = the
    largest bf16, where w n + b overflows to inf in the first (s inf, q 0)
    and is 2.5e38 in the second, which starts at -1 (a finite scale near
    the largest). ``W`` even."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(5, W, generator=gen)
    x[0, 3 % W], x[1, W // 2], x[2, W - 1] = math.inf, math.nan, -math.inf
    x[3] = torch.tensor([1.0, -1.0]).repeat(W // 2)
    x[4] = -x[3]
    w, b = torch.ones(W), torch.zeros(W)
    w[0], b[0] = 2.0 ** 126, torch.finfo(torch.bfloat16).max
    return tuple(t.to(dtype).to(device).contiguous() for t in (x[None], w, b))


def every_bf16_rows(W=3072, device="cuda"):
    """K4's exhaustive input: a bf16 ``[65536, W]`` with one row for each
    bf16 bit pattern p: p, then p times W - 1 multipliers that keep
    |QuickGELU| at or below |QuickGELU(p)|, so that p plants the row's
    maximum where it can: m in (0, 1] for p > -0.74 (|h| grows with |x|
    there), m in (1, 8] below (|h| falls as x falls). The multiples
    spread each row's quotients h / s over (-127, 127]. A NaN p gives a
    row of NaN, an infinite one a row of infinities."""
    p = torch.arange(1 << 16, device=device, dtype=torch.int32) \
        .to(torch.int16).view(torch.bfloat16).float()[:, None]
    k = torch.arange(1, W, device=device, dtype=torch.float32) / (W - 1)
    rest = torch.where(p > -0.74, p * k, p * (1 + 7 * k))
    return torch.cat([p, rest], dim=1).to(torch.bfloat16).contiguous()


def quant_bitwise(got, want):
    """Whether a quantizer's q and s equal the plain version's bit for bit
    (any NaN scale equal to any NaN), and the rows where either differs."""
    (q, s), (qp, sp) = got, want
    s_same = (s.view(torch.int32) == sp.view(torch.int32)) \
        | (torch.isnan(s) & torch.isnan(sp))
    bad = ~s_same | (q != qp).any(dim=-1)
    return not bool(bad.any()), int(bad.sum())


def check_gelu_quant_exhaustive():
    """K4 on :func:`every_bf16_rows` against ``gelu_quant_plain``: q and s
    bit for bit on all 65,536 rows, or the run fails."""
    x = every_bf16_rows()
    got, want = Q.gelu_quant(x), Q.gelu_quant_plain(x)
    torch.cuda.synchronize()
    same, bad_rows = quant_bitwise(got, want)
    s = want[1]
    row = {"rows": x.shape[0], "W": x.shape[1], "bitwise": same,
           "rows_differing": bad_rows,
           "nan_scale_rows": int(torch.isnan(s).sum()),
           "inf_scale_rows": int(torch.isinf(s).sum()),
           "floor_scale_rows": int((s == torch.tensor(1e-8)).sum()),
           "q_nonzero_share": (want[0] != 0).float().mean().item(),
           "q_at_127_rows": int((want[0].abs() == 127).any(dim=-1).sum())}
    log("k4_exhaustive", **row)
    if not same:
        raise AssertionError(f"gelu_quant differs from its plain version on "
                             f"{bad_rows} of the 65,536 bf16 pattern rows")
    return row


def check_quant():
    """K3 and K4 against their plain versions in fp32 and bf16 at the
    shapes of the int8 slice (and an odd batch and one row), on edge rows
    that must match bit for bit (:func:`quant_bitwise`: K3's non-finite
    rows too) and give their known q and s, and with faults planted into a
    torch copy of the plain version read against the same check (the run
    fails unless ``roundf`` and ``no_floor`` are caught); K4's q and s must
    equal its plain version's bit for bit at every shape, and on every
    bf16 bit pattern (:func:`check_gelu_quant_exhaustive`). Times the
    kernels and the plain versions in turns (plain, kernel, kernel, plain;
    event and device time, as K1's) and, at the headline bf16 shape,
    ``torch.compile`` of the plain version."""
    rows = {"ln_quant": [], "gelu_quant": []}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, W in QUANT_WIDTH.items():
        plain = Q.ln_quant_plain if name == "ln_quant" else \
            Q.gelu_quant_plain
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.finfo(dtype).bits // 8
            cases = []  # (label, x, w, b, known results of the edge rows)
            for B, L in QUANT_SHAPES:
                x = torch.randn(B, L, W, device="cuda", generator=gen)
                x = (x if name == "ln_quant" else 2 * x).to(dtype)
                w = (1 + 0.1 * torch.randn(W, device="cuda",
                                           generator=gen)).to(dtype)
                b = (0.1 * torch.randn(W, device="cuda",
                                       generator=gen)).to(dtype)
                cases.append((f"{B}x{L}", x, w, b, None))
            cases += [("edge", *c) for c in quant_edge_inputs(name, W, dtype)]
            faults = {f: [] for f in QUANT_FAULTS
                      if name == "ln_quant" or f != "fused_affine"}
            edge_ok = True
            for label, x, w, b, known in cases:
                args = (x, w, b) if name == "ln_quant" else (x,)
                got = (Q.ln_quant if name == "ln_quant" else Q.gelu_quant)(
                    *args)
                want = plain(*args)
                torch.cuda.synchronize()
                reading = quant_reading(got, want, dtype)
                if name == "gelu_quant":
                    reading["bitwise"] = quant_bitwise(got, want)[0]
                if label == "edge":
                    k, q_k, s_k = known
                    exact = quant_bitwise(got, want)[0] and (k == 0 or bool(
                        (got[0][0, :k].float() == q_k.cuda()).all()
                        and (got[1][0, :k] == torch.as_tensor(
                            s_k, device="cuda")).all()))
                    edge_ok &= exact
                    reading["exact"] = exact
                for f in faults:
                    bad = quant_plain_with_fault(name, x, w, b, f)
                    faults[f].append(quant_reading(bad, want, dtype))
                    if label == "edge":
                        faults[f][-1]["exact"] = quant_bitwise(bad, want)[0]
                if not quant_passes(reading) or not reading.get("bitwise",
                                                                True):
                    raise AssertionError(f"{name} kernel {label} {dtype}: "
                                         f"{reading}")
                row = {"shape": label, "W": W,
                       "dtype": str(dtype).replace("torch.", ""), **reading}
                log("kernel_check", name=name, **row)
                rows[name].append(row)
            if not edge_ok:
                raise AssertionError(f"{name} {dtype}: the edge rows differ "
                                     "from the plain version's")
            # a fault is caught where a row fails the check or an edge row
            # is not exact
            caught = {f: not all(quant_passes(r) and r.get("exact", True)
                                 for r in rs) for f, rs in faults.items()}
            log("planted_faults", name=name, dtype=str(dtype),
                caught=json.dumps(caught), readings=json.dumps(
                    {f: [{k: r[k] for k in ("max_dq", "s_reading",
                                            "dequant_reading", "exact")
                          if k in r} for r in rs]
                     for f, rs in faults.items()}))
            if not (caught["roundf"] and caught["no_floor"]):
                raise AssertionError(f"{name} {dtype}: the check misses a "
                                     f"planted fault: {caught}")
            # times at the slice's shape, inputs cycled past the L2 cache
            B, L = QUANT_SHAPES[0]
            n_inputs = max(1, math.ceil(2 * L2_BYTES / (B * L * W * item)))
            xs = [torch.randn(B, L, W, device="cuda", generator=gen)
                  .to(dtype) for _ in range(n_inputs)]
            w, b = cases[0][2], cases[0][3]
            kernel = Q.ln_quant if name == "ln_quant" else Q.gelu_quant
            extra = (w, b) if name == "ln_quant" else ()
            t = in_turns(lambda i: kernel(xs[i], *extra),
                         lambda i: plain(xs[i], *extra), n_inputs)
            timing = {
                "shape": f"{B}x{L}", "W": W,
                "dtype": str(dtype).replace("torch.", ""),
                "ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": t["library_ms"],
                "plain_device_ms": t["library_device_ms"],
                "vs_plain": t["vs_library"], "turns_ms": t["turns_ms"],
                "library_ms": None,
                "bound_ms": B * L * (W * item + W + 4) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
            }
            if "device_error" in t:
                timing["device_error"] = t["device_error"]
            if dtype == torch.bfloat16:
                compiled_ms_later(timing, name, plain, xs, extra, n_inputs)
            log("kernel", name=name, **timing,
                bound_us=timing["bound_ms"] * 1e3)
            rows[name].append(timing)
            del xs, cases
    rows["gelu_quant"].append(check_gelu_quant_exhaustive())
    return rows


CHAIN_ROWS = (256 * 50, 256 * 197)  # B/32 and B/16 image batches of 256
CHAIN_E = 768
CHAIN_BITWISE = ("bias", "bias_gelu", "bias_residual")
HOST_CALLS = 1000  # calls a host-cost reading, on 64 rows


@functools.lru_cache(maxsize=None)
def block_chain_checks():
    """``tests/block_chain_checks.py``, loaded by path: the card tests'
    limit of a LayerNorm that sums in another order (``assert_ln_close``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "block_chain_checks", os.path.join(REPO, "tests",
                                           "block_chain_checks.py"))
    checks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checks)
    return checks


def chain_cases(rows, dtype, gen, p=None):
    """``{name: (kernel, plain, draw, bytes)}`` of each K7 kernel at
    ``rows`` rows of a width-768 block: ``draw()`` gives one input set,
    ``bytes`` what one call reads and writes, each byte once (the [N]
    vectors left out). The block's vectors ``p``: LayerNorm gains ``1 +
    0.1 z`` with two channels at 30, as the benchmark draws them, biases
    ``0.1 z``."""
    E = CHAIN_E
    item = torch.finfo(dtype).bits // 8
    if p is None:
        w = 1 + 0.1 * torch.randn(E, device="cuda", generator=gen)
        w[:2] = 30.0
        p = {"w": w, "b": 0.1 * torch.randn(E, device="cuda", generator=gen),
             **{f"b{n}": 0.1 * torch.randn(n * E, device="cuda",
                                           generator=gen) for n in (1, 3, 4)}}
        p = {k: v.to(dtype) for k, v in p.items()}

    def t(n, scale=1.0):
        return (scale * torch.randn(rows, n * E, device="cuda",
                                    generator=gen)).to(dtype)

    return {
        "ln": (K7.ln, K7.ln_plain, lambda: (t(1, 3.0), p["w"], p["b"]),
               2 * rows * E * item),
        "bias": (K7.bias, K7.bias_plain, lambda: (t(3), p["b3"]),
                 2 * rows * 3 * E * item),
        "bias_residual_ln": (K7.bias_residual_ln, K7.bias_residual_ln_plain,
                             lambda: (t(1), p["b1"], t(1, 3.0), p["w"],
                                      p["b"]), 4 * rows * E * item),
        "bias_gelu": (K7.bias_gelu, K7.bias_gelu_plain,
                      lambda: (t(4, 2.0), p["b4"]), 2 * rows * 4 * E * item),
        "bias_residual": (K7.bias_residual, K7.bias_residual_plain,
                          lambda: (t(1), p["b1"], t(1)),
                          3 * rows * E * item),
    }


def chain_check(name, got, want, args):
    """One K7 call against its plain version: ``bias``, ``bias_gelu`` and
    ``bias_residual`` bit for bit; ``bias_residual_ln``'s residual stream
    bit for bit and its LayerNorm, as ``ln``'s, within
    :func:`assert_ln_close`. Returns the largest absolute difference."""
    assert_ln_close = block_chain_checks().assert_ln_close
    if name == "ln":
        assert_ln_close(got, *args)
        pairs = [(got, want)]
    elif name == "bias_residual_ln":
        if not torch.equal(got[0], want[0]):
            raise AssertionError("bias_residual_ln: the residual stream "
                                 "differs from the plain version's")
        assert_ln_close(got[1], want[0], args[3], args[4])
        pairs = list(zip(got, want))
    else:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit for bit the plain "
                                 f"version's")
        pairs = [(got, want)]
    return max((a.float() - b.float()).abs().max().item() for a, b in pairs)


def host_us(fn, args, n=HOST_CALLS):
    """The host's microseconds a call of ``fn(*args)`` on small inputs,
    whose kernels finish well before the next launch."""
    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def eager_block(p, x, n_head=12):
    """``transformer_block``'s eager chain, as a step with grad runs it."""
    from msclip_torch.models import layers as L

    x = x + L.attention(p, L.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"]),
                        n_head)
    return x + L.mlp(p, L.layer_norm(x, p["ln_2.weight"], p["ln_2.bias"]))


def chain_block_params(gen, dtype=torch.bfloat16):
    """A width-768 trunk block's tensors: LayerNorm gains ``1 + 0.1 z``
    with two at 30, biases ``0.02 z``, projections ``0.02 z``."""
    E, p = CHAIN_E, {}
    for ln in ("ln_1", "ln_2"):
        w = 1.0 + 0.1 * torch.randn(E, generator=gen, device="cuda")
        w[:2] = 30.0
        p[f"{ln}.weight"] = w
        p[f"{ln}.bias"] = 0.02 * torch.randn(E, generator=gen, device="cuda")
    for key, bias, shape in (("attn.in_proj_weight", "attn.in_proj_bias",
                              (3 * E, E)),
                             ("attn.out_proj.weight", "attn.out_proj.bias",
                              (E, E)),
                             ("mlp.c_fc.weight", "mlp.c_fc.bias", (4 * E, E)),
                             ("mlp.c_proj.weight", "mlp.c_proj.bias",
                              (E, 4 * E))):
        p[key] = 0.02 * torch.randn(shape, generator=gen, device="cuda")
        p[bias] = 0.02 * torch.randn(shape[0], generator=gen, device="cuda")
    return {k: v.to(dtype) for k, v in p.items()}


def check_block_chain():
    """K7 against its plain versions, the eager ops it replaces, at the
    B/32 and B/16 image batches' rows (12,800 and 50,432; E = 768, the
    bias kernels 3E and 4E wide) in fp32 and bf16 (:func:`chain_check`);
    each kernel then timed in turns with its plain version (plain, kernel,
    kernel, plain; event and device time, inputs cycled past the L2),
    bf16 at both row counts and fp32 at B/16's, against the time of its
    bytes at the card's bandwidth (``bound_ms``); the plain version is
    the eager chain the kernel replaces, so it is ``library_ms`` too. The
    host's microseconds a wrapper call (``host_us``, beside the eager
    ops'). Last, whole blocks: the eager block and ``layers.chain_block``
    in turns at both row counts, bf16 (``block`` lines). Returns ``{name:
    rows}``."""
    from msclip_torch.models import layers as L

    out = {fn.__name__: [] for fn in K7.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).replace("torch.", "")
        for rows in CHAIN_ROWS:
            cases = chain_cases(rows, dtype, gen)
            for name, (kernel, plain, draw, nbytes) in cases.items():
                args = draw()
                err = chain_check(name, kernel(*args), plain(*args), args)
                row = {"n_rows": rows, "E": CHAIN_E, "dtype": label,
                       "max_abs_err": err,
                       "bitwise": name in CHAIN_BITWISE}
                log("kernel_check", name=f"block_{name}", **row)
                out[name].append(row)
                if dtype == torch.float32 and rows != CHAIN_ROWS[-1]:
                    continue
                n_inputs = max(2, math.ceil(2 * L2_BYTES / nbytes))
                sets = [draw() for _ in range(n_inputs)]
                t = in_turns(lambda i: kernel(*sets[i]),
                             lambda i: plain(*sets[i]), n_inputs)
                small = [a[:64] if a.dim() == 2 else a for a in args]
                timing = {
                    "n_rows": rows, "E": CHAIN_E, "dtype": label,
                    "ms": t["ms"], "device_ms": t["device_ms"],
                    "plain_ms": t["library_ms"],
                    "plain_device_ms": t["library_device_ms"],
                    "vs_plain": t["vs_library"], "turns_ms": t["turns_ms"],
                    "library_ms": t["library_ms"],
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes",
                    "host_us": host_us(kernel, small),
                    "plain_host_us": host_us(plain, small),
                }
                if t["device_ms"]:
                    timing["share_of_bound"] = (timing["bound_ms"]
                                                / t["device_ms"])
                if "device_error" in t:
                    timing["device_error"] = t["device_error"]
                log("kernel", name=f"block_{name}", **timing,
                    bound_us=timing["bound_ms"] * 1e3)
                out[name].append(timing)
                del sets
            del cases
    gen = torch.Generator(device="cuda").manual_seed(8)
    p = chain_block_params(gen)
    for rows in CHAIN_ROWS:
        xs = [torch.randn(256, rows // 256, CHAIN_E, device="cuda",
                          generator=gen).to(torch.bfloat16) for _ in range(2)]
        with torch.inference_mode():
            t = in_turns(lambda i: L.chain_block(p, xs[i], 12),
                         lambda i: eager_block(p, xs[i]), 2,
                         one_record=False, iters=10)
        log("block", n_rows=rows, E=CHAIN_E, dtype="bfloat16",
            chain_ms=t["ms"], eager_ms=t["library_ms"],
            chain_device_ms=t["device_ms"],
            eager_device_ms=t["library_device_ms"],
            vs_eager=t["vs_library"])
        del xs
    return out


# torch.compile baselines, timed after the last profiler trace: once a
# process has run torch.compile, torch.profiler traces no device record
COMPILE_BASELINES = []


def compiled_ms_later(row, name, plain, xs, extra, n_inputs):
    """Queue ``torch.compile`` of the plain version at the headline shape,
    a baseline only (the port never calls it), for
    :func:`run_compile_baselines` to write into ``row["compile_ms"]``."""
    COMPILE_BASELINES.append((row, name, plain, xs, extra, n_inputs))


def run_compile_baselines():
    """Time every queued ``torch.compile`` baseline; None where it does not
    compile here, with the error printed."""
    for row, name, plain, xs, extra, n_inputs in COMPILE_BASELINES:
        try:
            fn = torch.compile(plain)
            row["compile_ms"] = cuda_ms(lambda i: fn(xs[i], *extra), n_inputs)
        except Exception as e:  # a baseline may fail; the kernels may not
            log("compile_baseline", name=name, error=repr(e)[:300])
            row["compile_ms"] = None
        log("compile_baseline", name=name, dtype=row["dtype"],
            compile_ms=row["compile_ms"], kernel_ms=row["ms"])
    COMPILE_BASELINES.clear()


HALF_SHAPES = [  # (B, L, causal): image tower, text chunk, B/16, odd shapes
    (256, 50, False), (1024, 77, True), (256, 197, False), (5, 77, True),
    (1, 1, False)]
# K5/K6 at E = 512, 8 heads: the 512-wide text towers of b32.yaml and RN50
# (phase 19), the classifier's text chunk and a batch of 256 prompts
HALF_SHAPES_512 = {torch.bfloat16: [(1024, 77, True), (256, 77, True)],
                   torch.float32: [(256, 77, True)]}


def half_params(gen, dtype, E=768):
    """One block's tensors under the port's local names, drawn on the card:
    LayerNorm affines near (1, 0), weights of std fan_in^-1/2, biases of std
    0.1, all in ``dtype`` as the eval model holds them."""
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    p = {"ln_1.weight": 1 + r(E, scale=0.1), "ln_1.bias": r(E, scale=0.1),
         "ln_2.weight": 1 + r(E, scale=0.1), "ln_2.bias": r(E, scale=0.1),
         "attn.in_proj_weight": r(3 * E, E, scale=E ** -0.5),
         "attn.in_proj_bias": r(3 * E, scale=0.1),
         "attn.out_proj.weight": r(E, E, scale=E ** -0.5),
         "attn.out_proj.bias": r(E, scale=0.1),
         "mlp.c_fc.weight": r(4 * E, E, scale=E ** -0.5),
         "mlp.c_fc.bias": r(4 * E, scale=0.1),
         "mlp.c_proj.weight": r(E, 4 * E, scale=(4 * E) ** -0.5),
         "mlp.c_proj.bias": r(E, scale=0.1)}
    return {k: v.to(dtype) for k, v in p.items()}


def half_reading(got, want, x, dtype):
    """``(worst, mean, mean |err|)``: the worst ``|got - want| / (atol +
    rtol max(|want|, |want - x|))``, in bf16 ``mean |got - want| / (2^-10
    mean |want - x|)`` (0 in fp32), and the mean ``|got - want|``. The
    check passes where both readings are at most 1."""
    atol, rtol = HALF_TOL[dtype]
    want = want.float()
    err = (got.float() - want).abs()
    branch = (want - x.float()).abs()
    worst = (err / (atol + rtol * torch.maximum(want.abs(), branch))).max()
    mean = 0.0
    if dtype in HALF_MEAN_TOL:
        mean = err.mean().item() / max(
            HALF_MEAN_TOL[dtype] * branch.mean().item(), 1e-30)
    return worst.item(), mean, err.mean().item()


def half_with_fault(name, x, p, mask, fault):
    """The plain K5 (``attention_halfblock``) or K6 (``mlp_halfblock``) with
    one fault planted: ``bias_after_cast`` rounds each projection to the
    compute dtype and adds its bias in that dtype (the unfused block's
    ``linear``), ``no_mask`` ignores the mask, ``weights_unrounded`` keeps
    the softmax weights fp32 for PV, ``gelu_rounded_first`` rounds c_fc's
    output to the compute dtype before the QuickGELU."""
    dt, E = x.dtype, x.shape[-1]

    def proj(h, w, b):
        y = h.float() @ w.to(dt).float().t()
        if fault == "bias_after_cast":
            return y.to(dt) + b.to(dt)
        return (y + b.float()).to(dt)

    if name == "mlp_halfblock":
        h = BF.layer_norm(x, p["ln_2.weight"], p["ln_2.bias"])
        mid = proj(h, p["mlp.c_fc.weight"], p["mlp.c_fc.bias"]).float() \
            if fault == "bias_after_cast" else \
            h.float() @ p["mlp.c_fc.weight"].to(dt).float().t() \
            + p["mlp.c_fc.bias"].float()
        if fault == "gelu_rounded_first":
            mid = mid.to(dt).float()
        mid = (mid * torch.sigmoid(1.702 * mid)).to(dt)
        return x + proj(mid, p["mlp.c_proj.weight"], p["mlp.c_proj.bias"])
    B, L, _ = x.shape
    H = E // 64
    h = BF.layer_norm(x, p["ln_1.weight"], p["ln_1.bias"])
    w, b = p["attn.in_proj_weight"], p["attn.in_proj_bias"]
    q, k, v = (proj(h, w[i * E:(i + 1) * E], b[i * E:(i + 1) * E]).float()
               .view(B, L, H, 64) for i in range(3))
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * 0.125
    if mask is not None and fault != "no_mask":
        s = s + mask
    wts = torch.softmax(s, dim=-1)
    if fault != "weights_unrounded":
        wts = wts.to(dt).float()
    ctx = torch.einsum("bhlm,bmhd->blhd", wts, v).reshape(B, L, E).to(dt)
    return x + proj(ctx, p["attn.out_proj.weight"], p["attn.out_proj.bias"])


def staged_l2_bytes(B, L, S, boxes=True, item=2, E=768):
    """The bytes K5 stages from the L2 into shared memory at ``B`` samples
    of length ``L`` and width ``E`` in groups of ``S``: each of a group's
    GEMMs stages its weight rows and the group's rows, ``E`` values each:
    ``E / 64`` heads' q/k/v of 192 weight rows, and the out-projection's
    column tiles (four of 192 at E = 768, four of 128 at 512); with
    ``boxes`` (the TMA design) the rows in whole boxes of 128, else (the
    mma.sync design, groups of ``max(1, 128 // L)``) the rows
    themselves."""
    full, rest = divmod(B, S)
    rows = [S * L] * full + ([rest * L] if rest else [])
    if boxes:
        rows = [128 * math.ceil(r / 128) for r in rows]
    tile = 192 if E % 192 == 0 else 128
    return sum(((E // 64) * (r + 192) + (E // tile) * (r + tile)) * E * item
               for r in rows)


def halfblock_bound(name, B, L, dtype, mask, E=768):
    """``(ms, by)``: the least time for K5 or K6 at width ``E``, the larger
    of its I/O (x read and the output written once, the weights, LayerNorm
    and biases once, the mask) over the memory rate and its products (K5:
    four projections of ``2 L E^2`` a sample, and ``4 D`` flops per (query,
    key) pair and head the mask leaves; K6: two of ``8 L E^2``) over the
    peak rate of ``dtype``."""
    item = torch.finfo(dtype).bits // 8
    if name == "attention_halfblock":
        pairs = L * L if mask is None else int(torch.isfinite(mask).sum())
        flops = 8 * B * L * E * E + 4 * B * (E // 64) * pairs * 64
        nbytes = (2 * B * L * E + 4 * E * E + 2 * E) * item + 4 * E * 4 \
            + (0 if mask is None else L * L * 4)
    else:
        flops = 16 * B * L * E * E
        nbytes = (2 * B * L * E + 8 * E * E + 2 * E) * item + 5 * E * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def half_check(name, kernel, plain, extra, x, p, mask):
    """K5 (``attention_halfblock``) or K6 (``mlp_halfblock``) against its
    plain version on ``x`` as :func:`half_reading` gives it, with the
    faults of :func:`half_with_fault` read against the same check: raises
    unless the kernel is within the limits and every fault that changes
    the output is caught. Returns the readings."""
    dtype = x.dtype
    B, L, _ = x.shape
    got = kernel(x, *extra)
    want = plain(x, *extra)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    reading, mean_reading, mean_err = half_reading(got, want, x, dtype)
    tol = "atol {} rtol {}".format(*HALF_TOL[dtype])
    if dtype in HALF_MEAN_TOL:
        tol += f", mean {HALF_MEAN_TOL[dtype]} mean |plain - x|"
    if not (reading <= 1.0 and mean_reading <= 1.0
            and torch.isfinite(got.float()).all()):
        raise AssertionError(
            f"{name} kernel B={B} L={L} {dtype}: max |err| {err}, "
            f"{reading} and {mean_reading} of the limits {tol}")
    faults = {f: half_reading(half_with_fault(name, x, p, mask, f), want, x,
                              dtype)
              for f in HALF_FAULTS[name] if f != "no_mask" or mask is not None}
    missed = [f for f, (worst, mean, ferr) in faults.items()
              if ferr > 0 and worst <= 1.0 and mean <= 1.0]
    if missed:
        raise AssertionError(f"{name} {dtype} B={B} L={L}: the check misses "
                             f"{missed}: {faults}")
    return {"max_abs_err": err, "mean_abs_err": mean_err, "tolerance": tol,
            "limit_reading": reading, "mean_reading": mean_reading,
            "planted_faults": faults}


def check_halfblocks(traced):
    """K5 and K6 against their plain versions in fp32 and bf16 at the shapes
    of the fused slice (the image tower, a text chunk), B/16's and two odd
    ones (:func:`half_check`), at E = 512 (8 heads) at the text shapes of
    b32.yaml and RN50 (``HALF_SHAPES_512``), and K5 untimed at the served
    shapes ``SERVE_HALF_SHAPES``. Times each
    kernel, its plain version and, for K5, the port's unfused half with
    SDPA in K1's place. With ``traced`` (``--measure``) the kernel's time
    is its turns of :func:`traced_turns`: K5 against ``layer_norm`` +
    ``linear`` + K1 + ``linear`` + residual, K6 against the unfused MLP
    half (cuBLAS GEMMs), with ``vs_unfused``; at the image shape in bf16
    also ``torch.compile`` of the plain version. Without it (None) the
    kernel is timed alone by CUDA events and the ratios are left out.
    Logs, apart from the measurements, the bytes K5's groups stage from
    the L2 as
    :func:`staged_l2_bytes` reckons them and K6's plan (``mlp_plan``).
    Rows at E = 512 go under ``attention_halfblock_e512`` and
    ``mlp_halfblock_e512``."""
    from msclip_torch.models import layers as TL

    rows = {"attention_halfblock": [], "mlp_halfblock": [],
            "attention_halfblock_e512": [], "mlp_halfblock_e512": []}
    gen = torch.Generator(device="cuda").manual_seed(4)
    served_gen = torch.Generator(device="cuda").manual_seed(5)

    def shape_rows(p, B, L, causal, dtype):
        E = p["ln_1.weight"].shape[0]
        H, tag = E // 64, "" if E == 768 else f"_e{E}"
        j = halfblock_jobs(B, L, causal, dtype, p, gen)
        xs, n_inputs, mask = j["xs"], j["n"], j["mask"]
        kinds = {
            "attention_halfblock": (
                BF.fused_attention_halfblock,
                BF.attention_halfblock_plain, (p, H, mask),
                {"unfused_sdpa_ms": j["unfused_sdpa"]}),
            "mlp_halfblock": (
                BF.fused_mlp_halfblock, BF.mlp_halfblock_plain, (p,), {})}
        for name, (kernel, plain, extra, baselines) in kinds.items():
            row = {"B": B, "L": L, "E": E, "causal": causal,
                   "dtype": str(dtype).replace("torch.", ""),
                   **half_check(name, kernel, plain, extra, xs[0], p,
                                mask),
                   "plain_ms": cuda_ms(lambda i: plain(xs[i], *extra),
                                       n_inputs, iters=10),
                   "library_ms": None}
            if traced is None:  # event time alone, no ratio
                row["ms"] = cuda_ms(lambda i: kernel(xs[i], *extra),
                                    n_inputs)
            else:
                # K5 and the unfused half with K1, K6 and the unfused MLP
                # half, in turns, by event and device time; vs_unfused
                # from device times
                row.update(traced[turn_key(
                    "k5" if name == "attention_halfblock" else "k6", B, L,
                    dtype, causal, E=E)])
            for key, fn in baselines.items():
                row[key] = cuda_ms(fn, n_inputs)
            if traced is not None and dtype == torch.bfloat16 \
                    and (B, L, E) == (256, 50, 768):
                compiled_ms_later(row, name, plain, xs, extra, n_inputs)
            row["bound_ms"], row["bound_by"] = halfblock_bound(
                name, B, L, dtype, mask, E)
            log("kernel", name=name + tag, **row,
                bound_us=row["bound_ms"] * 1e3)
            rows[name + tag].append(row)
        if dtype == torch.bfloat16:
            S = BF.attn_plan(B, L, dtype, BF.sm_count(0), E)["S"]
            log("k5_design", B=B, L=L, E=E, group=S,
                staged_l2_gb=staged_l2_bytes(B, L, S, E=E) / 1e9,
                staged_l2_gb_mma_sync_design=staged_l2_bytes(
                    B, L, max(1, 128 // L), boxes=False, E=E) / 1e9,
                origin="reckoned by staged_l2_bytes, not measured")
            plan = BF.mlp_plan(B * L, dtype, BF.sm_count(0), E)
            log("k6_design", B=B, L=L, E=E, **{k: plan[k] for k in (
                "big", "groups", "slots", "slot_rows")},
                hidden_rows_gb=2 * B * L * 4 * E * 2 / 1e9,
                origin="the plan of mlp_plan; the hidden rows' bytes "
                       "written and read back, reckoned, not measured")

    for dtype in (torch.float32, torch.bfloat16):
        p = half_params(gen, dtype)
        for B, L, causal in HALF_SHAPES:
            shape_rows(p, B, L, causal, dtype)
        H = 768 // 64
        for B, L, causal in SERVE_HALF_SHAPES:
            mask = TL.build_causal_mask(L, device="cuda") if causal else None
            x = torch.randn(B, L, 768, device="cuda",
                            generator=served_gen).to(dtype)
            row = {"B": B, "L": L, "E": 768, "causal": causal,
                   "served": True, "dtype": str(dtype).replace("torch.", ""),
                   **half_check("attention_halfblock",
                                BF.fused_attention_halfblock,
                                BF.attention_halfblock_plain, (p, H, mask),
                                x, p, mask)}
            log("kernel", name="attention_halfblock", **row)
            rows["attention_halfblock"].append(row)
        p512 = half_params(gen, dtype, 512)
        for B, L, causal in HALF_SHAPES_512[dtype]:
            shape_rows(p512, B, L, causal, dtype)
    return rows


def b32_zero_shot_config(fused=False):
    """Full-width B/32 zero-shot on 512 synthetic images, 100 classes, batch
    256, bf16, seed 0; with ``fused``, ``TPU.USE_FUSED_BLOCK`` set as an
    attribute (as ``bench.py`` does)."""
    from msclip_torch.config import get_default_config, update_config

    cfg = get_default_config()
    update_config(cfg, B32_CONFIG, opts=[
        "DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", 512,
        "TEST.BATCH_SIZE_PER_GPU", 256, "TEST.SUBSET_CLASSES", 100,
        "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", 0,
        "MODEL.PRETRAINED_MODEL", ""])
    if fused:
        cfg.TPU.USE_FUSED_BLOCK = True
    return cfg


def run_slice(save_pred=""):
    """Zero-shot MS-CLIP-S B/32 at full width through the port's entry
    point, with the launches of the attention kernel and of each K7
    kernel counted over the run (each 11 an image batch and 12 a text
    chunk); with ``save_pred``, its logits go to that ``.npz``
    (``TEST.SAVE_PRED``) for phase 18. Returns K1's launches and K7's
    (:func:`chain_launches`)."""
    from msclip_torch.eval.zero_shot import run_zero_shot

    cfg = b32_zero_shot_config()
    cfg.TEST.SAVE_PRED = save_pred
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    value, stats = run_zero_shot(cfg, device="cuda")
    torch.cuda.synchronize()
    launches, chain = A.fused_attention_qkv.launches, chain_launches()
    expected = 11 * stats["n_image_batches"] + 12 * stats["n_text_chunks"]
    log("slice", model="b32-yfcc-msclips", dtype="bfloat16",
        top1=value, n_images=stats["n_images"],
        images_per_s=stats["images_per_sec"],
        classifier_s=stats["classifier_s"],
        image_batches=stats["n_image_batches"],
        text_chunks=stats["n_text_chunks"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        attention_launches=launches, chain_launches=json.dumps(chain))
    if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
        raise AssertionError(f"zero-shot run gave {value} on "
                             f"{stats['n_images']} images")
    if launches != expected or launches == 0:
        raise AssertionError(f"attention kernel launched {launches} times, "
                             f"expected 11 x {stats['n_image_batches']} "
                             f"image batches + 12 x {stats['n_text_chunks']} "
                             f"text chunks = {expected}")
    if chain != dict.fromkeys(chain, expected):
        raise AssertionError(f"block chain kernels launched {chain}, "
                             f"expected {expected} each")
    return launches, chain


def card_against_cpu(atol=1e-3, fused=False):
    """Full-width fp32 features of 8 images and 16 prompts: the card with
    its kernels against the CPU with the plain versions, same weights. With
    ``fused``, under ``TPU.USE_FUSED_BLOCK``: the card's towers launch K5
    once per block and K1 never."""
    from msclip_torch.config import get_default_config, update_config
    from msclip_torch.data import ClipTokenizer, get_classnames, get_templates
    from msclip_torch.data.datasets import SyntheticImageDataset
    from msclip_torch.eval.zero_shot import load_eval_model
    from msclip_torch.models.msclip import build_spec

    cfg = get_default_config()
    update_config(cfg, B32_CONFIG, opts=["MODEL.PRETRAINED_MODEL", ""])
    if fused:
        cfg.TPU.USE_FUSED_BLOCK = True
    spec = build_spec(cfg)  # fp32: also turns TF32 off
    ds = SyntheticImageDataset(n=8, size=spec.image_resolution)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(8)]))
    texts = [t.format(c) for c in get_classnames("imagenet")[:4]
             for t in get_templates("imagenet")[:4]]
    tokens = torch.from_numpy(ClipTokenizer()(texts))
    feats = {}
    for dev in ("cuda", "cpu"):
        model = load_eval_model(cfg, spec, dev)
        reset_launches()
        with torch.inference_mode():
            feats[dev] = (model.encode_image(images.to(dev)).cpu(),
                          model.encode_text(tokens.to(dev)).cpu())
        if dev == "cuda":
            launches = fused_launches()
    errs = [(a - b).abs().max().item()
            for a, b in zip(feats["cuda"], feats["cpu"])]
    log("fused_card_vs_cpu" if fused else "card_vs_cpu", dtype="float32",
        image_err=errs[0], text_err=errs[1], atol=atol,
        card_launches_k1_k5_k6=json.dumps(launches))
    if not all(math.isfinite(e) and e <= atol for e in errs):
        raise AssertionError(f"card and CPU features differ: {errs} > {atol}")
    blocks = spec.effective_vision_layers - 1 + spec.text_layers
    if fused and launches != (0, blocks, 0):
        raise AssertionError(f"the card's fused towers launched (K1, K5, K6) "
                             f"{launches}, expected (0, {blocks}, 0)")


def train_config(*opts):
    from msclip_torch.config import get_default_config, update_config

    cfg = get_default_config()
    update_config(cfg, B32_CONFIG, opts=[
        "DATASET.DATASET", "synthetic", *opts])
    return cfg


def run_train_slice(steps=6, batch=256, timed_steps=5):
    """Full-width B/32 bf16 training through the port's entry point, with
    both kernels' launches counted over the run; then the step time on a
    batch already on the card (CUDA events, after 2 warm-up steps).
    Returns the launches and the resident step's ms and peak memory."""
    from msclip_torch.models.msclip import build_spec, init_params
    from msclip_torch.tools.train import train
    from msclip_torch.train.trainer import MAX_LOGIT_SCALE, make_train_step

    cfg = train_config(
        "TRAIN.BATCH_SIZE_PER_GPU", batch, "TPU.COMPUTE_DTYPE", "bfloat16",
        "DATASET.NUM_SAMPLES", steps * batch, "TRAIN.END_EPOCH", 1,
        "TPU.SEED", 0)
    spec = build_spec(cfg)
    bn_key = f"{spec.stem_prefix}.bn1.running_mean"
    bn_before = init_params(spec, torch.Generator().manual_seed(0))[bn_key]
    A.fused_attention_qkv.launches = 0
    A.fused_attention_qkv_bwd.launches = 0
    state, stats = train(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = (A.fused_attention_qkv.launches,
                A.fused_attention_qkv_bwd.launches)
    params = state.model.params()
    bn_moved = (params[bn_key].cpu() - bn_before).abs().max().item()
    logit_scale = params["logit_scale"].item()
    per_step = spec.effective_vision_layers - 1 + spec.text_layers
    log("train", model="b32-yfcc-msclips", dtype="bfloat16", batch=batch,
        steps=stats["steps"], losses=json.dumps(stats["losses"]),
        samples_per_s=stats["samples_per_s"], seconds=stats["seconds"],
        peak_mem_gb=stats["peak_mem_gb"], fwd_launches=launches[0],
        bwd_launches=launches[1], bn_running_mean_moved=bn_moved,
        logit_scale=logit_scale)
    if stats["steps"] != steps or not all(
            math.isfinite(x) for x in stats["losses"]):
        raise AssertionError(f"train run: {stats['steps']} steps, losses "
                             f"{stats['losses']}")
    if launches != (per_step * steps, per_step * steps):
        raise AssertionError(f"attention kernels launched {launches} times "
                             f"in {steps} steps, expected {per_step} per "
                             "step each")
    if not bn_moved > 0 or not logit_scale <= MAX_LOGIT_SCALE:
        raise AssertionError(f"BN running mean moved {bn_moved}, "
                             f"logit_scale {logit_scale}")

    step_fn = make_train_step(spec)
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randn(batch, 224, 224, 3, device="cuda", generator=gen)
    tokens = torch.randint(1, 49406, (batch, 77), device="cuda",
                           generator=gen, dtype=torch.int32)
    tokens[:, 0], tokens[:, 20] = 49406, 49407
    tokens[:, 21:] = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step_fn(state, images, tokens)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed_steps):
        step_fn(state, images, tokens)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / timed_steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train_step", batch=batch, dtype="bfloat16", step_ms=step_ms,
        samples_per_s_resident=batch / step_ms * 1e3, peak_mem_gb=peak)
    return launches, {"step_ms": step_ms, "peak_mem_gb": peak}


def train_card_against_cpu(batch=4, loss_tol=1e-4, grad_rel=1e-4,
                           noise_room=4.0):
    """One fp32 train step of full-width B/32 (TF32 off) on 4 synthetic
    pairs: the loss and every parameter gradient on the card (K1, K2)
    against the CPU (plain versions), from the same weights.

    Each gradient's worst error is read relative to its own largest value.
    Two more CPU runs, with the images nudged by +-``2**-22`` of
    themselves, read how far fp32's own rounding moves each gradient (a
    ReLU or BN at a knife's edge moves some of the branch's tensors by
    percents). A tensor passes within ``grad_rel``, or within
    ``noise_room`` times its own noise where that is larger."""
    from msclip_torch.data.pairs import make_train_dataset
    from msclip_torch.models.msclip import (MSClipModel, build_spec,
                                            init_params)
    from msclip_torch.train.trainer import make_loss_fn

    cfg = train_config("TPU.COMPUTE_DTYPE", "float32",
                       "DATASET.NUM_SAMPLES", batch)
    spec = build_spec(cfg)  # fp32: also turns TF32 off
    ds = make_train_dataset(cfg)
    images, tokens = (torch.from_numpy(np.stack(x))
                      for x in zip(*(ds[i] for i in range(batch))))
    params = init_params(spec, torch.Generator().manual_seed(0))
    loss_fn = make_loss_fn(spec)
    results = {}
    for run, dev, nudge in (("card", "cuda", 0.0), ("cpu", "cpu", 0.0),
                            ("up", "cpu", 2.0 ** -22),
                            ("down", "cpu", -2.0 ** -22)):
        model = MSClipModel(spec, {k: v.clone() for k, v in params.items()},
                            trainable=True).to(dev)
        loss, _ = loss_fn(model.params(), (images * (1 + nudge)).to(dev),
                          tokens.to(dev))
        loss.backward()
        results[run] = (loss.item(), {k: p.grad.cpu() for k, p in
                                      model.named_parameters()
                                      if p.grad is not None})
    loss_cpu, grads_cpu = results["cpu"]
    if any(set(grads) != set(grads_cpu) for _, grads in results.values()) \
            or len(grads_cpu) < 300:
        raise AssertionError("gradients of " + ", ".join(
            f"{len(g)} tensors ({run})" for run, (_, g) in results.items()))
    # each tensor's worst error over its own largest gradient (the floor
    # only keeps an all-zero gradient from dividing by zero)
    rel = {run: {k: (grads[k] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-12)
                 for k, g in grads_cpu.items()}
           for run, (_, grads) in results.items() if run != "cpu"}
    readings = {k: (rel["card"][k], max(rel["up"][k], rel["down"][k]))
                for k in grads_cpu}
    limit = {k: max(grad_rel, noise_room * n) for k, (_, n) in readings.items()}
    ranked = sorted(readings, key=lambda k: readings[k][0] / limit[k],
                    reverse=True)
    worst = ranked[0]
    loss_gpu = results["card"][0]
    log("train_card_vs_cpu", dtype="float32", batch=batch, loss_card=loss_gpu,
        loss_cpu=loss_cpu, loss_err=abs(loss_gpu - loss_cpu),
        grad_tensors=len(grads_cpu),
        worst_card_rel_err=max(c for c, _ in readings.values()),
        worst_noise_rel_err=max(n for _, n in readings.values()),
        **{f"{name}_over_{t:g}": sum(r[i] > t for r in readings.values())
           for i, name in enumerate(("card", "noise")) for t in (1e-3, 1e-4)},
        worst_of_limit=readings[worst][0] / limit[worst],
        worst_tensors=json.dumps({k: readings[k] for k in ranked[:5]}),
        loss_tol=loss_tol, grad_rel_tol=grad_rel, noise_room=noise_room)
    if not (abs(loss_gpu - loss_cpu) <= loss_tol
            and readings[worst][0] <= limit[worst]):
        raise AssertionError(f"card and CPU train step differ: loss "
                             f"{loss_gpu} vs {loss_cpu}, gradient {worst} "
                             f"{readings[worst]} (card, noise) of its largest")


def b16_config(*opts):
    from msclip_torch.config import get_default_config, update_config

    cfg = get_default_config()
    update_config(cfg, B16_CONFIG, opts=[
        "MODEL.PRETRAINED_MODEL", "", "TPU.SEED", 0, *opts])
    return cfg


def reset_launches():
    A.fused_attention_qkv.launches = 0
    Q.ln_quant.launches = Q.gelu_quant.launches = 0
    for fn in (BF.fused_attention_halfblock, BF.fused_mlp_halfblock):
        fn.launches = 0
        fn.launches_by_width = dict.fromkeys(BF.WIDTHS, 0)
    HT.attention_halfblock_variant.launches = 0
    HT.core_out_halfblock.launches = 0
    for fn in K7.KERNELS:
        fn.launches = 0


def chain_launches():
    """Launches of each K7 kernel since :func:`reset_launches`."""
    return {fn.__name__: fn.launches for fn in K7.KERNELS}


def read_launches():
    return (A.fused_attention_qkv.launches, Q.ln_quant.launches,
            Q.gelu_quant.launches)


def fused_launches():
    """Launches of K1, K5 and K6 since :func:`reset_launches`."""
    return (A.fused_attention_qkv.launches,
            BF.fused_attention_halfblock.launches,
            BF.fused_mlp_halfblock.launches)


def run_int8_slice(batch=256):
    """Int8 zero-shot MS-CLIP-S B/16 at full width through the port's entry
    point (bf16, W8A8 trunk GEMMs), with the launches of K1, K3 and K4
    counted over the run; then the same configuration in bf16, and the
    int8 image features of one batch against the bf16 ones."""
    from msclip_torch.data.datasets import SyntheticImageDataset
    from msclip_torch.eval.zero_shot import load_eval_model, run_zero_shot
    from msclip_torch.models.layers import GEMM_KEYS
    from msclip_torch.models.msclip import build_spec

    zs = ["DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", 512,
          "TEST.BATCH_SIZE_PER_GPU", batch, "TEST.SUBSET_CLASSES", 100,
          "TPU.COMPUTE_DTYPE", "bfloat16"]
    runs = {}
    for int8 in (True, False):
        cfg = b16_config(*zs, "TPU.INT8_EVAL", int8)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        value, stats = run_zero_shot(cfg, device="cuda")
        torch.cuda.synchronize()
        runs[int8] = (read_launches(), stats)
        log("int8_slice" if int8 else "b16_bf16", model="b16-yfcc-msclips",
            int8=int8, top1=value, n_images=stats["n_images"],
            images_per_s=stats["images_per_sec"],
            classifier_s=stats["classifier_s"],
            image_batches=stats["n_image_batches"],
            text_chunks=stats["n_text_chunks"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=json.dumps(dict(zip(("attention_fwd", "ln_quant",
                                          "gelu_quant"), read_launches()))))
        if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
            raise AssertionError(f"B/16 zero-shot (int8={int8}) gave {value} "
                                 f"on {stats['n_images']} images")
    launches, stats = runs[True]
    nb, nc = stats["n_image_batches"], stats["n_text_chunks"]
    q3, q4 = int8_text_quantizers()
    expected = (11 * nb + 12 * nc, 22 * nb + 12 * q3 * nc,
                11 * nb + 12 * q4 * nc)
    if launches != expected or 0 in launches:
        raise AssertionError(f"int8 slice launched (K1, K3, K4) {launches} "
                             f"times, expected {expected} for {nb} image "
                             f"batches and {nc} text chunks")
    if runs[False][0][1:] != (0, 0):
        raise AssertionError(f"the bf16 run launched K3/K4: {runs[False][0]}")

    # the model of the run: every trunk GEMM in int8; the text tower
    # (L=77) launches K1, and K3/K4 where the card's gate admits 77
    cfg = b16_config(*zs, "TPU.INT8_EVAL", True)
    spec = build_spec(cfg)
    models = {int8: load_eval_model(b16_config(*zs, "TPU.INT8_EVAL", int8),
                                    spec, "cuda") for int8 in (True, False)}
    params = models[True].params()
    own_text = sum(not spec.text_layer_is_shared(i)
                   for i in range(spec.text_layers))
    int8_keys = [k for k, v in params.items() if v.dtype == torch.int8]
    fp_left = [k for k in params if k.endswith(GEMM_KEYS)]
    if fp_left or len(int8_keys) != 4 * (spec.effective_vision_layers - 1
                                         + own_text):
        raise AssertionError(f"int8 model holds fp GEMM weights {fp_left[:4]}"
                             f" and {len(int8_keys)} int8 tensors")
    from msclip_torch.data import ClipTokenizer, get_classnames, get_templates

    texts = [t.format(c) for c in get_classnames("imagenet")[:4]
             for t in get_templates("imagenet")[:64]]
    tokens = torch.from_numpy(ClipTokenizer()(texts)).cuda()
    ds = SyntheticImageDataset(n=batch, size=spec.image_resolution)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(batch)]))
    with torch.inference_mode():
        reset_launches()
        models[True].encode_text(tokens)
        torch.cuda.synchronize()
        text_launches = read_launches()
        feats = {k: m.encode_image(images.cuda()).float()
                 for k, m in models.items()}
    if text_launches != (12, 12 * q3, 12 * q4):
        raise AssertionError(f"the int8 text tower launched (K1, K3, K4) "
                             f"{text_launches}, expected "
                             f"{(12, 12 * q3, 12 * q4)}")
    cos = (feats[True] * feats[False]).sum(-1) / (
        feats[True].norm(dim=-1) * feats[False].norm(dim=-1))
    ips = runs[True][1]["images_per_sec"], runs[False][1]["images_per_sec"]
    log("int8_drift", batch=batch, min_cos=cos.min().item(),
        mean_cos=cos.mean().item(), int8_images_per_s=ips[0],
        bf16_images_per_s=ips[1], int8_over_bf16=ips[0] / ips[1],
        int8_int8_tensors=len(int8_keys),
        text_launches=json.dumps(text_launches))
    if not cos.min().item() > 0.99:
        raise AssertionError(f"int8 image features drift from bf16: least "
                             f"cosine {cos.min().item()}")
    return launches


def int8_card_against_cpu(atol=1e-3, noise_room=4.0):
    """Full-width fp32 B/16 int8 features of 4 images and 16 prompts (TF32
    off): the card with its kernels against the CPU with the plain
    versions, same weights. A quantized value next to a tie moves by one
    step when an input moves by one ulp, so two more CPU runs, with the
    images and the token embedding nudged by +-2^-22 of themselves, read
    how far fp32 rounding alone moves the features; each tower passes
    within ``atol``, or within ``noise_room`` times its own noise where
    that is larger. The CPU runs take the card's int8 gate
    (``MSCLIP_INT8_MIN_SEQ`` set to the ``sm_90`` row's for the phase), so
    that both sides quantize the text tower the same way."""
    from msclip_torch.models.layers import int8_min_seq

    gate, kept = int8_min_seq(torch.device("cuda")), os.environ.get(
        "MSCLIP_INT8_MIN_SEQ")
    os.environ["MSCLIP_INT8_MIN_SEQ"] = str(gate)
    try:
        int8_features_against_cpu(atol, noise_room)
    finally:
        if kept is None:
            os.environ.pop("MSCLIP_INT8_MIN_SEQ")
        else:
            os.environ["MSCLIP_INT8_MIN_SEQ"] = kept


def int8_features_against_cpu(atol, noise_room):
    """:func:`int8_card_against_cpu`'s runs and readings."""
    from msclip_torch.data import ClipTokenizer, get_classnames, get_templates
    from msclip_torch.data.datasets import SyntheticImageDataset
    from msclip_torch.eval.zero_shot import load_eval_model
    from msclip_torch.models.msclip import MSClipModel, build_spec

    cfg = b16_config("TPU.INT8_EVAL", True)
    spec = build_spec(cfg)  # fp32: also turns TF32 off
    ds = SyntheticImageDataset(n=4, size=spec.image_resolution)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(4)]))
    texts = [t.format(c) for c in get_classnames("imagenet")[:4]
             for t in get_templates("imagenet")[:4]]
    tokens = torch.from_numpy(ClipTokenizer()(texts))
    params = load_eval_model(cfg, spec, "cpu").params()
    feats, card_launches = {}, None
    for run, dev, nudge in (("card", "cuda", 0.0), ("cpu", "cpu", 0.0),
                            ("up", "cpu", 2.0 ** -22),
                            ("down", "cpu", -2.0 ** -22)):
        emb = "token_embedding.weight"
        p = {**params, emb: params[emb] * (1 + nudge)}
        model = MSClipModel(spec, {k: v.to(dev) for k, v in p.items()})
        reset_launches()
        with torch.inference_mode():
            feats[run] = (model.encode_image((images * (1 + nudge)).to(dev))
                          .cpu(), model.encode_text(tokens.to(dev)).cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            card_launches = read_launches()
    errs = [(a - b).abs().max().item()
            for a, b in zip(feats["card"], feats["cpu"])]
    noise = [max((a - b).abs().max().item() for a in (feats["up"][i],
                                                       feats["down"][i]))
             for i, b in enumerate(feats["cpu"])]
    limits = [max(atol, noise_room * n) for n in noise]
    log("int8_card_vs_cpu", dtype="float32", image_err=errs[0],
        text_err=errs[1], image_noise=noise[0], text_noise=noise[1],
        image_limit=limits[0], text_limit=limits[1], atol=atol,
        noise_room=noise_room, card_launches=json.dumps(card_launches))
    q3, q4 = int8_text_quantizers()
    if card_launches[1:] != (22 + 12 * q3, 11 + 12 * q4):
        raise AssertionError(f"the card's int8 run launched (K1, K3, K4) "
                             f"{card_launches}")
    if not all(math.isfinite(e) and e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"card and CPU int8 features differ: {errs} > "
                             f"{limits}")


def run_fused_slice(batch=256):
    """Zero-shot MS-CLIP-S B/32 with ``TPU.USE_FUSED_BLOCK`` through the
    port's entry point, with K1, K5 and K6 counted over the run (K5 in every
    trunk and text block; K1 never; K6 never, as in the JAX package's
    ``fused_block``); then the fused image features of one batch against
    the unfused ones, same weights."""
    from msclip_torch.data.datasets import SyntheticImageDataset
    from msclip_torch.eval.zero_shot import load_eval_model, run_zero_shot
    from msclip_torch.models.msclip import build_spec

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    value, stats = run_zero_shot(b32_zero_shot_config(fused=True),
                                 device="cuda")
    torch.cuda.synchronize()
    launches = fused_launches()
    nb, nc = stats["n_image_batches"], stats["n_text_chunks"]
    expected = (0, 11 * nb + 12 * nc, 0)
    log("fused_slice", model="b32-yfcc-msclips", dtype="bfloat16",
        top1=value, n_images=stats["n_images"],
        images_per_s=stats["images_per_sec"],
        classifier_s=stats["classifier_s"], image_batches=nb,
        text_chunks=nc,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_k1_k5_k6=json.dumps(launches))
    if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
        raise AssertionError(f"fused zero-shot run gave {value} on "
                             f"{stats['n_images']} images")
    if launches != expected or launches[1] == 0:
        raise AssertionError(f"fused slice launched (K1, K5, K6) {launches} "
                             f"times, expected {expected} for {nb} image "
                             f"batches and {nc} text chunks")

    ds = SyntheticImageDataset(n=batch, size=224)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(batch)]))
    feats = {}
    for fused in (True, False):
        cfg = b32_zero_shot_config(fused)
        model = load_eval_model(cfg, build_spec(cfg), "cuda")
        with torch.inference_mode():
            feats[fused] = model.encode_image(images.cuda()).float()
    cos = (feats[True] * feats[False]).sum(-1) / (
        feats[True].norm(dim=-1) * feats[False].norm(dim=-1))
    log("fused_drift", batch=batch, min_cos=cos.min().item(),
        mean_cos=cos.mean().item())
    if not cos.min().item() > 0.999:
        raise AssertionError(f"fused image features drift from the unfused "
                             f"ones: least cosine {cos.min().item()}")
    return launches[1]


TUNING_SHAPES = [(256, 50), (256, 197), (5, 77), (1, 1)]  # (B, L)
# E1's four kernels; v0 and v3 are v2's function and launch v2's kernel
TUNING_VARIANTS = ("v2", "v1", "v2c", "v2a")
# E1's faults, each the plain version of another variant read against the
# variant's own: v1's rounding (the qkv GEMM rounded before its bias) in v2
# and v2's in v1 must be caught in bf16; v2c's reciprocal softmax read
# against v2 is recorded, and expected within the limits
VARIANT_FAULTS = {"v2": {"v1_rounding": "v1", "v2c_softmax": "v2c"},
                  "v1": {"v2_rounding": "v2"}}
CAUGHT_VARIANT_FAULTS = ("v1_rounding", "v2_rounding")
CORE_OUT_FAULTS = ("weights_unrounded", "bias_after_cast")


def core_out_with_fault(x, qkv, p, fault):
    """The plain E2 with one fault planted: ``weights_unrounded`` keeps the
    softmax weights fp32 for PV, ``bias_after_cast`` rounds the
    out-projection to the compute dtype before adding its bias in it."""
    dt, (B, L, E) = x.dtype, x.shape
    q, k, v = qkv.float().view(B, L, 3, E // 64, 64).unbind(2)
    w = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k) * 0.125, dim=-1)
    if fault != "weights_unrounded":
        w = w.to(dt).float()
    ctx = torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, E).to(dt)
    y = ctx.float() @ p["attn.out_proj.weight"].to(dt).float().t()
    if fault == "bias_after_cast":
        return x + (y.to(dt) + p["attn.out_proj.bias"].to(dt))
    return x + (y + p["attn.out_proj.bias"].float()).to(dt)


def tuning_bound(kind, B, L, dtype):
    """``(ms, by)`` for E1 (``kind`` "variant", as K5 without a mask; "v2a"
    without the attention's products) or E2 (``kind`` "core_out": x, the
    ``3E``-wide qkv and the output once, the out-projection's weight and
    bias once; ``2 L E^2`` flops a sample and ``4 D`` per (query, key) pair
    and head)."""
    E, item = HT.WIDTH, torch.finfo(dtype).bits // 8
    if kind != "core_out":
        ms, by = halfblock_bound("attention_halfblock", B, L, dtype, None)
        if kind != "v2a":
            return ms, by
        flops = 8 * B * L * E * E
        nbytes = (2 * B * L * E + 4 * E * E + 2 * E) * item + 4 * E * 4
    else:
        flops = 2 * B * L * E * E + 4 * B * (E // 64) * L * L * 64
        nbytes = (5 * B * L * E + E * E) * item + E * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def tuning_check(name, got, want, x, dtype, faults, caught, label):
    """One kernel's reading against its plain version, and its faults'
    (``{fault: plain output with it}``); raises where the kernel reads
    above a limit, or where in bf16 a fault of ``caught`` that changes the
    output reads within both."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    reading, mean_reading, mean_err = half_reading(got, want, x, dtype)
    tol = "atol {} rtol {}".format(*HALF_TOL[dtype])
    if dtype in HALF_MEAN_TOL:
        tol += f", mean {HALF_MEAN_TOL[dtype]} mean |plain - x|"
    if not (reading <= 1.0 and mean_reading <= 1.0
            and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} kernel {label} {dtype}: max |err| {err}, "
                             f"{reading} and {mean_reading} of the limits {tol}")
    readings = {f: half_reading(bad, want, x, dtype) for f, bad in faults.items()}
    missed = [f for f, (worst, mean, ferr) in readings.items()
              if f in caught and dtype in HALF_MEAN_TOL and ferr > 0
              and worst <= 1.0 and mean <= 1.0]
    if missed:
        raise AssertionError(f"{name} {dtype} {label}: the check misses "
                             f"{missed}: {readings}")
    return {"max_abs_err": err, "mean_abs_err": mean_err, "tolerance": tol,
            "limit_reading": reading, "mean_reading": mean_reading,
            "planted_faults": readings}


def turns(kernel, other, n_inputs, other_name, per_call=None, iters=30):
    """:func:`in_turns` of a wrapper call (which may launch small casts
    beside its kernel) against ``other``, its keys renamed for ``other``:
    ``ms``, ``device_ms``, ``<other_name>_ms``,
    ``<other_name>_device_ms`` and ``vs_<other_name>`` (device over
    device)."""
    t = in_turns(kernel, other, n_inputs, one_record=False, per_call=per_call,
                 iters=iters)
    out = {"ms": t["ms"], "device_ms": t["device_ms"],
           f"{other_name}_ms": t["library_ms"],
           f"{other_name}_device_ms": t["library_device_ms"],
           f"vs_{other_name}": t["vs_library"], "turns_ms": t["turns_ms"]}
    if "device_error" in t:
        out["device_error"] = t["device_error"]
    return out


def check_tuning(traced):
    """E1 (each numeric variant at its default batch tile) and E2 against
    their plain versions in fp32 and bf16 at ``TUNING_SHAPES``, with the
    faults of ``VARIANT_FAULTS`` and :func:`core_out_with_fault` read
    against the same check. E2's qkv is the hybrid's own (LayerNorm and
    the library GEMM of ``hybrid_b``). Times each plain version, and E2's
    SDPA yardstick. With ``traced`` (``--measure``) the turns of
    :func:`traced_turns` give each kernel, K5, the unfused half with K1,
    the whole hybrid and, for E2, K1 with the out-projection; without it
    (None) each kernel is timed alone by CUDA events and the ratios are
    left out."""
    rows = {"attention_halfblock_variants": [], "core_out_halfblock": []}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        p = half_params(gen, dtype)
        for B, L in TUNING_SHAPES:
            label = f"B={B} L={L}"
            j = halfblock_jobs(B, L, False, dtype, p, gen, tuning=True)
            xs, qkvs, n_inputs = j["xs"], j["qkvs"], j["n"]
            x, qkv = xs[0], qkvs[0]
            tb = HT.default_tb(B, L, dtype, BF.sm_count(0))
            key = lambda kind, v=None: turn_key(  # noqa: E731
                kind, B, L, dtype, variant=v)
            base = {}
            if traced is not None:
                k5 = traced[key("k5")]
                base = {"k5_ms": k5["ms"], "k5_device_ms": k5["device_ms"]}
            plain = {v: HT.attention_halfblock_variant_plain(x, p, v)
                     for v in ("v2", "v1", "v2c", "v2a")}
            for variant in TUNING_VARIANTS:
                got = HT.attention_halfblock_variant(x, p, variant)
                row = tuning_check(
                    "attention_halfblock_variants", got, plain[variant], x,
                    dtype, {f: plain[v] for f, v in
                            VARIANT_FAULTS.get(variant, {}).items()},
                    CAUGHT_VARIANT_FAULTS, f"{variant} {label}")
                row = {"variant": variant, "B": B, "L": L, "tb": tb,
                       "dtype": str(dtype).replace("torch.", ""), **row,
                       "plain_ms": cuda_ms(
                           lambda i: HT.attention_halfblock_variant_plain(
                               xs[i], p, variant), n_inputs, iters=10),
                       "library_ms": None, **base,
                       **(traced[key("e1", variant)] if traced is not None
                          else {"ms": cuda_ms(j["e1"](variant),
                                              n_inputs)})}
                row["bound_ms"], row["bound_by"] = tuning_bound(
                    "v2a" if variant == "v2a" else "variant", B, L, dtype)
                log("kernel", name="attention_halfblock_variants", **row,
                    bound_us=row["bound_ms"] * 1e3)
                rows["attention_halfblock_variants"].append(row)

            got = HT.core_out_halfblock(x, qkv, p)
            row = tuning_check(
                "core_out_halfblock", got, HT.core_out_plain(x, qkv, p), x,
                dtype, {f: core_out_with_fault(x, qkv, p, f)
                        for f in CORE_OUT_FAULTS}, CORE_OUT_FAULTS, label)
            # E2 in turns with K1 + the out-projection, the whole hybrid in
            # turns with the unfused half
            if traced is None:
                timed_e2 = {"ms": cuda_ms(j["e2"], n_inputs)}
            else:
                timed_e2 = {**traced[key("e2")],
                            **{"hybrid_" + k: v
                               for k, v in traced[key("hybrid")].items()
                               if k != "turns_ms"}}
            row = {"B": B, "L": L, "tb": tb,
                   "dtype": str(dtype).replace("torch.", ""), **row,
                   "plain_ms": cuda_ms(lambda i: HT.core_out_plain(
                       xs[i], qkvs[i], p), n_inputs, iters=10),
                   "library_ms": None,
                   "sdpa_matmul_ms": cuda_ms(j["sdpa_matmul"], n_inputs),
                   **base, **timed_e2}
            row["bound_ms"], row["bound_by"] = tuning_bound(
                "core_out", B, L, dtype)
            log("kernel", name="core_out_halfblock", **row,
                bound_us=row["bound_ms"] * 1e3)
            rows["core_out_halfblock"].append(row)
            del xs, qkvs, j
    return rows


def run_tuning_sweep():
    """The tool's full-width sweep (B=256, L=50, E=768, bf16, K=32) through
    ``msclip_torch.tools.halfblock_tuning.main``, every launch count set to
    0 before it; each row must have launched its kernel 11 x (K + warm-up)
    times. Returns the launches of E1 and E2 over the sweep."""
    from msclip_torch.tools import halfblock_tuning as tool

    reset_launches()
    rows = tool.main([])
    torch.cuda.synchronize()
    launches = (HT.attention_halfblock_variant.launches,
                HT.core_out_halfblock.launches)
    want = tool.LAYERS * (tool.K + tool.WARMUP)
    log("tuning_sweep", rows=json.dumps(rows),
        launches_e1_e2=json.dumps(launches))
    wrong = [r for r in rows if r["launches"] != want]
    if wrong or 0 in launches:
        raise AssertionError(f"tuning sweep rows launched other than {want} "
                             f"times: {wrong}; E1, E2 {launches}")
    return launches, rows


TRANSFER_N = 256  # images of each transfer set's evaluated split: one batch
CALTECH_CLASSES = ("accordion", "airplanes", "anchor", "ant", "barrel",
                   "bass", "beaver", "binocular")
DATASET_DIR = os.path.join(REPO, "experiments", "dataset")


def write_transfer_fixtures(root, seed=0):
    """The transfer sets of phase 13 in their public layouts, written from
    ``seed``: a VOC2007 test split, a HatefulMemes ``dev_seen.jsonl`` set, a
    Caltech-101 tree (30 train and 32 test images a class), a CIFAR-10
    pickle train/test pair (8 x n and n) and a Karpathy retrieval split
    (n images x 5 captions). Images are random blocks of 96-200 px."""
    import pickle

    from PIL import Image

    from msclip_torch.data.datasets import Voc2007Classification

    n = TRANSFER_N
    rng = np.random.default_rng(seed)

    def image(path, i):
        h, w = 96 + 8 * (i % 13), 96 + 8 * (i % 11)
        arr = np.kron(rng.random((h // 8, w // 8, 3)), np.ones((8, 8, 1)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray((arr * 255).astype(np.uint8)).save(path)

    voc = os.path.join(root, "voc", "test", "VOCdevkit 2", "VOC2007")
    os.makedirs(os.path.join(voc, "ImageSets", "Main"))
    ids = [f"{i:06d}" for i in range(1, n + 1)]
    labels = rng.random((n, 20)) < 0.15
    labels[np.arange(n), rng.integers(0, 20, n)] = True
    for ci, cls in enumerate(Voc2007Classification.CATEGORIES):
        with open(os.path.join(voc, "ImageSets", "Main",
                               f"{cls}_test.txt"), "w") as f:
            f.write("".join(f"{d} {1 if labels[i, ci] else -1}\n"
                            for i, d in enumerate(ids)))
    for i, d in enumerate(ids):
        image(os.path.join(voc, "JPEGImages", d + ".jpg"), i)

    hm = os.path.join(root, "hatefulmemes")
    recs = []
    for i in range(n):
        image(os.path.join(hm, "img", f"{i:05d}.png"), i)
        recs.append({"id": i, "img": f"img/{i:05d}.png", "label": i % 2,
                     "text": f"meme {i}"})
    with open(os.path.join(hm, "dev_seen.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in recs))

    caltech = os.path.join(root, "caltech", "101_ObjectCategories")
    per_class = 30 + n // len(CALTECH_CLASSES)
    for ci, cls in enumerate(CALTECH_CLASSES):
        for i in range(per_class):
            image(os.path.join(caltech, cls, f"image_{i:04d}.jpg"), i + ci)

    cifar = os.path.join(root, "cifar", "cifar-10-batches-py")
    os.makedirs(cifar)
    for name, m in [(f"data_batch_{b}", 8 * n // 5 + (b <= 8 * n % 5))
                    for b in range(1, 6)] + [("test_batch", n)]:
        with open(os.path.join(cifar, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (m, 3072), np.uint8),
                         b"labels": [int(v) for v in
                                     rng.integers(0, 10, m)]}, f)

    karpathy = os.path.join(root, "karpathy")
    things = ("dog", "bicycle", "harbour", "kitchen", "market", "mountain")
    records = []
    for i in range(n):
        image(os.path.join(karpathy, "images", f"{i:05d}.jpg"), i)
        records.append({"filename": f"{i:05d}.jpg", "split": "test",
                        "sentences": [{"raw": f"a {things[(i + j) % 6]} "
                                              f"seen in photo {i}, take {j}"}
                                      for j in range(5)]})
    with open(os.path.join(karpathy, "dataset_flickr30k.json"), "w") as f:
        json.dump({"images": records}, f)
    return {"voc": os.path.join(root, "voc") + "/", "hatefulmemes": hm,
            "caltech": os.path.dirname(caltech),
            "cifar": os.path.dirname(cifar),
            "karpathy": (os.path.join(karpathy, "images"),
                         os.path.join(karpathy, "dataset_flickr30k.json"))}


def transfer_config(ds_yaml, root, *opts, dtype="bfloat16"):
    """Full-width B/32 on one transfer set (``ds_yaml`` None: no dataset
    config): random weights from seed 0, batch 256, ``dtype``."""
    from msclip_torch.config import get_default_config, update_config

    cfg = get_default_config()
    if ds_yaml:
        update_config(cfg, os.path.join(DATASET_DIR, ds_yaml))
    update_config(cfg, B32_CONFIG, opts=[
        "DATASET.ROOT", root, "TEST.BATCH_SIZE_PER_GPU", TRANSFER_N,
        "TPU.COMPUTE_DTYPE", dtype, "TPU.SEED", 0,
        "MODEL.PRETRAINED_MODEL", "", *opts])
    return cfg


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def k1_launches_held(run, launches, image_batches, text_chunks):
    expected = 11 * image_batches + 12 * text_chunks
    if launches != expected or launches == 0:
        raise AssertionError(
            f"{run}: K1 launched {launches} times, expected 11 x "
            f"{image_batches} image batches + 12 x {text_chunks} text "
            f"chunks = {expected}")
    return launches


def run_transfer(tmp, device="cuda"):
    """Phase 13: the transfer-eval surface at full B/32 width in bf16 on
    fixtures written to ``tmp``: zero-shot on VOC2007 (11-point mAP),
    HatefulMemes (ROC-AUC) and Caltech-101 (mean-per-class) through
    ``run_zero_shot``, the torch linear probe on CIFAR-10 through
    ``run_linear_probe``, retrieval on a Karpathy split through
    ``run_retrieval`` (BN folded, as its CLI), each with K1's launches
    counted and held to 11 x image batches + 12 x text chunks and each
    metric recomputed from the saved logits; then fp32 VOC logits of 16
    images, the card against the CPU, and the dispatcher CLI
    ``msclip_torch.tools.eval_zeroshot --device cuda`` on the VOC set.
    Returns K1's launches over the five runs. ``device="cpu"`` rehearses
    the phase with the plain versions (no launches to count)."""
    from torch.utils.data import Subset

    from msclip_torch.data.retrieval_datasets import load_karpathy_split
    from msclip_torch.data.transforms import pil_eval_transform
    from msclip_torch.eval.linear_probe import run_linear_probe
    from msclip_torch.eval.retrieval import run_retrieval
    from msclip_torch.eval.zero_shot import (
        LOGIT_METRICS,
        load_eval_model,
        make_dataset,
        run_zero_shot,
    )
    from msclip_torch.models.msclip import build_spec

    t0 = time.time()
    roots = write_transfer_fixtures(tmp)
    log("transfer_fixtures", seconds=round(time.time() - t0, 1),
        image_files=4 * TRANSFER_N + 30 * len(CALTECH_CLASSES),
        cifar_images=9 * TRANSFER_N)
    total = 0
    for ds_yaml, key, metric in (
            ("voc2007.yaml", "voc", "11point_mAP"),
            ("hatefulmemes.yaml", "hatefulmemes", "roc_auc"),
            ("caltech-101.yaml", "caltech", "mean-per-class")):
        pred = os.path.join(tmp, f"{key}.npz")
        cfg = transfer_config(ds_yaml, roots[key], "TEST.SAVE_PRED", pred)
        reset_launches()
        start = time.time()
        value, stats = run_zero_shot(cfg, device=device)
        sync(device)
        seconds = time.time() - start
        launches = k1_launches_held(
            key, A.fused_attention_qkv.launches, stats["n_image_batches"],
            stats["n_text_chunks"])
        saved = np.load(pred)
        again = LOGIT_METRICS[metric](saved["label"], saved["logits"])
        log("transfer_zero_shot", dataset=cfg.DATASET.DATASET, metric=metric,
            value=value, recomputed=again, n_images=stats["n_images"],
            images_per_s=stats["images_per_sec"],
            classifier_s=stats["classifier_s"],
            image_batches=stats["n_image_batches"],
            text_chunks=stats["n_text_chunks"], k1_launches=launches,
            seconds=round(seconds, 1))
        if stats["metric"] != metric or stats["n_images"] != TRANSFER_N:
            raise AssertionError(f"{key}: {stats}")
        if not (math.isfinite(value) and 0.0 <= value <= 100.0
                and again == value):
            raise AssertionError(f"{key}: {metric} {value}, recomputed from "
                                 f"the saved logits {again}")
        total += launches

    cfg = transfer_config("cifar-10.yaml", roots["cifar"])
    train, test = (make_dataset(cfg, image_set=s) for s in ("train", "test"))
    reset_launches()
    start = time.time()
    acc = run_linear_probe(cfg, train, test, probe="torch", device=device)
    sync(device)
    seconds = time.time() - start
    batches = sum(-(-len(d) // TRANSFER_N) for d in (train, test))
    launches = k1_launches_held("linear probe",
                                A.fused_attention_qkv.launches, batches, 0)
    log("transfer_linear_probe", dataset="cifar-10", accuracy=acc,
        n_train=len(train), n_test=len(test), seconds=seconds,
        images_per_s=(len(train) + len(test)) / seconds,
        image_batches=batches, k1_launches=launches)
    if not (len(train) == 8 * TRANSFER_N and 0.0 <= acc <= 100.0):
        raise AssertionError(f"linear probe: {acc} on {len(train)} images")
    total += launches

    cfg = transfer_config(None, "")
    images, ann = roots["karpathy"]
    ds, captions, cap2img = load_karpathy_split(
        images, ann, transform=functools.partial(
            pil_eval_transform, size=cfg.TEST.IMAGE_SIZE[0],
            mean=tuple(cfg.INPUT.MEAN), std=tuple(cfg.INPUT.STD)))
    model = load_eval_model(cfg, build_spec(cfg), device, int8=False)
    reset_launches()
    start = time.time()
    out = run_retrieval(model, ds, captions, cap2img, batch_size=TRANSFER_N,
                        workers=cfg.WORKERS)
    sync(device)
    seconds = time.time() - start
    launches = k1_launches_held(
        "retrieval", A.fused_attention_qkv.launches,
        -(-len(ds) // TRANSFER_N), -(-len(captions) // TRANSFER_N))
    log("transfer_retrieval", n_images=len(ds), n_captions=len(captions),
        seconds=seconds, images_per_s=len(ds) / seconds,
        i2t=json.dumps(out["i2t"]), t2i=json.dumps(out["t2i"]),
        k1_launches=launches)
    if not all(0.0 <= v <= 100.0 for d in out.values() for v in d.values()):
        raise AssertionError(f"retrieval recalls {out}")
    total += launches
    del model

    # fp32 VOC logits of 16 images: the card (K1) against the CPU (plain)
    logits, seconds = {}, {}
    for dev in (device, "cpu"):
        start = time.time()
        pred = os.path.join(tmp, f"voc16_{dev}.npz")
        cfg = transfer_config("voc2007.yaml", roots["voc"], "TEST.SAVE_PRED",
                              pred, dtype="float32")
        run_zero_shot(cfg, dataset=Subset(make_dataset(cfg), range(16)),
                      device=dev)
        logits[dev] = np.load(pred)["logits"]
        seconds[dev] = round(time.time() - start, 1)
    err = float(np.abs(logits[device] - logits["cpu"]).max())
    log("transfer_card_vs_cpu", dataset="voc2007classification",
        dtype="float32", images=16, logits_err=err, atol=0.1,
        seconds=json.dumps(seconds))
    if not (logits[device].shape == (16, 20) and err <= 0.1):
        raise AssertionError(f"fp32 VOC logits, card against CPU: {err}")

    start = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "msclip_torch.tools.eval_zeroshot",
         "--model", B32_CONFIG, "--ds", "voc2007", "--device", device,
         "DATASET.ROOT", roots["voc"], "TEST.BATCH_SIZE_PER_GPU",
         str(TRANSFER_N), "TPU.COMPUTE_DTYPE", "bfloat16",
         "OUTPUT_DIR", os.path.join(tmp, "out")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    result = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    log("transfer_cli", returncode=r.returncode,
        seconds=round(time.time() - start, 1),
        result=json.dumps(result[0] if result else None))
    if r.returncode != 0 or not result or "11point_mAP=" not in result[0]:
        raise AssertionError(f"eval_zeroshot --device cuda: rc "
                             f"{r.returncode}\n{r.stderr[-3000:]}")
    return total



# ---------------------------------------------------------------------------
# phases 14-16: training on real data, GradCache and REMAT, resume
# ---------------------------------------------------------------------------

SHARDS, PER_SHARD, TSV_ROWS = 4, 256, 256
SHARD_RUNS = 3
B32_BLOCKS = 23  # 11 trunk + 12 text blocks: K1 (and K2) a block a pass


def write_pair_fixtures(root, seed=0):
    """Phase 14's pairs, written from ``seed`` by
    ``tests/torch_pair_fixtures.py``: ``SHARDS`` WebDataset tar shards of
    ``PER_SHARD`` JPEG + caption members and a ``TSV_ROWS``-row TSV over
    JPEG files, images of 96-320 px a side in colour blocks of 16 px."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_pair_fixtures", os.path.join(REPO, "tests",
                                            "torch_pair_fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    size = {"min_px": 96, "max_px": 320, "block": 16}
    shards = fixtures.write_shards(os.path.join(root, "shards"), SHARDS,
                                   PER_SHARD, seed, **size)
    tsv = fixtures.write_tsv(os.path.join(root, "tsv"), TSV_ROWS, seed + 1,
                             **size)
    return shards, tsv


def attention_launches():
    return A.fused_attention_qkv.launches, A.fused_attention_qkv_bwd.launches


def launches_held(run, got, k1, k2):
    if tuple(got) != (k1, k2):
        raise AssertionError(f"{run}: K1, K2 launched {tuple(got)} times, "
                             f"expected ({k1}, {k2})")
    return got


def run_train_data(tmp, resident, batch=256):
    """Phase 14: full-width B/32 bf16 training at batch 256 through
    ``tools.train.train`` on real formats: one epoch of ``SHARDS`` tar
    shards with the ``chunk`` sampler (4 steps), ``SHARD_RUNS`` times to
    show the host's spread within a call, then one step on the TSV.
    Each run's K1 and K2 held to 23 launches a step; end-to-end samples/s,
    peak memory, and the host's share of a step, 1 - (phase 6's resident
    step ms) / (this run's ms a step): over the whole window (the first
    step holds the loader's fill) and at steady state (the steps after the
    first, each timed from the previous step's end on the device's clock)."""
    from msclip_torch.tools.train import train

    t0 = time.time()
    shards, tsv = write_pair_fixtures(tmp)
    log("train_data_fixtures", seconds=round(time.time() - t0, 1),
        shards=len(shards), pairs_per_shard=PER_SHARD, tsv_rows=TSV_ROWS)
    total = [0, 0]
    shard_opts = ["DATASET.TRAIN_SHARD_LIST", json.dumps(shards),
                  "DATASET.SAMPLER", "chunk"]
    for run, (name, opts) in enumerate(
            [("shards", shard_opts)] * SHARD_RUNS
            + [("tsv", ["DATASET.TRAIN_TSV_LIST", json.dumps([tsv])])]):
        cfg = train_config("TRAIN.BATCH_SIZE_PER_GPU", batch,
                           "TPU.COMPUTE_DTYPE", "bfloat16",
                           "TRAIN.END_EPOCH", 1, "TPU.SEED", 0, *opts)
        reset_launches()
        A.fused_attention_qkv_bwd.launches = 0
        _, stats = train(cfg, device="cuda")
        torch.cuda.synchronize()
        steps = stats["steps"]
        got = launches_held(name, attention_launches(), B32_BLOCKS * steps,
                            B32_BLOCKS * steps)
        step_ms = stats["seconds"] / max(steps, 1) * 1e3
        steady = stats["step_ms"][1:]
        steady_ms = sum(steady) / len(steady) if steady else None
        log("train_data", source=name, run=run, batch=batch, steps=steps,
            losses=json.dumps(stats["losses"]),
            samples_per_s=stats["samples_per_s"], step_ms=step_ms,
            resident_step_ms=resident["step_ms"],
            host_share=1.0 - resident["step_ms"] / step_ms,
            each_step_ms=json.dumps(stats["step_ms"]),
            fill_step_ms=stats["step_ms"][0], steady_step_ms=steady_ms,
            steady_samples_per_s=steady_ms and batch / steady_ms * 1e3,
            steady_host_share=steady_ms and 1.0 - resident["step_ms"]
            / steady_ms,
            peak_mem_gb=stats["peak_mem_gb"], k1_launches=got[0],
            k2_launches=got[1])
        want = len(shards) * PER_SHARD // batch if name == "shards" \
            else TSV_ROWS // batch
        if steps != want or not all(map(math.isfinite, stats["losses"])):
            raise AssertionError(f"{name}: {steps} steps (expected {want}), "
                                 f"losses {stats['losses']}")
        total = [total[0] + got[0], total[1] + got[1]]
    return total


# ---------------------------------------------------------------------------
# the native JPEG pipeline (after phase 14, on its shards)
# ---------------------------------------------------------------------------

# six batches of 256: the loader decodes a batch a thread (6 threads), so
# fewer batches would leave cores idle
NATIVE_IMAGES, NATIVE_CLASSES = 1536, 8
NATIVE_LOGIT_IMAGES = 64  # the fp32 logit check's, in one batch
NATIVE_PHOTO = (1024, 768)  # w, h: bench.py's photo-sized q90 JPEGs
NATIVE_CROP_CHECK = 32
# tests/test_native_pipeline.py's tolerance of the native pipeline against
# PIL, in normalized units: the mean |difference| and its 99.9th percentile
NATIVE_CROP_MEAN, NATIVE_CROP_Q999 = 0.02, 0.15
# the native route's fp32 logits against the PIL route's, one batch: the
# largest difference over the largest |logit| of the PIL route. A model of
# random weights sees little of its image (features of two photos agree
# to a cosine of 0.9996), below bf16's resolution: in bf16 the native and
# PIL logits differ by 2-3 ulps and a planted fault by 2-5, so the bound
# is held in fp32 (TF32 off), where the native route read 7.4e-6 and
# channels reversed 2.3e-2 (full-width B/32 on the CPU, 32 photos; on
# the card, 256 photos, 7.2e-6 and 3.3e-2)
NATIVE_LOGIT_REL = 2.0 ** -10


def write_photo_folder(root, n=NATIVE_IMAGES, classes=NATIVE_CLASSES,
                       seed=0):
    """An ImageFolder of ``n`` photo-sized JPEGs (``NATIVE_PHOTO`` at q90,
    4:2:0, bilinear from a random 97 x 129 grid, as ``bench.py``'s) in
    ``classes`` folders ``c0 ..``; returns ``root``."""
    from PIL import Image

    seeds = np.random.SeedSequence(seed).spawn(n)

    def one(i):
        rng = np.random.default_rng(seeds[i])
        small = rng.integers(0, 256, (97, 129, 3), np.uint8)
        img = Image.fromarray(small, "RGB").resize(NATIVE_PHOTO,
                                                   Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        path = os.path.join(root, f"c{i % classes}", f"{i:05d}.jpg")
        with open(path, "wb") as f:
            f.write(buf.getvalue())

    for c in range(classes):
        os.makedirs(os.path.join(root, f"c{c}"), exist_ok=True)
    with cf.ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        list(pool.map(one, range(n)))
    return root


class FirstSamples:
    """The first ``n`` samples of ``ds`` with its attributes (uint8 or not,
    statistics, classes); ``reverse``: a planted fault, their channels
    reversed (BGR)."""

    def __init__(self, ds, n, reverse=False):
        self.ds, self.n, self.reverse = ds, n, reverse
        self.emits_uint8, self.mean, self.std = ds.emits_uint8, ds.mean, \
            ds.std
        self.classes, self.samples = ds.classes, ds.samples[:n]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img, label = self.ds[i]
        return (np.ascontiguousarray(img[..., ::-1]) if self.reverse
                else img), label


def crop_reading(got_u8, want_u8):
    """``(mean, 99.9th percentile)`` of the normalized difference of two
    uint8 crops, the units of ``NATIVE_CROP_MEAN``/``Q999``."""
    from msclip_torch.data.transforms import normalize_uint8

    d = (normalize_uint8(torch.from_numpy(np.array(got_u8)))
         - normalize_uint8(torch.from_numpy(np.array(want_u8)))).abs().numpy()
    return float(d.mean()), float(np.quantile(d, 0.999))


@contextlib.contextmanager
def env(**values):
    """``os.environ`` with ``values`` set (None: unset), restored after."""
    kept = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in kept.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


NATIVE_ROUTES = {"native": {"MSCLIP_NATIVE_DECODE": "1",
                            "MSCLIP_DCT_SCALE": None},
                 "native_dct": {"MSCLIP_NATIVE_DECODE": "1",
                                "MSCLIP_DCT_SCALE": "1"},
                 "pil": {"MSCLIP_NATIVE_DECODE": None,
                         "MSCLIP_DCT_SCALE": None}}


def run_native(tmp, batch=256):
    """The native JPEG pipeline (``msclip_torch.native``), run after phase
    14 on its shards: (i) build the library on this host and name its
    link route (the run fails if it does not build: the phase exists to
    run the native route); (ii) its uint8 crops of ``NATIVE_CROP_CHECK``
    photo-sized JPEGs against ``pil_eval_uint8`` within
    ``tests/test_native_pipeline.py``'s tolerance, every one served
    natively (the dataset's ``served`` counter), and channels reversed
    caught; (iii) full-width B/32 zero-shot in bf16 through
    ``run_zero_shot`` on an ImageFolder of ``NATIVE_IMAGES`` photo-sized
    JPEGs (six batches) by three routes in turn: native, PIL, native with
    the DCT scale; images/s of each, K1 held to 11 x image batches + 12 x
    text chunks; then the fp32 logits of ``NATIVE_LOGIT_IMAGES`` of them,
    native against PIL within ``NATIVE_LOGIT_REL`` of the largest, where
    the native crops with their channels reversed (a planted fault) must
    fail (bf16 cannot resolve what a model of random weights sees of its
    image, so its readings are logged only); (iv)
    one epoch of phase 14's shards (4 steps at batch 256) through
    ``tools.train.train`` with the native decode and with PIL: the fill
    and steady step times, every member decoded natively in the native
    run, K1 and K2 held to 23 launches a step. Returns ``(K1, K2)``
    launches of (iii) and (iv)."""
    import glob

    from msclip_torch import native as N
    from msclip_torch.data.datasets import ImageFolderDataset, _load_image
    from msclip_torch.data.transforms import pil_eval_uint8
    from msclip_torch.eval.zero_shot import make_dataset, run_zero_shot
    from msclip_torch.tools.train import train

    # (i) build
    start = time.time()
    ok = N.native_available()
    log("native_build", ok=ok, route=json.dumps(N.build_route()),
        pillow_libjpeg=json.dumps(N.pillow_libjpeg()),
        error=json.dumps(repr(N.build_error())[:300]),
        seconds=round(time.time() - start, 2))
    if not ok:
        raise AssertionError(f"the native pipeline did not build: "
                             f"{N.build_error()}")

    # (ii) crops against PIL
    start = time.time()
    root = write_photo_folder(os.path.join(tmp, "photos", "val"),
                              NATIVE_IMAGES)
    log("native_fixtures", images=NATIVE_IMAGES, size=json.dumps(NATIVE_PHOTO),
        seconds=round(time.time() - start, 1))
    with env(MSCLIP_NATIVE_U8=None, MSCLIP_DCT_SCALE=None):
        ds = ImageFolderDataset(root, native=True)
        readings, faults, same = [], [], []
        for i in range(NATIVE_CROP_CHECK):
            got = ds[i][0]
            want = pil_eval_uint8(_load_image(ds.samples[i][0]), 224)
            readings.append(crop_reading(got, want))
            faults.append(crop_reading(np.ascontiguousarray(got[..., ::-1]),
                                       want))
            same.append(float((got == want).mean()))
    worst = tuple(max(r[k] for r in readings) for k in (0, 1))
    caught = all(f[0] > NATIVE_CROP_MEAN or f[1] > NATIVE_CROP_Q999
                 for f in faults)
    log("native_crops", images=NATIVE_CROP_CHECK, served=json.dumps(ds.served),
        worst_mean=worst[0], worst_q999=worst[1], mean_tol=NATIVE_CROP_MEAN,
        q999_tol=NATIVE_CROP_Q999, equal_values=float(np.mean(same)),
        fault_least_mean=min(f[0] for f in faults), fault_caught=caught)
    if ds.served != {"native": NATIVE_CROP_CHECK, "pil": 0}:
        raise AssertionError(f"native crops: served {ds.served}")
    if not (worst[0] < NATIVE_CROP_MEAN and worst[1] < NATIVE_CROP_Q999
            and caught):
        raise AssertionError(f"native crops against PIL: {worst}, channels "
                             f"reversed caught: {caught}")

    # (iii) zero-shot by three routes in bf16, then the logits in fp32
    def zs_config(pred, dtype):
        cfg = transfer_config(
            None, os.path.dirname(root), "DATASET.DATASET", "imagenet",
            "DATASET.TEST_SET", "val", "TEST.BATCH_SIZE_PER_GPU", batch,
            "TEST.SUBSET_CLASSES", NATIVE_CLASSES, "TEST.SAVE_PRED", pred,
            dtype=dtype)
        cfg.TEST.METRIC = "mean-per-class"  # a metric that saves logits
        return cfg

    def zero_shot(route, dtype, n=None, reverse=False):
        pred = os.path.join(tmp, f"native_{route}_{dtype}.npz")
        with env(MSCLIP_NATIVE_U8=None, **NATIVE_ROUTES[route]):
            cfg = zs_config(pred, dtype)
            dataset = make_dataset(cfg)
            run = dataset if n is None else FirstSamples(dataset, n, reverse)
            reset_launches()
            _, stats = run_zero_shot(cfg, dataset=run, device="cuda")
            torch.cuda.synchronize()
        name = f"native zero-shot ({route}{', fault' if reverse else ''}, " \
            f"{dtype})"
        launches = k1_launches_held(name, A.fused_attention_qkv.launches,
                                    stats["n_image_batches"],
                                    stats["n_text_chunks"])
        logits = np.load(pred)["logits"]
        log("native_zero_shot", route=route, dtype=dtype, fault=reverse,
            n_images=stats["n_images"], images_per_s=stats["images_per_sec"],
            elapsed_s=stats["elapsed_s"], classifier_s=stats["classifier_s"],
            image_batches=stats["n_image_batches"],
            text_chunks=stats["n_text_chunks"], k1_launches=launches,
            served=json.dumps(getattr(dataset, "served", None)))
        if stats["n_images"] != (n or NATIVE_IMAGES) \
                or not np.isfinite(logits).all():
            raise AssertionError(f"{name}: {stats}")
        if route.startswith("native") and dataset.served != {
                "native": n or NATIVE_IMAGES, "pil": 0}:
            raise AssertionError(f"{name}: served {dataset.served}")
        return logits, launches

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    k1 = 0
    bf16 = {}
    for route in ("native", "pil", "native_dct"):
        bf16[route], launches = zero_shot(route, "bfloat16")
        k1 += launches
    n = NATIVE_LOGIT_IMAGES
    fp32 = {"native": zero_shot("native", "float32", n)[0],
            "pil": zero_shot("pil", "float32", n)[0],
            "fault": zero_shot("native", "float32", n, reverse=True)[0]}
    readings = {"native": rel(fp32["native"], fp32["pil"]),
                "fault": rel(fp32["fault"], fp32["pil"])}
    log("native_logits", dtype="float32", images=n,
        native_rel=readings["native"], fault_rel=readings["fault"],
        bound=NATIVE_LOGIT_REL,
        bf16_native_rel=rel(bf16["native"], bf16["pil"]),
        bf16_native_dct_rel=rel(bf16["native_dct"], bf16["pil"]),
        bf16_top1_agree=float((bf16["native"].argmax(-1)
                               == bf16["pil"].argmax(-1)).mean()))
    if not (readings["native"] <= NATIVE_LOGIT_REL < readings["fault"]):
        raise AssertionError(f"native fp32 logits against PIL's: "
                             f"{readings}, bound {NATIVE_LOGIT_REL}")

    # (iv) train decode on phase 14's shards
    shards = sorted(glob.glob(os.path.join(tmp, "shards", "*.tar")))
    real_decode = N.decode_train
    decoded, lock = [0], threading.Lock()

    def counted(*args, **kw):
        out = real_decode(*args, **kw)
        with lock:
            decoded[0] += out is not None
        return out

    total = [k1, 0]
    for route in ("native", "pil"):
        cfg = train_config("TRAIN.BATCH_SIZE_PER_GPU", batch,
                           "TPU.COMPUTE_DTYPE", "bfloat16",
                           "TRAIN.END_EPOCH", 1, "TPU.SEED", 0,
                           "DATASET.TRAIN_SHARD_LIST", json.dumps(shards),
                           "DATASET.SAMPLER", "chunk")
        decoded[0] = 0
        reset_launches()
        A.fused_attention_qkv_bwd.launches = 0
        N.decode_train = counted
        try:
            with env(**NATIVE_ROUTES[route]):
                _, stats = train(cfg, device="cuda")
                torch.cuda.synchronize()
        finally:
            N.decode_train = real_decode
        steps = stats["steps"]
        got = launches_held(f"native train ({route})", attention_launches(),
                            B32_BLOCKS * steps, B32_BLOCKS * steps)
        steady = stats["step_ms"][1:]
        log("native_train", route=route, batch=batch, steps=steps,
            losses=json.dumps(stats["losses"]),
            samples_per_s=stats["samples_per_s"],
            fill_step_ms=stats["step_ms"][0],
            steady_step_ms=sum(steady) / len(steady) if steady else None,
            each_step_ms=json.dumps(stats["step_ms"]),
            native_decodes=decoded[0], k1_launches=got[0],
            k2_launches=got[1])
        want = len(shards) * PER_SHARD // batch
        if steps != want or not all(map(math.isfinite, stats["losses"])):
            raise AssertionError(f"native train ({route}): {steps} steps "
                                 f"(expected {want}), {stats['losses']}")
        if decoded[0] != (steps * batch if route == "native" else 0):
            raise AssertionError(f"native train ({route}): {decoded[0]} "
                                 f"native decodes for {steps * batch} "
                                 "samples")
        total = [total[0] + got[0], total[1] + got[1]]
    return total


def gradcache_card_check(batch=32, accum=4, grad_rel=1e-4, noise_room=4.0):
    """Phase 15 (i): full-width fp32 B/32 (TF32 off), frozen BN, no drop
    path, ``batch`` synthetic pairs: every gradient of ``ACCUM_STEPS
    accum`` (GradCache) against the one-shot step's, both on the card,
    each read relative to its own largest value beside the fp32 noise
    floor (the one-shot step with the images nudged by +-2^-22, as phase
    7). Returns the K1, K2 launches of the GradCache run (the nudged and
    one-shot runs are its yardsticks)."""
    from msclip_torch.data.pairs import make_train_dataset
    from msclip_torch.models.msclip import (MSClipModel, build_spec,
                                            init_params)
    from msclip_torch.train.trainer import (gradcache_backward,
                                            make_encode_fn, make_loss_fn)

    cfg = train_config("TPU.COMPUTE_DTYPE", "float32",
                       "DATASET.NUM_SAMPLES", batch)
    spec = build_spec(cfg)
    ds = make_train_dataset(cfg)
    images, tokens = (torch.from_numpy(np.stack(x)).cuda()
                      for x in zip(*(ds[i] for i in range(batch))))
    params = init_params(spec, torch.Generator().manual_seed(0))
    loss_fn = make_loss_fn(spec, freeze_bn=True)
    encode = make_encode_fn(spec, freeze_bn=True)
    grads, losses, launches = {}, {}, {}
    for run, nudge in (("accum", 0.0), ("one_shot", 0.0),
                       ("up", 2.0 ** -22), ("down", -2.0 ** -22)):
        model = MSClipModel(spec, {k: v.clone() for k, v in params.items()},
                            trainable=True).cuda()
        reset_launches()
        A.fused_attention_qkv_bwd.launches = 0
        x = images * (1 + nudge)
        if run == "accum":
            loss, _ = gradcache_backward(encode, model.params(), x, tokens,
                                         accum)
        else:
            loss, _ = loss_fn(model.params(), x, tokens)
            loss.backward()
        torch.cuda.synchronize()
        launches[run] = attention_launches()
        losses[run] = loss.item()
        grads[run] = {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None}
        del model
    launches_held("gradcache fp32", launches["accum"],
                  2 * B32_BLOCKS * accum, B32_BLOCKS * accum)
    launches_held("one-shot fp32", launches["one_shot"], B32_BLOCKS,
                  B32_BLOCKS)
    ref = grads["one_shot"]
    if any(set(g) != set(ref) for g in grads.values()) or len(ref) < 300:
        raise AssertionError("gradients of " + ", ".join(
            f"{len(g)} tensors ({run})" for run, g in grads.items()))
    rel = {run: {k: (g[k] - ref[k]).abs().max().item()
                 / max(ref[k].abs().max().item(), 1e-12) for k in ref}
           for run, g in grads.items() if run != "one_shot"}
    readings = {k: (rel["accum"][k], max(rel["up"][k], rel["down"][k]))
                for k in ref}
    limit = {k: max(grad_rel, noise_room * n) for k, (_, n) in readings.items()}
    worst = max(readings, key=lambda k: readings[k][0] / limit[k])
    log("gradcache_card_vs_one_shot", dtype="float32", batch=batch,
        accum_steps=accum, loss_one_shot=losses["one_shot"],
        loss_accum=losses["accum"],
        loss_err=abs(losses["accum"] - losses["one_shot"]),
        grad_tensors=len(ref),
        worst_accum_rel_err=max(c for c, _ in readings.values()),
        worst_noise_rel_err=max(n for _, n in readings.values()),
        worst_of_limit=readings[worst][0] / limit[worst], worst_tensor=worst,
        grad_rel_tol=grad_rel, noise_room=noise_room,
        k1_launches=launches["accum"][0], k2_launches=launches["accum"][1])
    if not (abs(losses["accum"] - losses["one_shot"]) <= 1e-5
            and readings[worst][0] <= limit[worst]):
        raise AssertionError(f"GradCache and the one-shot step differ: loss "
                             f"{losses['accum']} vs {losses['one_shot']}, "
                             f"{worst} {readings[worst]} (accum, noise)")
    return list(launches["accum"])


def timed_train_steps(cfg, spec, state, batch, steps=3):
    """``steps`` steps of the config's step on one resident batch: peak
    memory over all, ms a step over all but the first (CUDA events), and
    the K1, K2 launches of all."""
    from msclip_torch.train.trainer import make_train_step_from_config

    step_fn = make_train_step_from_config(cfg, spec)
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randn(batch, 224, 224, 3, device="cuda", generator=gen)
    tokens = torch.randint(1, 49406, (batch, 77), device="cuda",
                           generator=gen, dtype=torch.int32)
    tokens[:, 0], tokens[:, 20] = 49406, 49407
    tokens[:, 21:] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    A.fused_attention_qkv_bwd.launches = 0
    losses = [step_fn(state, images, tokens)["loss"]]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps - 1):
        losses.append(step_fn(state, images, tokens)["loss"])
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / (steps - 1)
    return {"step_ms": step_ms, "samples_per_s": batch / step_ms * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": [float(x) for x in losses],
            "launches": attention_launches()}


def run_gradcache(resident):
    """Phase 15: (i) :func:`gradcache_card_check`; (ii) bf16 at batch 1024
    with ``ACCUM_STEPS 4``, 3 steps: peak memory (under the card's 80 GB),
    ms a step and samples/s; (iii) ``TPU.REMAT`` at batch 256 in bf16: the
    same beside phase 6's resident step. Launches held to 46a K1 and 23a
    K2 a step under ``ACCUM_STEPS a``, 46 and 23 under REMAT."""
    import dataclasses

    from msclip_torch.models.msclip import build_spec, init_params
    from msclip_torch.train.trainer import init_train_state

    total = gradcache_card_check()
    cfg = train_config("TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", 0)
    spec = build_spec(cfg)
    state = init_train_state(cfg, spec, init_params(
        spec, torch.Generator().manual_seed(0)), 4, "cuda")
    for name, batch, opts, k1, k2 in (
            ("accum", 1024, ("TPU.ACCUM_STEPS", 4), 2 * B32_BLOCKS * 4,
             B32_BLOCKS * 4),
            ("remat", 256, ("TPU.REMAT", True), 2 * B32_BLOCKS,
             B32_BLOCKS)):
        run_cfg = train_config("TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED",
                               0, *opts)
        run_spec = dataclasses.replace(spec, remat=name == "remat")
        out = timed_train_steps(run_cfg, run_spec, state, batch)
        launches_held(name, out["launches"], 3 * k1, 3 * k2)
        log("train_" + name, batch=batch, dtype="bfloat16",
            opts=json.dumps(list(opts)), step_ms=out["step_ms"],
            samples_per_s=out["samples_per_s"],
            peak_mem_gb=out["peak_mem_gb"],
            one_shot_step_ms=resident["step_ms"],
            one_shot_samples_per_s=256 / resident["step_ms"] * 1e3,
            one_shot_peak_mem_gb=resident["peak_mem_gb"],
            losses=json.dumps(out["losses"]), k1_launches=out["launches"][0],
            k2_launches=out["launches"][1])
        if not (out["peak_mem_gb"] < 80 and all(
                map(math.isfinite, out["losses"]))):
            raise AssertionError(f"{name}: {out}")
        total = [total[0] + out["launches"][0],
                 total[1] + out["launches"][1]]
    del state
    torch.cuda.empty_cache()
    return total


RESUME_OPTS = ("TRAIN.BATCH_SIZE_PER_GPU", 32, "DATASET.NUM_SAMPLES", 128,
               "TRAIN.END_EPOCH", 2, "TRAIN.SAVE_EVERY_STEPS", 3,
               "TRAIN.EMA_DECAY", 0.999, "SWA.ENABLED", True,
               "SWA.BEGIN_EPOCH", 1, "TPU.COMPUTE_DTYPE", "bfloat16",
               "TPU.SEED", 0, "PRINT_FREQ", 1)
# 2 epochs of 4 steps, killed mid-epoch (2 epochs of 8 and step 6 before
# the zoo phase took the time; 2 of 5 until PR 17, a depth cut for the
# time limit)
RESUME_STEPS, RESUME_AT = 8, 3


def run_resume(tmp, transfer_roots):
    """Phase 16: the train CLI at full width in bf16 (batch 32, synthetic,
    4 steps an epoch, 2 epochs, ``SAVE_EVERY_STEPS 3``, EMA 0.999, SWA
    from epoch 1) as a subprocess, SIGKILLed once its step-3 checkpoint
    exists and rerun: it must resume at step 3, fast-forward 3 batches,
    finish at step 8, and its losses from step 4 on lie within 4x of the
    largest gap between two uninterrupted runs (in this process,
    ``tools.train.train``; K1, K2 held). Then the EMA and SWA shadows
    through ``checkpoint_load`` into ``run_zero_shot`` (K1 held as in
    phase 4), one exported by ``export_torch_checkpoint --ckpt`` (its
    ``main``, in this process) and read back to the same features bit for
    bit, and ``tools.finetune --device cuda`` on phase 13's CIFAR-10
    fixture with K1 counted."""
    from msclip_torch.eval.zero_shot import load_eval_model, run_zero_shot
    from msclip_torch.models.msclip import build_spec
    from msclip_torch.tools import export_torch_checkpoint, finetune
    from msclip_torch.tools.train import train
    from msclip_torch.train.checkpoint import EXTRA_FILE, CheckpointManager

    cfg = train_config(*RESUME_OPTS)
    total = [0, 0]
    full = []
    t0 = time.time()
    for _ in range(2):
        reset_launches()
        A.fused_attention_qkv_bwd.launches = 0
        _, stats = train(cfg, device="cuda")
        torch.cuda.synchronize()
        # the SWA BN refresh runs the image tower over one epoch
        got = launches_held("uninterrupted", attention_launches(),
                            B32_BLOCKS * RESUME_STEPS
                            + 11 * RESUME_STEPS // 2,
                            B32_BLOCKS * RESUME_STEPS)
        total = [total[0] + got[0], total[1] + got[1]]
        full.append(stats["losses"])
    log("resume_uninterrupted", runs=2, seconds=round(time.time() - t0, 1))
    out_dir = os.path.join(tmp, "resume")
    cmd = [sys.executable, "-u", "-m", "msclip_torch.tools.train", "--cfg",
           B32_CONFIG, "--device", "cuda", "OUTPUT_DIR", out_dir,
           "DATASET.DATASET", "synthetic", *map(str, RESUME_OPTS)]
    t0 = time.time()
    first = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    ck = os.path.join(out_dir, "synthetic", "b32-yfcc-msclips", "checkpoints")
    marker = os.path.join(ck, str(RESUME_AT), EXTRA_FILE)
    try:
        while not os.path.exists(marker):
            if first.poll() is not None or time.time() - t0 > 600:
                raise AssertionError(f"the first run ended ({first.poll()}) "
                                     f"before its step-{RESUME_AT} save")
            time.sleep(0.05)
    finally:
        first.kill()
        first.wait()
    killed_at = CheckpointManager(ck).latest_step()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    seconds = time.time() - t0
    result = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    if r.returncode != 0 or not result:
        raise AssertionError(f"resumed run: rc {r.returncode}\n"
                             f"{r.stderr[-3000:]}")
    fields = dict(kv.split("=", 1) for kv in result[0].split()[1:])
    losses = json.loads(fields["losses"])
    resumed = re.search(r"auto-resumed from step (\d+)", r.stderr)
    skipped = re.search(r"skipping (\d+) already-seen batches", r.stderr)
    mgr = CheckpointManager(ck)
    gap = max(abs(a - b) for a, b in zip(full[0][RESUME_AT:],
                                         full[1][RESUME_AT:]))
    err = max(abs(a - b) for a, b in zip(losses, full[0][RESUME_AT:]))
    log("resume", killed_at=killed_at, resumed_at=resumed and int(
        resumed.group(1)), skipped=skipped and int(skipped.group(1)),
        first_step=int(fields["first_step"]), steps=len(losses),
        final_step=mgr.latest_step(),
        final_epoch=mgr.restore()["extra"]["epoch"],
        loss_err=err, uninterrupted_gap=gap, limit=4 * gap,
        losses=json.dumps(losses), uninterrupted=json.dumps(full),
        seconds=round(seconds, 1))
    if not (killed_at == RESUME_AT and resumed
            and int(resumed.group(1)) == RESUME_AT and skipped
            and int(skipped.group(1)) == RESUME_AT
            and int(fields["first_step"]) == RESUME_AT
            and len(losses) == RESUME_STEPS - RESUME_AT
            and mgr.latest_step() == RESUME_STEPS and err <= 4 * gap):
        raise AssertionError("resume: see the [resume] line")

    feats = {}
    for shadow in ("ema", "swa"):
        zcfg = b32_zero_shot_config()
        zcfg.MODEL.PRETRAINED_MODEL = os.path.join(ck, shadow)
        zcfg.DATASET.NUM_SAMPLES = 256
        reset_launches()
        value, stats = run_zero_shot(zcfg, device="cuda")
        torch.cuda.synchronize()
        launches = k1_launches_held(
            shadow, A.fused_attention_qkv.launches,
            stats["n_image_batches"], stats["n_text_chunks"])
        total[0] += launches
        log("resume_zero_shot", shadow=shadow, top1=value,
            n_images=stats["n_images"], images_per_s=stats["images_per_sec"],
            k1_launches=launches)
        if stats["n_images"] != 256 or not 0.0 <= value <= 100.0:
            raise AssertionError(f"{shadow} zero-shot: {value}, {stats}")
    exported = os.path.join(tmp, "ema.pth")
    t0 = time.time()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        export_torch_checkpoint.main([
            "--model", B32_CONFIG, "--ckpt", os.path.join(ck, "ema"),
            "--out", exported, "--device", "cuda"])
    export_s = time.time() - t0
    # a check of the export, not a main-path run: its launches go uncounted
    images = torch.randn(64, 224, 224, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(4))
    zcfg = b32_zero_shot_config()
    spec = build_spec(zcfg)
    for path in (os.path.join(ck, "ema"), exported):
        zcfg.MODEL.PRETRAINED_MODEL = path
        with torch.no_grad():
            feats[path] = load_eval_model(zcfg, spec, "cuda").encode_image(
                images)
    torch.cuda.synchronize()
    same = torch.equal(*feats.values())
    log("resume_export", tensors=printed.getvalue().strip(),
        same_features=same, seconds=round(export_s, 1))
    if not same:
        raise AssertionError("features of the exported EMA shadow differ")

    reset_launches()
    t0 = time.time()
    top1 = finetune.main([
        "--ds", os.path.join(DATASET_DIR, "cifar-10.yaml"), "--model",
        B32_CONFIG, "--device", "cuda", "DATASET.ROOT",
        transfer_roots["cifar"], "FINETUNE.BATCH_SIZE", "64",
        "TRAIN.END_EPOCH", "2", "TEST.BATCH_SIZE_PER_GPU", str(TRANSFER_N),
        "TPU.COMPUTE_DTYPE", "bfloat16", "MODEL.PRETRAINED_MODEL", exported,
        "OUTPUT_DIR", os.path.join(tmp, "finetune")])
    torch.cuda.synchronize()
    # 2 epochs of 256 / 64 batches, then one eval batch: 11 K1 a batch
    launches = k1_launches_held("finetune", A.fused_attention_qkv.launches,
                                2 * TRANSFER_N // 64 + 1, 0)
    total[0] += launches
    log("resume_finetune", dataset="cifar-10", top1=top1,
        seconds=round(time.time() - t0, 1), k1_launches=launches)
    if not 0.0 <= top1 <= 100.0:
        raise AssertionError(f"finetune top-1 {top1}")
    return total

# ---------------------------------------------------------------------------
# phase 18: the multi-process train path (torchrun, NCCL, world 1)
# ---------------------------------------------------------------------------

DIST_STEPS, DIST_BATCH = 3, 256
DIST_OPTS = ("TRAIN.BATCH_SIZE_PER_GPU", DIST_BATCH, "DATASET.NUM_SAMPLES",
             DIST_STEPS * DIST_BATCH, "TRAIN.END_EPOCH", 1,
             "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", 0,
             "CUDNN.DETERMINISTIC", True, "PRINT_FREQ", 1)
# mode -> (options, exact): exact modes run every collective as a copy at
# world 1, so they must equal the no-group run bit for bit; the sharded
# losses reorder the loss's sums
DIST_MODES = {
    "dp": ((), True),
    "chunked": (("TPU.SHARDED_LOSS", True, "TPU.LOSS_CHUNK", 64), False),
    "ring": (("TPU.SHARDED_LOSS", True, "TPU.RING_LOSS", True), False),
    "zero1": (("TPU.ZERO1", True), True),
    "fsdp": (("TPU.FSDP", True), True),
}
DIST_FIRST_RTOL = 1e-5  # step 1 of the sharded losses against the no-group run
DIST_LATER_RTOL = 5e-5  # their steps 2-3 (1.6e-5 measured)
# The sharded losses' parameters and gradients. AdamW's first steps move
# each element by about +-lr whatever the gradient's size, so a gradient
# element that rounding flips moves its parameter the other way: the
# parameters are held to that envelope, DIST_PARAM_ENVELOPE x the sum of
# the steps' learning rates (a tensor that starts at 0 reads ~1.7 x its
# own largest value). The gradients are held through AdamW's first
# moment (a weighted sum of the steps' gradients) over the parts (each
# tensor, the q/k/v thirds of a packed attention projection apart) whose
# reference gradient is not nought but rounding: largest magnitude at
# least DIST_NOUGHT x the median part's. The k bias is left out so
# (softmax ignores a shift shared by every key: ~1.7e-3 x the median,
# the next part 0.14 x).
# Measured at B/32 bf16 on the H100: the parameters 1.89-1.93 x the sum;
# the first moment 0.097-0.101 (L2) and 0.23-0.27 (part) for the chunked
# and ring losses, and 0.32-0.47 and 0.57-1.10 with a wrong gradient
# planted into the loss's backward (the text features' x2, both x1.3,
# the image features' x0.5), which the losses (within 1.1e-5) and the
# parameters (<= 2.0 x) do not show.
DIST_PARAM_ENVELOPE = 2.2
DIST_NOUGHT = 1e-2
DIST_MOMENT_L2 = 0.2  # relative L2 over the kept parts together
DIST_MOMENT_PART = 0.5  # each kept part's largest gap / its largest value


# the one torchrun process of phase 18 (see :func:`dist_worker`)
DIST_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.dist_worker(*sys.argv[2:])
"""


def dist_train_argv(out_dir, opts):
    return ["--cfg", B32_CONFIG, "--device", "cuda", "DATASET.DATASET",
            "synthetic", "OUTPUT_DIR", out_dir, *map(str, DIST_OPTS + opts)]


def dist_zero_shot_argv(ds, pred, out_dir):
    return ["--ds", ds, "--model", B32_CONFIG, "--device", "cuda",
            "DATASET.NUM_SAMPLES", "512", "TEST.BATCH_SIZE_PER_GPU", "256",
            "TEST.SUBSET_CLASSES", "100", "TPU.COMPUTE_DTYPE", "bfloat16",
            "TPU.SEED", "0", "MODEL.PRETRAINED_MODEL", "", "TEST.SAVE_PRED",
            pred, "OUTPUT_DIR", out_dir]


def dist_worker(tmp, ds, pred, go):
    """Phase 18's process under ``torchrun``: the train CLI's ``main`` in
    each of :data:`DIST_MODES`, then the zero-shot CLI's, with the argv a
    user gives each on the command line, in one process group. Each
    ``main`` leaves the group as its last step; here the next one would
    re-join on the launcher's store, so the group is left once, at the
    end (one process start-up, not six). The process is started ahead
    (:func:`start_dist_worker`): it imports, joins its group and then
    waits for the file ``go`` before its first run. Prints ``MODE
    <name>`` before and ``SECONDS <s>`` after each run, around its
    ``RESULT`` line."""
    from msclip_torch.tools import train as train_cli
    from msclip_torch.tools import zero_shot as zero_shot_cli
    from msclip_torch.utils.comm import init_distributed, shutdown

    init_distributed("cuda")
    deadline = time.time() + DIST_WAIT_S
    while not os.path.exists(go):
        if time.time() > deadline:
            raise SystemExit(f"phase 18 worker: no {go} in {DIST_WAIT_S} s")
        time.sleep(0.1)
    train_cli.shutdown = zero_shot_cli.shutdown = lambda: None
    runs = [(mode, train_cli.main,
             dist_train_argv(os.path.join(tmp, "dist", mode), opts))
            for mode, (opts, _) in DIST_MODES.items()]
    runs.append(("zero_shot", zero_shot_cli.main,
                 dist_zero_shot_argv(ds, pred, os.path.join(tmp, "dist_zs"))))
    for mode, main_fn, argv in runs:
        print(f"MODE {mode}", flush=True)
        t0 = time.time()
        main_fn(argv)
        print(f"SECONDS {time.time() - t0:.1f}", flush=True)
    shutdown()


DIST_WAIT_S = 1800  # the worker's longest wait for phase 18


def start_dist_worker(tmp):
    """Start :func:`dist_worker` under ``torchrun --nproc_per_node 1`` on
    this card now, its output to files in ``tmp``: it imports, joins its
    process group and waits for :func:`let_dist_worker_go`. Returns its
    handle."""
    from msclip_torch.tools.dryrun import free_port

    w = {name: os.path.join(tmp, name) for name in (
        "dist_worker.py", "synthetic.yaml", "dist_zero_shot.npz", "dist_go",
        "dist_worker.out", "dist_worker.err")}
    with open(w["dist_worker.py"], "w") as f:
        f.write(DIST_WORKER)
    # TEST.SAVE_PRED keeps logits for the logit metrics only (as the JAX
    # package's file): under top-1 it holds every image's predicted class
    with open(w["synthetic.yaml"], "w") as f:
        f.write("DATASET:\n  DATASET: synthetic\n")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--master_addr", "localhost", "--master_port",
           str(free_port()), w["dist_worker.py"], REPO, tmp,
           w["synthetic.yaml"], w["dist_zero_shot.npz"], w["dist_go"]]
    with open(w["dist_worker.out"], "w") as out, \
            open(w["dist_worker.err"], "w") as err:
        w["proc"] = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=err,
                                     text=True)
    w["started"] = time.time()
    return w


def let_dist_worker_go(w):
    """Let the worker of :func:`start_dist_worker` start its runs."""
    if w["proc"].poll() is not None:
        with open(w["dist_worker.err"]) as f:
            raise AssertionError(f"phase 18 worker ended before its go "
                                 f"({w['proc'].returncode}):\n"
                                 f"{f.read()[-4000:]}")
    w["before_go"] = time.time() - w["started"]
    w["go_at"] = time.time()
    open(w["dist_go"], "w").close()


def finish_dist_worker(w, timeout=900):
    """Wait for the worker of :func:`start_dist_worker`, once let go:
    ``({mode: (result fields, seconds)}, seconds from the go to its end,
    seconds it had run before the go)``."""
    try:
        rc = w["proc"].wait(timeout)
    except subprocess.TimeoutExpired:
        stop([w["proc"]])
        raise
    seconds = time.time() - w["go_at"]
    with open(w["dist_worker.out"]) as f:
        stdout = f.read()
    runs, mode = {}, None
    for ln in stdout.splitlines():
        if ln.startswith("MODE "):
            mode = ln.split()[1]
        elif ln.startswith("RESULT") and mode:
            runs[mode] = dict(kv.split("=", 1) for kv in ln.split()[1:]
                              if "=" in kv)
        elif ln.startswith("SECONDS ") and mode in runs:
            runs[mode] = (runs[mode], float(ln.split()[1]))
    if rc != 0 or len(runs) != len(DIST_MODES) + 1:
        with open(w["dist_worker.err"]) as f:
            stderr = f.read()
        raise AssertionError(f"phase 18 worker: rc {rc}\n"
                             f"{stdout[-2000:]}\n{stderr[-4000:]}")
    return runs, seconds, w["before_go"]


def largest_rel_diff(got, want):
    """Over the tensors of ``want``: the largest ``max |got - want| / max
    |want|``."""
    worst = 0.0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs().max().item()
        worst = max(worst, d / max(w.float().abs().max().item(), 1e-30))
    return worst


def qkv_parts(tree):
    """``tree`` with each packed attention input projection cut into its
    q, k and v thirds (``name[q]`` ...), the other tensors whole."""
    out = {}
    for k, v in tree.items():
        if ".in_proj_" in k:
            out.update({f"{k}[{p}]": c for p, c in zip("qkv", v.chunk(3))})
        else:
            out[k] = v
    return out


def moment_gaps(got, want, grad):
    """AdamW's first moment ``got`` against the reference's ``want`` over
    the parts whose reference gradient ``grad`` is not nought but rounding
    (:data:`DIST_NOUGHT`): the relative L2 over them together
    (``exp_avg_l2``), the largest part's max |got - want| / max |want|
    (``exp_avg_part``), the parts left out (``nought_parts``), and the
    largest left out's and the least kept part's largest gradient over
    the median part's (``nought_top``, ``kept_least``)."""
    got, want, grad = qkv_parts(got), qkv_parts(want), qkv_parts(grad)
    median = float(np.median([grad[k].float().abs().max().item()
                              for k in want]))
    top = {k: grad[k].float().abs().max().item() / median for k in want}
    kept = [k for k in want if top[k] >= DIST_NOUGHT]
    gap = sum(((got[k].float() - want[k].float()) ** 2).sum().item()
              for k in kept)
    size = sum((want[k].float() ** 2).sum().item() for k in kept)
    part = max((got[k].float() - want[k].float()).abs().max().item()
               / max(want[k].float().abs().max().item(), 1e-30)
               for k in kept)
    return {"exp_avg_l2": math.sqrt(gap / size), "exp_avg_part": part,
            "nought_parts": len(want) - len(kept),
            "nought_top": max([v for k, v in top.items() if k not in kept],
                              default=None),
            "kept_least": min(top[k] for k in kept)}


# wrong gradients planted into the sharded loss's backward, which the
# sharded losses' bounds must reject: name -> the factors of the image
# and the text features' gradients
DIST_PLANTED = {"text_x2": (1.0, 2.0), "both_x1.3": (1.3, 1.3),
                "image_x0.5": (0.5, 1.0)}


def scaled_grad(x, factor):
    """``x`` in the forward, bit for bit; ``factor`` x its gradient."""
    return x.detach() + (x - x.detach()) * factor


def in_process_run(cfg, planted=None):
    """``tools.train.train`` of ``cfg`` on the card without a process
    group; with ``planted=(image, text)`` the embedding loss's feature
    gradients are scaled by those factors. Returns ``(losses, params,
    the last step's gradients, AdamW's first moment, the sum of the
    steps' learning rates, K1/K2 launches)``."""
    from msclip_torch.tools.train import train
    from msclip_torch.train import trainer

    make_loss = trainer.make_embedding_loss
    if planted:
        def make_planted(*args, **kw):
            loss = make_loss(*args, **kw)
            return lambda fi, ft, scale: loss(scaled_grad(fi, planted[0]),
                                              scaled_grad(ft, planted[1]),
                                              scale)
        trainer.make_embedding_loss = make_planted
    try:
        state, stats = train(cfg, device="cuda")
    finally:
        trainer.make_embedding_loss = make_loss
    torch.cuda.synchronize()
    sched = state.scheduler
    lr_sum = max(sum(g["initial_lr"] * fn(t) for t in range(DIST_STEPS))
                 for g, fn in zip(sched.optimizer.param_groups,
                                  sched.lr_lambdas))
    out = (stats["losses"],
           {k: v.detach().cpu() for k, v in state.model.params().items()},
           {k: g.detach().cpu() for k, g in state.shards.grads().items()},
           {k: st["exp_avg"].detach().cpu() for k, st in
            state.shards.full_optimizer_state(state.optimizer).items()},
           lr_sum, stats["launches"])
    del state
    torch.cuda.empty_cache()
    return out


def sharded_readings(losses, params, moment, ref):
    """A sharded loss's run against the reference ``ref``
    (:func:`in_process_run`): the readings and whether they hold the
    ``DIST_*`` bounds."""
    want, ref_params, ref_grad, ref_m, lr_sum, _ = ref
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    params_vs_lr = max((params[k].float() - w.float()).abs().max().item()
                       for k, w in ref_params.items()
                       if k in ref_grad) / lr_sum
    got_parts = qkv_parts({k: params[k] for k in ref_grad})
    rel = {k: (got_parts[k].float() - w.float()).abs().max().item()
           / max(w.float().abs().max().item(), 1e-30) for k, w in
           qkv_parts({k: ref_params[k] for k in ref_grad}).items()}
    worst = max(rel, key=rel.get)  # the part of the largest params_rel
    moments = moment_gaps(moment, ref_m, ref_grad)
    ok = (loss_rel[0] <= DIST_FIRST_RTOL
          and max(loss_rel[1:]) <= DIST_LATER_RTOL
          and params_vs_lr <= DIST_PARAM_ENVELOPE
          and moments["exp_avg_l2"] <= DIST_MOMENT_L2
          and moments["exp_avg_part"] <= DIST_MOMENT_PART)
    return {"loss_rel": json.dumps(loss_rel), "params_vs_lr": params_vs_lr,
            "params_worst": worst, **moments}, ok


def run_distributed(tmp, slice_pred, worker):
    """Phase 18: the train CLI under ``torchrun --nproc_per_node 1`` (NCCL,
    world 1) at full B/32 width in bf16, batch 256, 3 steps, in five modes
    (the gathered full-matrix loss, ``TPU.SHARDED_LOSS`` at 64-column
    chunks, ``+ TPU.RING_LOSS``, ``TPU.ZERO1``, ``TPU.FSDP``), each against
    the same run without a process group in this process (``tools.train.
    train``, run twice for the card's run-to-run gap; cuDNN deterministic
    in all): the losses of the 3 steps, the parameters after them and
    AdamW's moments (the epoch-end checkpoint), bit for bit in the modes
    whose collectives are copies; for the sharded losses, which reorder
    the loss's sums, the ``DIST_*`` bounds (:func:`sharded_readings`),
    which must reject each of :data:`DIST_PLANTED` (chunked runs in this
    process). K1 and K2 held to 23 launches a step in every counted run.
    Then the zero-shot CLI under ``torchrun`` against phase 4's top-1 and
    every image's predicted class. Every CLI run shares one ``torchrun``
    process (:func:`dist_worker`), ``worker``: started ahead by
    :func:`start_dist_worker` with ``tmp``, it ran beside phase 16 and
    its results are ``worker["runs"]`` (:func:`finish_dist_worker`).
    Returns the K1 and K2 launches of the runs, the planted ones left
    out."""
    from msclip_torch.train.checkpoint import CheckpointManager

    torch.cuda.empty_cache()  # the torchrun process shares the card
    cfg = train_config(*DIST_OPTS)
    per_run = B32_BLOCKS * DIST_STEPS
    total = [0, 0]
    refs = []
    t0 = time.time()
    for _ in range(2):
        refs.append(in_process_run(cfg))
        launches_held("no-group", refs[-1][-1], per_run, per_run)
        total = [total[0] + per_run, total[1] + per_run]
    ref = refs[0]
    want, ref_params, _, ref_m = ref[:4]
    again, ref2 = refs[1][:2]
    noise = {"loss": max(abs(a - b) for a, b in zip(want, again)),
             "params_rel": largest_rel_diff(ref2, ref_params)}
    log("dist_reference", steps=DIST_STEPS, batch=DIST_BATCH,
        losses=json.dumps(want), rerun_losses=json.dumps(again),
        rerun_loss_gap=noise["loss"], rerun_params_rel=noise["params_rel"],
        seconds=round(time.time() - t0, 1))
    failed = []
    chunked = train_config(*DIST_OPTS, *DIST_MODES["chunked"][0])
    for name, factors in DIST_PLANTED.items():
        t0 = time.time()
        losses, params, _, moment = in_process_run(chunked, factors)[:4]
        readings, ok = sharded_readings(losses, params, moment, ref)
        log("dist_planted", fault=name, **readings, rejected=not ok,
            seconds=round(time.time() - t0, 1))
        if ok:
            failed.append(f"planted {name}")

    runs, process_s, waited_s = worker["runs"]
    pred = worker["dist_zero_shot.npz"]
    for mode, (opts, exact) in DIST_MODES.items():
        out_dir = os.path.join(tmp, "dist", mode)
        fields, seconds = runs[mode]
        losses = json.loads(fields["losses"])
        k1, k2 = map(int, fields["attention_launches"].split(","))
        launches_held(f"torchrun {mode}", (k1, k2), per_run, per_run)
        total = [total[0] + k1, total[1] + k2]
        ck = CheckpointManager(os.path.join(
            out_dir, "synthetic",
            os.path.splitext(os.path.basename(B32_CONFIG))[0], "checkpoints"))
        saved = ck.restore(DIST_STEPS)
        params = saved["params"]
        moment = {k: st["exp_avg"] for k, st in saved["optimizer"].items()}
        params_rel = largest_rel_diff(params, ref_params)
        bitwise = (losses == want and params_rel == 0.0
                   and largest_rel_diff(moment, ref_m) == 0.0)
        readings, sharded_ok = sharded_readings(losses, params, moment, ref)
        log("dist", mode=mode, world=fields["world"],
            global_batch=fields["global_batch"], opts=json.dumps(opts),
            losses=json.dumps(losses), params_rel=params_rel, **readings,
            bitwise=bitwise, samples_per_s=float(fields["samples_per_s"]),
            peak_mem_gb=float(fields["peak_mem_gb"]),
            param_bytes=int(fields["param_bytes"]),
            optimizer_bytes=int(fields["optimizer_bytes"]),
            k1_launches=k1, k2_launches=k2, seconds=seconds)
        shutil.rmtree(out_dir)
        if len(losses) != DIST_STEPS or not all(map(math.isfinite, losses)):
            failed.append(mode)
        elif exact and not bitwise and (noise["loss"] == 0.0
                                        and noise["params_rel"] == 0.0):
            failed.append(mode)  # the card repeats itself: a gap is a fault
        elif exact and not bitwise and not (
                max(abs(a - b) for a, b in zip(losses, want))
                <= 4 * noise["loss"]
                and params_rel <= 4 * noise["params_rel"]):
            failed.append(mode)
        elif not exact and not sharded_ok:
            failed.append(mode)

    fields, seconds = runs["zero_shot"]
    got, want_zs = np.load(pred), np.load(slice_pred)
    top1 = float(fields["accuracy"])
    want_top1 = 100.0 * float((want_zs["pred"] == want_zs["label"]).mean())
    same = (np.array_equal(got["pred"], want_zs["pred"])
            and np.array_equal(got["label"], want_zs["label"]))
    log("dist_zero_shot", world=1, top1=top1, phase4_top1=want_top1,
        images=len(got["pred"]), same_predictions=same, seconds=seconds)
    log("dist_process", seconds=round(process_s, 1),
        after_go=round(process_s - sum(s for _, s in runs.values()), 1),
        started_before=round(waited_s, 1))
    if not (same and len(got["pred"]) == 512
            and abs(top1 - round(want_top1, 3)) <= 1e-3):
        failed.append("zero_shot")
    if failed:
        raise AssertionError(f"phase 18 failed in {failed}: see the [dist] "
                             "lines")
    return total


# ---------------------------------------------------------------------------
# phase 17: serving
# ---------------------------------------------------------------------------

SERVE_JPEGS = 256
# depth cut for the time limit (PR 15: 512): a window of 1 client at
# ~55-85 requests/s takes seconds either way
SERVE_REQUESTS = 256
SERVE_CLIENTS = (1, 32)
TRACED_REQUESTS = 256  # the 32-client window run again under torch.profiler
FUSED_BURST = 128
SERVE_MIN_COS = 0.999
# the options that make the CLIs' model phase 17's (b32_zero_shot_config's
# weights and dtype)
CLI_OPTS = ["TPU.COMPUTE_DTYPE", "bfloat16", "TPU.SEED", "0",
            "MODEL.PRETRAINED_MODEL", ""]
# the wrappers' counter names -> the kernel names a trace shows
TRACED_NAMES = {"attention_fwd": "attention_fwd", "attention_halfblock":
                "attention_halfblock_kernel"}


def serve_jpegs(n=SERVE_JPEGS, seed=0):
    """``n`` JPEG bodies of random 8-px colour blocks, 96-320 px a side."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) * 8 for v in rng.integers(12, 41, 2))
        arr = np.kron(rng.random((h // 8, w // 8, 3)), np.ones((8, 8, 1)))
        buf = io.BytesIO()
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def tower_inputs(tower, b, seed, size=224, vocab=49408):
    """A bucket's input: uint8 images, or token rows (SOT, 4-19 random
    ids, EOT, zeros)."""
    rng = np.random.default_rng(seed)
    if tower == "image":
        return rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    tokens = np.zeros((b, 77), np.int32)
    for i in range(b):
        k = int(rng.integers(5, 20))
        tokens[i, 0] = vocab - 2
        tokens[i, 1:k] = rng.integers(1, vocab - 2, k - 1)
        tokens[i, k] = vocab - 1
    return tokens


def stream_ms(fn, n_inputs, stream, iters=30, warmup=3):
    """Mean time of ``fn(i)`` over ``iters`` calls by CUDA events on
    ``stream`` (each call ends in a copy to the host, so this is the
    call's latency)."""
    for i in range(warmup):
        fn(i % n_inputs)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for i in range(iters):
        fn(i % n_inputs)
    stop.record(stream)
    stop.synchronize()
    return start.elapsed_time(stop) / iters


# calls a device trace of a bucket (PR 12-15: 30, PR 16: 10; the
# profiler's processing of 30 eager calls took 12-28 s a bucket): a depth
# cut for the time limit
SERVE_TRACED_CALLS = 5


def graph_rows(served, label, profiled=(1, 64), eager_profiled=True):
    """Each tower and bucket of ``served``: the replay against an eager
    call of the same towers on the same padded batch, bit for bit (3
    inputs), then both timed by CUDA events (30 calls after 3). At the
    ``profiled`` buckets also the device time of ``SERVE_TRACED_CALLS``
    replays from torch.profiler (and of as many eager calls with
    ``eager_profiled``), and the
    K1/K5 kernels that trace shows a replay, beside the launches the
    capture counted."""
    rows = []
    for tower, fns in (("image", served.image_fns),
                       ("text", served.text_fns)):
        for b, r in sorted(fns.items()):
            t0 = time.time()
            xs = [tower_inputs(tower, b, seed, served.image_size)
                  for seed in range(3)]
            for x in xs:
                got, want = r(x), r.eager(x)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"{label} {tower} bucket {b}: the graph replay "
                        f"differs from eager by {np.abs(got - want).max()}")
            row = {"bundle": label, "tower": tower, "bucket": b,
                   "capture_s": round(r.capture_s, 4),
                   "pool_mb": round(r.pool_bytes / 2 ** 20, 2),
                   "per_replay": {k: v for k, v in r.launches.items() if v}}
            for name, fn in (("graph", r), ("eager", r.eager)):
                call = functools.partial(lambda i, f: f(xs[i % 3]), f=fn)
                row[f"{name}_ms"] = stream_ms(call, 3, r.stream)
                if b not in profiled or (name == "eager"
                                         and not eager_profiled):
                    continue
                recs = device_records(call, 3, SERVE_TRACED_CALLS)
                row[f"{name}_device_ms"] = (
                    sum(us for _, us in recs.values())
                    / SERVE_TRACED_CALLS / 1e3 if recs else None)
                if name == "graph":
                    row["traced_per_replay"] = {
                        k: sum(n for key, (n, _) in recs.items()
                               if kname in key) / SERVE_TRACED_CALLS
                        for k, kname in TRACED_NAMES.items()} if recs \
                        else None
            row["graph_vs_eager"] = row["graph_ms"] / row["eager_ms"]
            row["seconds"] = round(time.time() - t0, 2)
            log("serve_graph", **{k: json.dumps(v) if isinstance(v, dict)
                                  else v for k, v in row.items()})
            rows.append(row)
    return rows


def http_json(url, body=None, ctype="application/json"):
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


# the load of drive_server, in a process of its own without torch: each of
# `clients` threads keeps one HTTP/1.1 connection and POSTs the JPEGs of a
# directory (cycled) to /v1/embed/image; the embeddings go to an .npy, the
# wall seconds and each request's latency to the last line
HTTP_CLIENT = """
import concurrent.futures as cf, http.client, json, os, sys, threading, time
import numpy as np
host, port, clients, n, jpegs, out = sys.argv[1:]
port, clients, n = int(port), int(clients), int(n)
names = sorted(os.listdir(jpegs), key=lambda f: int(f.split(".")[0]))
bodies = [open(os.path.join(jpegs, f), "rb").read() for f in names]
local = threading.local()
lat = [0.0] * n
def one(i):
    if not hasattr(local, "conn"):
        local.conn = http.client.HTTPConnection(host, port, timeout=120)
    t = time.perf_counter()
    local.conn.request("POST", "/v1/embed/image", bodies[i % len(bodies)],
                       {"Content-Type": "image/jpeg"})
    r = local.conn.getresponse()
    got = json.loads(r.read())
    lat[i] = time.perf_counter() - t
    if r.status != 200:
        raise RuntimeError(got)
    return np.asarray(got["embedding"], np.float32)
t0 = time.perf_counter()
with cf.ThreadPoolExecutor(clients) as ex:
    embs = list(ex.map(one, range(n)))
wall = time.perf_counter() - t0
np.save(out, np.stack(embs))
print("CLIENT " + json.dumps({"wall": wall, "lat": lat}), flush=True)
"""


def drive_server(address, clients, n, tmp):
    """``n`` requests of :data:`HTTP_CLIENT` from another process (the
    load's threads do not share the server's interpreter) over ``clients``
    kept-alive connections, on the JPEGs in ``tmp/jpegs``: ``(embeddings by
    request, stats)``; the mean batch from the difference of /stats."""
    base = "http://%s:%d" % address
    before = http_json(base + "/stats")["image"]
    out = os.path.join(tmp, f"client-{clients}-{n}.npy")
    r = subprocess.run(
        [sys.executable, "-c", HTTP_CLIENT, address[0], str(address[1]),
         str(clients), str(n), os.path.join(tmp, "jpegs"), out],
        capture_output=True, text=True)
    done = [ln for ln in r.stdout.splitlines() if ln.startswith("CLIENT ")]
    if r.returncode or not done:
        raise AssertionError(f"HTTP load failed ({r.returncode}): "
                             f"{r.stderr[-3000:]}")
    res = json.loads(done[-1][len("CLIENT "):])
    after = http_json(base + "/stats")["image"]
    batches = after["batches"] - before["batches"]
    lat = np.asarray(res["lat"]) * 1e3
    stats = {"clients": clients, "requests": n, "wall_s": res["wall"],
             "requests_per_s": n / res["wall"],
             "p50_ms": float(np.percentile(lat, 50)),
             "p90_ms": float(np.percentile(lat, 90)),
             "p99_ms": float(np.percentile(lat, 99)),
             "max_ms": float(lat.max()),
             "mean_batch": (after["samples"] - before["samples"])
             / max(batches, 1), "batches": batches}
    return np.load(out), stats


def busy_us(spans):
    """The microseconds that the union of ``(start, end)`` spans covers."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def traced_window(address, clients, n, tmp):
    """:func:`drive_server` under torch.profiler: ``(embeddings, stats)``
    with the device's busy share of the load's wall seconds, the union of
    the spans of the trace's device records over them: ``busy_share`` of
    every record (kernels, copies, memsets), ``kernel_busy_share`` of the
    kernels alone; None where the trace holds no device record. The
    profiler slows the host, so the window's own rate is beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        embs, stats = drive_server(address, clients, n, tmp)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    wall_us = stats["wall_s"] * 1e6
    kernels = [(s, e) for name, s, e in spans
               if not name.startswith(("Memcpy", "Memset"))]
    stats.update(
        device_records=len(spans),
        busy_share=busy_us((s, e) for _, s, e in spans) / wall_us
        if spans else None,
        kernel_busy_share=busy_us(kernels) / wall_us if kernels else None,
        origin="torch.profiler trace of the window; busy = union of the "
               "device records' spans over the client's wall time")
    return embs, stats


def serve_cli(args, log_path):
    """``python -m msclip_torch.tools.serve --port 0 <args>`` on its
    default device, its output to ``log_path``."""
    with open(log_path, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "msclip_torch.tools.serve", "--port", "0",
             *args], cwd=REPO, stdout=f, stderr=subprocess.STDOUT, text=True)


def serving_url(proc, log_path, deadline_s=300):
    """The address a serve CLI announces on its ``SERVING`` line, once it
    has captured and called every bucket; raises if it exits first or
    takes over ``deadline_s``."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        with open(log_path) as f:
            text = f.read()
        done = [ln for ln in text.splitlines() if ln.startswith("SERVING ")]
        if done:
            return done[0].split()[1]
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    raise AssertionError(f"serve CLI {proc.args[3:]} announced no address "
                         f"(exit {proc.poll()}): {text[-3000:]}")


def stop(procs):
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def least_cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def replayed_launches(served, kernel):
    """The launches of ``kernel`` that ``served``'s replays ran since
    their counts were last set to 0: replays x launches a replay."""
    return sum(r.replays * r.launches[kernel]
               for fns in (served.image_fns, served.text_fns)
               for r in fns.values())


def reset_replays(*served):
    for s in served:
        for fns in (s.image_fns, s.text_fns):
            for r in fns.values():
                r.replays = 0


def export_cmd(bundle):
    """The ``export_serving`` CLI's command for phase 17's bundle: buckets
    1/4/16/64 and the ImageNet prompt classifier (1,000 x 80)."""
    return [sys.executable, "-m", "msclip_torch.tools.export_serving",
            "--model", B32_CONFIG, "--out", bundle,
            "--buckets", ",".join(map(str, SERVE_BUCKETS)),
            "--classify-prompts", "imagenet", *CLI_OPTS]


def start_export(tmp):
    """Start the ``export_serving`` CLI of phase 17's bundle into ``tmp``
    now, its output to files there (it runs beside phase 16). Returns its
    handle for :func:`finish_export`."""
    e = {name: os.path.join(tmp, name) for name in (
        "b32", "export.out", "export.err")}
    with open(e["export.out"], "w") as out, \
            open(e["export.err"], "w") as err:
        e["proc"] = subprocess.Popen(export_cmd(e["b32"]), cwd=REPO,
                                     stdout=out, stderr=err, text=True)
    return e


def finish_export(e, timeout=600):
    """Wait for :func:`start_export`'s CLI: ``(bundle dir, its EXPORTED
    line)``."""
    try:
        rc = e["proc"].wait(timeout)
    except subprocess.TimeoutExpired:
        stop([e["proc"]])
        raise
    with open(e["export.out"]) as f:
        exported = [ln for ln in f.read().splitlines()
                    if ln.startswith("EXPORTED ")]
    if rc or not exported:
        with open(e["export.err"]) as f:
            raise AssertionError(f"export_serving failed ({rc}): "
                                 f"{f.read()[-3000:]}")
    return e["b32"], exported[0]


def run_serve(exported=None):
    """Phase 17: serving MS-CLIP-S B/32 at full width (seed-0 weights, bf16,
    BN folded). A bundle with buckets 1/4/16/64 and the ImageNet prompt
    classifier (1,000 x 80) exported by the ``export_serving`` CLI on the
    card (``exported``: :func:`finish_export`'s bundle, exported ahead;
    else here) and loaded (a CUDA graph a tower and bucket); each graph against
    eager bit for bit and both timed; ``InferenceServer`` on 256 JPEGs of
    96-320 px with 1 and 32 clients in another process (256 requests
    each), every served embedding against an eager batch-1 call on the
    same crop (least cosine > 0.999), the 32-client window again under
    torch.profiler for the device's busy share, and one request to each
    other route; then a ``TPU.USE_FUSED_BLOCK`` bundle (buckets 1/64):
    replay against eager bit for bit, against the unfused bundle (least
    cosine > 0.999), and a burst through the server; last the ``serve``
    CLI on the card, on the bundle (its /v1/classify top 5 against the
    in-process server's) and live from the config (buckets 1/64, its
    embedding of a JPEG against the eager reference). K1's and K5's
    launches count the replays of the in-process servers' traffic times
    each graph's launches. Returns a JSON-able dict."""
    import base64
    import dataclasses

    from PIL import Image

    from msclip_torch.eval.checkpoint_load import load_model_params
    from msclip_torch.models.msclip import build_spec
    from msclip_torch.serve import export_bundle, load_bundle, pil_to_uint8
    from msclip_torch.serve.export import serving_params, spec_from_json
    from msclip_torch.serve.server import InferenceServer

    seconds = {}
    t0 = time.time()

    def lap(name):
        nonlocal t0
        seconds[name] = round(time.time() - t0, 2)
        t0 = time.time()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = b32_zero_shot_config()
    spec = build_spec(cfg)
    params = serving_params(spec, load_model_params(cfg, spec))
    lap("params")
    out = {"seconds": seconds}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    if exported is None:
        exported = finish_export(start_export(tmp))
    bundle, exported_line = exported
    lap("export_cli")
    served = load_bundle(bundle, device="cuda")
    classifier, classnames = served.classifier, served.classnames
    if spec_from_json(served.manifest["model"]) != spec:
        raise AssertionError("the exported bundle's spec is not phase 17's")
    lap("load")
    fused_spec = dataclasses.replace(spec, use_fused_block=True)
    export_bundle(fused_spec, params, os.path.join(tmp, "fused"),
                  buckets=FUSED_BUCKETS)
    fused = load_bundle(os.path.join(tmp, "fused"), device="cuda")
    lap("fused_export_load")
    graphs = [r for s in (served, fused) for fns in (s.image_fns, s.text_fns)
              for r in fns.values()]
    log("serve_load", exported=exported_line,
        classifier_shape=list(classifier.shape),
        seconds=json.dumps(seconds), graphs=len(graphs),
        capture_s=round(sum(r.capture_s for r in graphs), 3),
        pool_mb=round(sum(r.pool_bytes for r in graphs) / 2 ** 20, 1),
        bundle_mb=round(os.path.getsize(os.path.join(
            bundle, "params.npz")) / 2 ** 20, 1))
    blocks = {"image": spec.effective_vision_layers - spec.first_block,
              "text": spec.text_layers}
    for s, kernel, other in ((served, "attention_fwd", "attention_halfblock"),
                             (fused, "attention_halfblock", "attention_fwd")):
        for tower, fns in (("image", s.image_fns), ("text", s.text_fns)):
            for b, r in fns.items():
                if r.launches[kernel] != blocks[tower] or r.launches[other]:
                    raise AssertionError(
                        f"{tower} bucket {b}: the capture recorded "
                        f"{r.launches}, expected {kernel} x {blocks[tower]}")
    out["graphs"] = graph_rows(served, "b32") + graph_rows(
        fused, "b32_fused", eager_profiled=False)
    lap("graphs")

    jpegs = serve_jpegs()
    os.makedirs(os.path.join(tmp, "jpegs"))
    for i, j in enumerate(jpegs):
        with open(os.path.join(tmp, "jpegs", f"{i}.jpg"), "wb") as f:
            f.write(j)
    crops = [pil_to_uint8(Image.open(io.BytesIO(j)), served.image_size)
             for j in jpegs]
    ref = np.concatenate([served.image_fns[1].eager(c[None]) for c in crops])
    lap("references")
    reset_replays(served, fused)
    server = InferenceServer(served, "127.0.0.1", 0, max_wait_ms=5.0).start()
    base = "http://%s:%d" % server.address
    try:
        out["server"] = []
        windows = [(c, SERVE_REQUESTS, drive_server) for c in SERVE_CLIENTS]
        windows.append((32, TRACED_REQUESTS, traced_window))
        for clients, n, drive in windows:
            embs, stats = drive(server.address, clients, n, tmp)
            stats["least_cos"] = least_cosine(
                embs, [ref[i % len(jpegs)] for i in range(len(embs))])
            stats["traced"] = drive is traced_window
            log("serve_http", **stats)
            out["server"].append(stats)
            if stats["least_cos"] <= SERVE_MIN_COS:
                raise AssertionError(f"served embeddings at {clients} "
                                     f"clients: least cosine "
                                     f"{stats['least_cos']}")
        texts = ["a photo of a dog", "a photo of a cat", "a red square"]
        emb = http_json(base + "/v1/embed/text",
                        json.dumps({"texts": texts}).encode())
        cls = http_json(base + "/v1/classify?topk=5", jpegs[0], "image/jpeg")
        rank = http_json(base + "/v1/rank", json.dumps({
            "texts": texts, "image": base64.b64encode(jpegs[0]).decode(),
            "content_type": "image/jpeg"}).encode())
        health = http_json(base + "/healthz")
        want_top = int(np.argmax(ref[0] @ classifier))
        routes = {"embed_text": np.asarray(emb["embeddings"]).shape,
                  "classify_top": cls["topk"][0]["label"],
                  "classify_index": cls["topk"][0]["index"],
                  "want_index": want_top,
                  "rank": [r["index"] for r in rank["ranking"]],
                  "healthz": health["status"]}
        log("serve_routes", **{k: json.dumps(v) if not isinstance(v, str)
                               else v for k, v in routes.items()})
        if (routes["embed_text"] != (3, spec.embed_dim)
                or len(cls["topk"]) != 5 or len(rank["ranking"]) != 3
                or routes["classify_index"] != want_top
                or health["status"] != "ok"
                or cls["topk"][0]["label"] != classnames[
                    cls["topk"][0]["index"]]):
            raise AssertionError(f"serving routes answered {routes}")
    finally:
        server.close()
    k1 = replayed_launches(served, "attention_fwd")
    lap("server")

    fused_x = {t: tower_inputs(t, 64, 7, served.image_size)
               for t in ("image", "text")}
    drift = {"image": least_cosine(fused.encode_image(fused_x["image"]),
                                   served.encode_image(fused_x["image"])),
             "text": least_cosine(fused.encode_text(fused_x["text"]),
                                  served.encode_text(fused_x["text"]))}
    reset_replays(fused)
    server = InferenceServer(fused, "127.0.0.1", 0, max_wait_ms=5.0).start()
    try:
        embs, stats = drive_server(server.address, 32, FUSED_BURST, tmp)
    finally:
        server.close()
    stats["least_cos"] = least_cosine(
        embs, [ref[i % len(jpegs)] for i in range(len(embs))])
    k5 = replayed_launches(fused, "attention_halfblock")
    lap("fused_server")
    log("serve_fused", drift_image=drift["image"], drift_text=drift["text"],
        **stats, k5_launches=k5)
    out.update(fused_drift=drift, fused_server=stats, k1=k1, k5=k5)
    if min(drift.values()) <= SERVE_MIN_COS or \
            stats["least_cos"] <= SERVE_MIN_COS:
        raise AssertionError(f"fused bundle against unfused: {drift}, "
                             f"served {stats['least_cos']}")

    # the serve CLI, as a deployment starts it: on the bundle and live
    del served, fused
    torch.cuda.empty_cache()
    logs = {k: os.path.join(tmp, f"serve-{k}.log") for k in ("bundle", "live")}
    procs = {"bundle": serve_cli(["--bundle", bundle], logs["bundle"]),
             "live": serve_cli(["--model", B32_CONFIG, "--buckets", "1,64",
                                *CLI_OPTS], logs["live"])}
    try:
        urls = {k: serving_url(p, logs[k]) for k, p in procs.items()}
        lap("cli_start")
        cli_cls = http_json(urls["bundle"] + "/v1/classify?topk=5",
                            jpegs[0], "image/jpeg")
        live_health = http_json(urls["live"] + "/healthz")
        live_emb = http_json(urls["live"] + "/v1/embed/image", jpegs[0],
                             "image/jpeg")["embedding"]
    finally:
        stop(procs.values())
    tmp_dir.cleanup()
    cli = {"classify": [t["index"] for t in cli_cls["topk"]],
           "in_process": [t["index"] for t in cls["topk"]],
           "prob_diff": max(abs(a["prob"] - b["prob"]) for a, b in zip(
               cli_cls["topk"], cls["topk"])),
           "live_buckets": live_health["buckets"],
           "live_cos": least_cosine([live_emb], ref[:1])}
    lap("cli")
    log("serve_cli", **{k: json.dumps(v) for k, v in cli.items()})
    out["cli"] = cli
    if (cli["classify"] != cli["in_process"] or cli["live_buckets"] != [1, 64]
            or cli["live_cos"] <= SERVE_MIN_COS):
        raise AssertionError(f"the serve CLI answered {cli}")
    if k1 == 0 or k5 == 0:
        raise AssertionError(f"serving replayed K1 {k1} and K5 {k5} times")
    log("serve_launches", k1=k1, k5=k5, seconds=json.dumps(seconds))
    return out


def serve_in_subprocess(exported=None):
    """:func:`run_serve` in a fresh Python process on the same card (the
    profiler traces there; see :func:`traced_turns`); its lines are
    printed through."""
    r = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke as C; "
         "print('SERVE ' + json.dumps(C.run_serve("
         "json.loads(sys.argv[1]))))", json.dumps(exported)],
        cwd=REPO, capture_output=True, text=True)
    lines = r.stdout.splitlines()
    for ln in lines:
        if not ln.startswith("SERVE "):
            print(ln, flush=True)
    done = [ln for ln in lines if ln.startswith("SERVE ")]
    if r.returncode or not done:
        raise AssertionError(f"serve phase failed ({r.returncode}): "
                             f"{r.stderr[-3000:]}")
    return json.loads(done[-1][len("SERVE "):])


# ---------------------------------------------------------------------------
# --serve-split: live serving split over two cards
# ---------------------------------------------------------------------------

SPLIT_DEVICES = ("cuda:0", "cuda:1")
SPLIT_ROWS = 64  # images and prompts held split against one card


def split_k1_captured(served):
    """K1 launches captured into ``served``'s graphs, by card: each
    split bucket's parts are one graph a card."""
    out = {}
    for fns in (served.image_fns, served.text_fns):
        for bucket in fns.values():
            for part in bucket.parts:
                dev = str(part.input.device)
                out[dev] = out.get(dev, 0) + part.launches["attention_fwd"]
    return out


def split_replayed_k1(served):
    """K1 launches that ``served``'s replays ran, all cards together."""
    return sum(part.replays * part.launches["attention_fwd"]
               for fns in (served.image_fns, served.text_fns)
               for bucket in fns.values() for part in bucket.parts)


def serve_window_pair(name, args, tmp, ref):
    """The serve CLI in live mode with ``args``: its /healthz, then 1 and
    32 clients of ``SERVE_REQUESTS`` requests on the JPEGs in
    ``tmp/jpegs``, every embedding against ``ref`` (least cosine >
    ``SERVE_MIN_COS``)."""
    log_path = os.path.join(tmp, f"serve-{name}.log")
    proc = serve_cli(["--model", B32_CONFIG, *args, *CLI_OPTS], log_path)
    t0 = time.time()
    try:
        url = serving_url(proc, log_path)
        start_s = time.time() - t0
        health = http_json(url + "/healthz")
        host, port = url.split("//")[1].split(":")
        windows = []
        for clients in SERVE_CLIENTS:
            embs, stats = drive_server((host, int(port)), clients,
                                       SERVE_REQUESTS, tmp)
            stats["least_cos"] = least_cosine(
                embs, [ref[i % len(ref)] for i in range(len(embs))])
            log("serve_split_http", server=name, **stats)
            windows.append(stats)
    finally:
        stop([proc])
    worst = min(w["least_cos"] for w in windows)
    if worst <= SERVE_MIN_COS:
        raise AssertionError(f"{name} server: least cosine {worst}")
    return {"args": args, "buckets": health["buckets"],
            "start_s": round(start_s, 1), "windows": windows}


def run_serve_split():
    """``--serve-split``: full-width MS-CLIP-S B/32 (seed-0 weights, bf16,
    BN folded) served live over ``cuda:0`` and ``cuda:1`` as the serve
    CLI builds it (``tools.serve.load_live``): a CUDA graph a card, tower
    and half-bucket, K1 in every block. ``encode_image`` of 64 images and
    ``encode_text`` of 64 prompts split against the one-card live model's
    features of the same rows (least cosine > ``SERVE_MIN_COS``, the
    largest absolute difference beside it); K1's captured launches by
    card, none on a card fails; then the serve CLI on phase 17's 256
    JPEGs at 1 and 32 clients: ``--device cuda:0,cuda:1``, no
    ``--device`` (every visible card) and ``--device cuda:0`` (one card),
    in that order. Returns a JSON-able dict."""
    from PIL import Image

    from msclip_torch.serve import pil_to_uint8
    from msclip_torch.tools import serve as serve_tool

    n_cards = torch.cuda.device_count()
    if n_cards < len(SPLIT_DEVICES):
        raise SystemExit(f"chip_smoke --serve-split: {n_cards} card(s) "
                         f"visible, {len(SPLIT_DEVICES)} needed")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    args = serve_tool.parse_args(["--model", B32_CONFIG, *CLI_OPTS])
    reset_launches()
    split = serve_tool.load_live(args, [torch.device(d)
                                        for d in SPLIT_DEVICES])
    one = serve_tool.load_live(args, [torch.device(SPLIT_DEVICES[0])])
    build_s = time.time() - t0
    captured = split_k1_captured(split)
    log("serve_split_load", buckets=json.dumps(split.buckets),
        one_card_buckets=json.dumps(one.buckets),
        k1_captured_by_card=json.dumps(captured), seconds=round(build_s, 1))
    if len(captured) != len(SPLIT_DEVICES) or min(captured.values()) == 0:
        raise AssertionError(f"K1 captured by card: {captured}")

    features = {}
    reset_replays(one)
    for tower in ("image", "text"):
        x = tower_inputs(tower, SPLIT_ROWS, 11, split.image_size)
        fn = "encode_image" if tower == "image" else "encode_text"
        got, want = getattr(split, fn)(x), getattr(one, fn)(x)
        features[tower] = {
            "rows": SPLIT_ROWS, "least_cos": least_cosine(got, want),
            "max_abs_diff": float(np.abs(got - want).max()),
            "max_abs": float(np.abs(want).max())}
        log("serve_split_features", tower=tower, **features[tower])
    k1_split = split_replayed_k1(split)
    if min(f["least_cos"] for f in features.values()) <= SERVE_MIN_COS \
            or k1_split == 0:
        raise AssertionError(f"split against one card: {features}, "
                             f"K1 replayed {k1_split}")

    jpegs = serve_jpegs()
    crops = [pil_to_uint8(Image.open(io.BytesIO(j)), one.image_size)
             for j in jpegs]
    ref = np.concatenate([one.image_fns[1].eager(c[None]) for c in crops])
    del split, one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "jpegs"))
        for i, j in enumerate(jpegs):
            with open(os.path.join(tmp, "jpegs", f"{i}.jpg"), "wb") as f:
                f.write(j)
        servers = {name: serve_window_pair(name, a, tmp, ref) for name, a in (
            ("split", ["--device", ",".join(SPLIT_DEVICES)]),
            ("every_card", []),
            ("one_card", ["--device", SPLIT_DEVICES[0]]))}
    want = {"split": [2, 4, 16, 64],
            "every_card": sorted({-(-b // n_cards) * n_cards
                                  for b in (1, 4, 16, 64)}),
            "one_card": [1, 4, 16, 64]}
    got = {k: v["buckets"] for k, v in servers.items()}
    log("serve_split_servers", buckets=json.dumps(got),
        cards=n_cards, seconds=round(time.time() - t0, 1))
    if got != want:
        raise AssertionError(f"the servers' buckets {got}, not {want}")
    return {"features": features, "k1_captured_by_card": captured,
            "k1_replayed_split": k1_split, "servers": servers}


# ---------------------------------------------------------------------------
# phase 19: the model zoo (plain CLIP ViT-B/32, RN50, the [off] families)
# ---------------------------------------------------------------------------

B32_YAML = os.path.join(REPO, "experiments", "model", "b32.yaml")
# OpenAI CLIP's RN50 geometry over b32.yaml (clip/model.py build_model)
RN50_JSON = os.path.join(REPO, "msclip_torch", "config", "rn50.json")
ZOO_MODELS = (("b32", B32_YAML), ("rn50", RN50_JSON))
# fp32 features, card against CPU: 55x the largest sound reading on the
# H100 (1.83e-7, the Perceiver family); a feature is ~0.03-0.04
ZOO_ATOL = 1e-5
ZOO_TRAIN_STEPS = 3
# the families over b32-yfcc-msclips.json at full width, cut to 6 layers
# with the lateral adapters at layers 1-5 (every branch stage runs)
ZOO_DEPTH = ("MODEL.SPEC.VISION.LAYERS", 6, "MODEL.SPEC.TEXT.LAYERS", 6,
             "CUSTOM.PARALLEL_LATERAL_LAYER", [1, 2, 3, 4, 5])
ZOO_FAMILIES = {
    "adapter": ("CUSTOM.ADAPTER_FLAG", True, "CUSTOM.ADAPTER_ATTN_DIM", 64),
    "lora_moe": ("CUSTOM.LORA_ATTN_DIM", 16, "CUSTOM.LORA_ATTN_ALPHA", 32,
                 "CUSTOM.LORA_WHERE_ADD", "v2", "CUSTOM.LORA_MOE", 1,
                 "CUSTOM.LORA_MOE_ACT", "sigmoid", "CUSTOM.LORA_MOE_GROUP", 2),
    "cvt": ("CUSTOM.CVT_IN_V", True, "CUSTOM.CVT_V_RES", True,
            "CUSTOM.TWO_DWC_IN_CVT", True),
    "cvt_inside": ("CUSTOM.CVT_IN_V", True, "CUSTOM.CVT_INSIDE", True,
                   "CUSTOM.CVT_INSIDE_Q", True, "CUSTOM.CVT_INSIDE_K", True,
                   "CUSTOM.CVT_INSIDE_V", True),
    "convit": ("CUSTOM.CONVIT_IN_V", True),
    "container": ("CUSTOM.CONTAINER_IN_V", True),
    "gumbel": ("CUSTOM.GUMBEL_SELECT", True),
    "perceiver": ("CUSTOM.PERCEIVER_IN_V", True, "CUSTOM.PERCEIVER_IN_T", True,
                  "CUSTOM.PERCEIVER_LAYER", [2, 4],
                  "CUSTOM.PERCEIVER_N_LATENT", 16),
    "b2t_deconv": ("CUSTOM.PARALLEL_B2T", True),
    "b2t_bilinear": ("CUSTOM.PARALLEL_B2T", True,
                     "CUSTOM.PARALLEL_B2T_BILINEAR", True),
    # heads of 64: stage 0's 48 channels would hold none
    "b2t_crossattn": ("CUSTOM.PARALLEL_B2T", True,
                      "CUSTOM.PARALLEL_B2T_CROSSATTN", True,
                      "CUSTOM.PARALLEL_B2T_LAYER",
                      [False, True, True, True, True]),
    "window_t2b": ("CUSTOM.PARALLEL_T2B_WINDOWATTN", True),
    "t2b_bn_relu": ("CUSTOM.PRALLEL_T2B_ADD_BN_RELU", True),
    "t2b_bn_ln_relu": ("CUSTOM.PRALLEL_T2B_ADD_BN_LN_RELU", True),
    "t2b_noln_add": ("CUSTOM.PRALLEL_T2B_NOLN_ADD", True),
    # the pools halve stages 0-1's maps: their t2b convs stride half as far
    "t2b_pool": ("CUSTOM.PARALLEL_T2B_POOL_SIZE", [2, 2, 0, 0, 0],
                 "CUSTOM.PRALLEL_T2B_KERNELS", [8, 4, 4, 2, 1],
                 "CUSTOM.PRALLEL_T2B_STRIDES", [8, 4, 4, 2, 1]),
    "plain_stem": ("CUSTOM.EARLY_CONV_RES", False),
    "stem_outside": ("CUSTOM.EARLY_CONV_NEW_IMPLEMENT", False),
    "conv_pool": ("MODEL.SPEC.POOL_TYPE", "linear"),
}


def zoo_config(base, *opts):
    from msclip_torch.config import get_default_config, update_config

    cfg = get_default_config()
    update_config(cfg, base, opts=["MODEL.PRETRAINED_MODEL", "", "TPU.SEED",
                                   0, *opts])
    return cfg


def zoo_k1_blocks(spec):
    """``(image, text)``: the K1 launches of one forward of each tower,
    by the port's rule: a transformer block launches K1 unless a plug-in
    sits inside its attention (CvT inside, ConViT, Container, LoRA); a
    Gumbel block launches it in the branch it takes (both under
    ``GUMBEL_ADDTWO``); the ResNet tower, the Perceiver blocks and the
    cross attentions launch none."""
    ext = spec.ext

    def k1(modality, i):
        if ext.gumbel_select:
            return 2 if ext.gumbel_addtwo else 1
        inside = any(ext.layer_has(f, modality, i)
                     for f in ("convit", "container", "lora")) or (
            ext.cvt_inside and ext.layer_has("cvt", modality, i))
        return 0 if inside else 1

    image = 0 if spec.vision_resnet_layers else sum(
        k1("visual", i) for i in range(spec.first_block,
                                       spec.effective_vision_layers))
    return image, sum(k1("text", i) for i in range(spec.text_layers))


def zoo_inputs(n, size, seed=0):
    from msclip_torch.data import ClipTokenizer, get_classnames, get_templates
    from msclip_torch.data.datasets import SyntheticImageDataset

    ds = SyntheticImageDataset(n=n, size=size, seed=seed)
    images = torch.from_numpy(np.stack([ds[i][0] for i in range(n)]))
    names, templates = get_classnames("imagenet"), get_templates("imagenet")
    texts = [templates[i % len(templates)].format(names[i]) for i in range(n)]
    return images, torch.from_numpy(ClipTokenizer()(texts))


def zoo_weights(cfg):
    """``(spec, fp32 seed-0 parameters)`` of a zoo config, on the CPU."""
    from msclip_torch.models.msclip import build_spec, init_params

    spec = build_spec(cfg)  # fp32: also turns TF32 off
    return spec, init_params(spec, torch.Generator().manual_seed(0))


def zoo_card_against_cpu(name, cfg, n=8, atol=ZOO_ATOL, count=True,
                         n_text=None, weights=None):
    """fp32 features of ``n`` images and ``n_text`` prompts (default
    ``n``) through the model's entry points, the card with its kernels
    against the CPU with the plain versions, same weights, within
    ``atol``. The card's K1 launches are held to :func:`zoo_k1_blocks`;
    with ``TPU.USE_FUSED_BLOCK`` K5's instead, by width (768 in the ViT,
    the text tower's in the text tower), and K1 to none. ``weights``:
    :func:`zoo_weights` of ``cfg``, drawn ahead. Returns the K1 launches
    (with ``count``)."""
    from msclip_torch.models.msclip import MSClipModel

    t0 = time.time()
    spec, params = weights or zoo_weights(cfg)
    n_text = n_text or n
    images, tokens = zoo_inputs(max(n, n_text), spec.image_resolution)
    images, tokens = images[:n], tokens[:n_text]
    feats, seconds = {}, {"init": round(time.time() - t0, 2)}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        model = MSClipModel(spec, params).to(dev)
        reset_launches()
        with torch.inference_mode():
            feats[dev] = (model.encode_image(images.to(dev)).cpu(),
                          model.encode_text(tokens.to(dev)).cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            k1 = A.fused_attention_qkv.launches
            k5 = dict(BF.fused_attention_halfblock.launches_by_width)
        seconds[dev] = round(time.time() - t0, 2)
    errs = [(a - b).abs().max().item()
            for a, b in zip(feats["cuda"], feats["cpu"])]
    expected = sum(zoo_k1_blocks(spec))
    k5_expected = dict.fromkeys(BF.WIDTHS, 0)
    if spec.use_fused_block:
        image, text = zoo_k1_blocks(spec)  # a ResNet tower has no block
        if image:
            k5_expected[spec.vision_width] += image
        k5_expected[spec.text_width] += text
        expected = 0
    log("zoo_card_vs_cpu", family=name, dtype="float32", n=n, n_text=n_text,
        image_err=errs[0], text_err=errs[1], atol=atol, k1_launches=k1,
        expected=expected, k5_launches=json.dumps(k5),
        k5_expected=json.dumps(k5_expected), counted=count,
        seconds=json.dumps(seconds))
    if not all(math.isfinite(e) and e <= atol for e in errs):
        raise AssertionError(f"zoo {name}: card and CPU features differ: "
                             f"{errs} > {atol}")
    if k1 != expected or k5 != k5_expected:
        raise AssertionError(f"zoo {name}: K1 launched {k1} times and K5 "
                             f"{k5}, expected {expected} and {k5_expected}")
    return k1 if count else 0


def run_zoo(batch=256):
    """Phase 19, the model zoo. b32.yaml (plain CLIP ViT-B/32: patchify,
    12 blocks at 768, its own 512-wide 8-head text tower) and the RN50
    geometry over it: zero-shot on 512 synthetic images, 100 classes x 80
    templates, batch 256, bf16, K1 held to the towers' blocks; the card
    against the CPU in fp32 on one batch; 3 train steps of b32.yaml at
    batch 256, bf16, K1 and K2 held to 24 a step. Then each [off] family
    over b32-yfcc-msclips.json at full width (6 layers): one fp32 forward
    of 8 images and 8 prompts, the card against the CPU; and one bf16
    train step of the Gumbel family. Returns the K1 and K2 launches."""
    from msclip_torch.eval.zero_shot import run_zero_shot
    from msclip_torch.models.msclip import build_spec, init_params
    from msclip_torch.tools.train import train
    from msclip_torch.train.trainer import (init_train_state,
                                            make_train_step_from_config)

    total = [0, 0]
    for name, base in ZOO_MODELS:
        cfg = zoo_config(base, "DATASET.DATASET", "synthetic",
                         "DATASET.NUM_SAMPLES", 512, "TEST.BATCH_SIZE_PER_GPU",
                         batch, "TEST.SUBSET_CLASSES", 100,
                         "TPU.COMPUTE_DTYPE", "bfloat16")
        image, text = zoo_k1_blocks(build_spec(cfg))
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        value, stats = run_zero_shot(cfg, device="cuda")
        torch.cuda.synchronize()
        k1 = A.fused_attention_qkv.launches
        expected = image * stats["n_image_batches"] \
            + text * stats["n_text_chunks"]
        log("zoo_zero_shot", model=name, dtype="bfloat16", top1=value,
            n_images=stats["n_images"], images_per_s=stats["images_per_sec"],
            classifier_s=stats["classifier_s"],
            image_batches=stats["n_image_batches"],
            text_chunks=stats["n_text_chunks"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            k1_launches=k1, expected=expected)
        if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
            raise AssertionError(f"zoo {name} zero-shot: {value}, {stats}")
        if k1 != expected or (name == "b32" and k1 == 0):
            raise AssertionError(f"zoo {name} zero-shot: K1 launched {k1} "
                                 f"times, expected {expected}")
        total[0] += k1
    for name, base in ZOO_MODELS:
        zoo_card_against_cpu(name, zoo_config(
            base, "TPU.COMPUTE_DTYPE", "float32"), count=False)
    k5 = run_zoo_fused(batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = zoo_config(B32_YAML, "DATASET.DATASET", "synthetic",
                     "TRAIN.BATCH_SIZE_PER_GPU", batch, "DATASET.NUM_SAMPLES",
                     ZOO_TRAIN_STEPS * batch, "TRAIN.END_EPOCH", 1,
                     "TPU.COMPUTE_DTYPE", "bfloat16")
    per_step = sum(zoo_k1_blocks(build_spec(cfg)))
    reset_launches()
    A.fused_attention_qkv_bwd.launches = 0
    _, stats = train(cfg, device="cuda")
    torch.cuda.synchronize()
    got = launches_held("zoo_train", attention_launches(),
                        per_step * ZOO_TRAIN_STEPS, per_step * ZOO_TRAIN_STEPS)
    log("zoo_train", model="b32", dtype="bfloat16", batch=batch,
        steps=stats["steps"], losses=json.dumps(stats["losses"]),
        samples_per_s=stats["samples_per_s"], seconds=stats["seconds"],
        peak_mem_gb=stats["peak_mem_gb"], k1_launches=got[0],
        k2_launches=got[1])
    if stats["steps"] != ZOO_TRAIN_STEPS or not all(
            math.isfinite(x) for x in stats["losses"]):
        raise AssertionError(f"zoo train: {stats['steps']} steps, losses "
                             f"{stats['losses']}")
    total = [total[0] + got[0], total[1] + got[1]]

    # each family's weights drawn on the CPU while the one before runs
    cfgs = [(name, zoo_config(B32_CONFIG, "TPU.COMPUTE_DTYPE", "float32",
                              *ZOO_DEPTH, *opts))
            for name, opts in ZOO_FAMILIES.items()]
    with cf.ThreadPoolExecutor(1) as pool:
        ahead = pool.submit(zoo_weights, cfgs[0][1])
        for i, (name, cfg) in enumerate(cfgs):
            weights = ahead.result()
            if i + 1 < len(cfgs):
                ahead = pool.submit(zoo_weights, cfgs[i + 1][1])
            total[0] += zoo_card_against_cpu(name, cfg, weights=weights)

    cfg = zoo_config(B32_CONFIG, "TPU.COMPUTE_DTYPE", "bfloat16",
                     "CUSTOM.GUMBEL_LR", 1e-2, *ZOO_DEPTH,
                     *ZOO_FAMILIES["gumbel"])
    spec = build_spec(cfg)
    params = init_params(spec, torch.Generator().manual_seed(0))
    before = params["gumbel_logit"].clone()
    state = init_train_state(cfg, spec, params, 1, "cuda")
    step = make_train_step_from_config(cfg, spec)
    images, tokens = zoo_inputs(64, spec.image_resolution, seed=1)
    reset_launches()
    A.fused_attention_qkv_bwd.launches = 0
    metrics = step(state, images.cuda(), tokens.cuda())
    torch.cuda.synchronize()
    per_step = sum(zoo_k1_blocks(spec))
    got = launches_held("zoo_gumbel_step", attention_launches(), per_step,
                        per_step)
    moved = (state.model.params()["gumbel_logit"].detach().cpu()
             - before).abs().max().item()
    log("zoo_gumbel_step", dtype="bfloat16", batch=64,
        loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
        gumbel_logit_moved=moved, k1_launches=got[0], k2_launches=got[1])
    if not (math.isfinite(metrics["loss"].item()) and moved > 0):
        raise AssertionError(f"zoo gumbel step: loss {metrics['loss']}, "
                             f"logits moved {moved}")
    return [total[0] + got[0], total[1] + got[1]], k5


def run_zoo_fused(batch=256):
    """b32.yaml and RN50 zero-shot with ``TPU.USE_FUSED_BLOCK`` (bf16, batch
    256, 512 images, 100 classes x 80 templates): K5 in every transformer
    block, at E = 768 in b32.yaml's 12 image blocks and at E = 512 in both
    text towers' 12 blocks, held to 12 x image batches (b32.yaml) + 12 x
    text chunks, and K1 to none; then fp32 features of 8 images and 16
    prompts, the card (K5) against the CPU (its plain version), at
    ``ZOO_ATOL``; and one batch of bf16 image and text features, fused
    against unfused, same weights, least cosine > 0.999. Returns K5's
    launches by width over the two zero-shot runs."""
    from msclip_torch.eval.zero_shot import load_eval_model, run_zero_shot
    from msclip_torch.models.msclip import build_spec

    zs = ("DATASET.DATASET", "synthetic", "DATASET.NUM_SAMPLES", 512,
          "TEST.BATCH_SIZE_PER_GPU", batch, "TEST.SUBSET_CLASSES", 100,
          "TPU.COMPUTE_DTYPE", "bfloat16")
    total = dict.fromkeys(BF.WIDTHS, 0)
    for name, base in ZOO_MODELS:
        cfg = zoo_config(base, *zs, "TPU.USE_FUSED_BLOCK", True)
        spec = build_spec(cfg)
        image, text = zoo_k1_blocks(spec)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        value, stats = run_zero_shot(cfg, device="cuda")
        torch.cuda.synchronize()
        nb, nc = stats["n_image_batches"], stats["n_text_chunks"]
        k5 = dict(BF.fused_attention_halfblock.launches_by_width)
        expected = dict.fromkeys(BF.WIDTHS, 0)
        if image:  # a ResNet tower has no block
            expected[spec.vision_width] += image * nb
        expected[spec.text_width] += text * nc
        log("zoo_fused_zero_shot", model=name, dtype="bfloat16", top1=value,
            n_images=stats["n_images"], images_per_s=stats["images_per_sec"],
            classifier_s=stats["classifier_s"], image_batches=nb,
            text_chunks=nc,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            k5_launches=json.dumps(k5), expected=json.dumps(expected),
            k1_launches=A.fused_attention_qkv.launches)
        if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
            raise AssertionError(f"zoo {name} fused zero-shot: {value}, "
                                 f"{stats}")
        if k5 != expected or k5[512] == 0 or A.fused_attention_qkv.launches:
            raise AssertionError(
                f"zoo {name} fused zero-shot: K5 launched {k5}, expected "
                f"{expected}; K1 {A.fused_attention_qkv.launches}")
        for w in BF.WIDTHS:
            total[w] += k5[w]
    for name, base in ZOO_MODELS:
        zoo_card_against_cpu(name + "_fused", zoo_config(
            base, "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_FUSED_BLOCK",
            True), count=False, n_text=16)
    for name, base in ZOO_MODELS:
        cfgs = {f: zoo_config(base, "TPU.COMPUTE_DTYPE", "bfloat16",
                              "TPU.USE_FUSED_BLOCK", f) for f in (True, False)}
        spec = build_spec(cfgs[True])
        images, tokens = zoo_inputs(batch, spec.image_resolution, seed=2)
        feats = {}
        for fused, cfg in cfgs.items():
            model = load_eval_model(cfg, build_spec(cfg), "cuda")
            with torch.inference_mode():
                feats[fused] = (model.encode_image(images.cuda()).float(),
                                model.encode_text(tokens.cuda()).float())
        cos = [least_cosine(a.cpu().numpy(), b.cpu().numpy())
               for a, b in zip(feats[True], feats[False])]
        log("zoo_fused_drift", model=name, batch=batch, image_min_cos=cos[0],
            text_min_cos=cos[1])
        if not min(cos) > 0.999:
            raise AssertionError(f"zoo {name}: fused features drift from the "
                                 f"unfused ones: least cosines {cos}")
    return total


def zoo_planted_faults():
    """``python3 chip_smoke.py --zoo-faults``: faults planted on the card's
    side only, each of which phase 19's card-against-CPU check
    (:func:`zoo_card_against_cpu` at ``ZOO_ATOL``) must catch: the
    bottom-to-top deconv's output map moved one column (what a wrong
    stride or offset gives), and one row of K1's output (sample 0, token
    0, every launch) scaled by 1 + 1e-2 and by 1 + 1e-3. Logs each
    reading; fails if a fault passes the check."""
    import msclip_torch.models.layers as L
    import msclip_torch.models.stem as S

    def moved_deconv(x, *args, **kw):
        out = real["deconv"](x, *args, **kw)
        return out.roll(1, dims=-1) if x.is_cuda else out

    def k1_row(scale):
        def k1(qkv, *args, **kw):
            out = real["k1"](qkv, *args, **kw)
            if qkv.is_cuda:
                out = out.clone()
                out[0, 0] *= scale
            return out
        return k1

    real = {"deconv": S.conv_transpose2d, "k1": L.fused_attention_qkv}
    b2t = zoo_config(B32_CONFIG, "TPU.COMPUTE_DTYPE", "float32", *ZOO_DEPTH,
                     *ZOO_FAMILIES["b2t_deconv"])
    b32 = zoo_config(B32_YAML, "TPU.COMPUTE_DTYPE", "float32")
    missed = []
    for fault, name, cfg, module, attr, fn in (
            ("deconv_moved_one_column", "b2t_deconv", b2t, S,
             "conv_transpose2d", moved_deconv),
            ("k1_row_times_1.01", "b32", b32, L, "fused_attention_qkv",
             k1_row(1.01)),
            ("k1_row_times_1.001", "b32", b32, L, "fused_attention_qkv",
             k1_row(1.001))):
        kept = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            zoo_card_against_cpu(name, cfg, count=False)
            caught = False
        except AssertionError as e:
            caught = "features differ" in str(e)
        finally:
            setattr(module, attr, kept)
        log("zoo_planted_fault", fault=fault, family=name, atol=ZOO_ATOL,
            caught=caught)
        if not caught:
            missed.append(fault)
    if missed:
        raise AssertionError(f"planted faults passed the zoo check: {missed}")


def headline(rows, **match):
    return next(r for r in rows if "ms" in r
                and all(r[k] == v for k, v in match.items()))


def kernel_line(rows, launches, name, replaces, head, shape, source=None):
    """The per-kernel JSON entry: times and bound from the headline row
    ``head``; every checked shape is under ``shapes``."""
    line = {
        "name": name, "route": "cuda",
        "source": source or f"msclip_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if "max_abs_err" in r),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": shape,
        "shapes": rows,
    }
    for key in ("device_ms", "library_device_ms", "vs_library",
                "plain_device_ms", "vs_plain",
                "compile_ms", "unfused_ms", "unfused_device_ms", "vs_unfused",
                "unfused_sdpa_ms", "k5_ms", "k5_device_ms", "k1_matmul_ms",
                "k1_matmul_device_ms", "vs_k1_matmul", "sdpa_matmul_ms",
                "hybrid_ms", "hybrid_device_ms", "hybrid_vs_unfused"):
        if key in head:
            line[key] = head[key]
    return line


def chain_kernel_lines(rows, launched):
    """The ``kernels`` entries of K7: one a kernel, its headline B/16's
    rows in bf16, from :func:`check_block_chain`'s ``rows`` and the
    slice's launches ``launched`` (:func:`chain_launches`)."""
    return [kernel_line(rows[name], launched[name], f"block_{name}",
                        "msclip_tpu/models/layers.py:259 (XLA's fusion)",
                        headline(rows[name], n_rows=CHAIN_ROWS[-1],
                                 dtype="bfloat16"),
                        f"rows={CHAIN_ROWS[-1]} E={CHAIN_E} bfloat16",
                        f"msclip_torch/csrc/{K7.SOURCE}")
            for name in rows]


def main(measure=False):
    """The default run, or with ``measure`` (``--measure``) also the
    phases that only re-measure what PERF.md records: the in-turns
    ratios of K5, K6, E1 and E2 (``traced_turns``), the tuning row's
    measurements (``tuning``) and the ``torch.compile`` yardsticks
    (``compile_baselines``)."""
    seconds = {}
    t0 = time.time()

    def timed(phase, fn, *args, **kw):
        start = time.time()
        out = fn(*args, **kw)
        seconds[phase] = round(time.time() - start, 1)
        return out

    device_and_packages()
    scratch = tempfile.TemporaryDirectory()
    slice_pred = os.path.join(scratch.name, "slice.npz")
    timed("build", build_kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traced = None
    if measure:
        traced = timed("traced_turns", traced_turns_in_subprocess)
        timed("tuning", tuning_in_subprocess)
    attn_rows = timed("k1", check_attention)
    bwd_rows = timed("k2", check_attention_bwd)
    quant_rows = timed("k3_k4", check_quant)
    chain_rows = timed("k7", check_block_chain)
    half_rows = timed("k5_k6", check_halfblocks, traced)
    launches, chain_launched = timed("slice", run_slice, slice_pred)
    timed("card_vs_cpu", card_against_cpu)
    train_launches, resident = timed("train", run_train_slice)
    timed("train_card_vs_cpu", train_card_against_cpu)
    int8_launches = timed("int8", run_int8_slice)
    timed("int8_card_vs_cpu", int8_card_against_cpu)
    k5_launches = timed("fused", run_fused_slice)
    timed("fused_card_vs_cpu", card_against_cpu, fused=True)
    tuning_rows = timed("e1_e2", check_tuning, traced)
    tuning_launches, sweep = timed("sweep", run_tuning_sweep)
    worker = export = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            transfer_launches = timed("transfer", run_transfer, tmp)
            roots = {"cifar": os.path.join(tmp, "cifar")}
            data_launches = timed("train_data", run_train_data, tmp,
                                  resident)
            native_launches = timed("native", run_native, tmp)
            # phase 18's torchrun process starts up beside phase 15, then
            # runs beside phase 16 with phase 17's export CLI: phase 16
            # measures no time, and phases 16 and 18 hold their runs to
            # references made alone (bit for bit where they can)
            worker = start_dist_worker(scratch.name)
            gc_launches = timed("gradcache", run_gradcache, resident)
            torch.cuda.empty_cache()
            let_dist_worker_go(worker)
            export = start_export(scratch.name)
            resume_launches = timed("resume", run_resume, tmp, roots)
        worker["runs"] = timed("beside_resume", finish_dist_worker, worker)
        exported = finish_export(export)
        serve = timed("serve", serve_in_subprocess, exported)
        dist_launches = timed("distributed", run_distributed, scratch.name,
                              slice_pred, worker)
    finally:
        stop([p["proc"] for p in (worker, export)
              if p and p["proc"].poll() is None])
    scratch.cleanup()
    zoo_launches, zoo_k5 = timed("zoo", run_zoo)
    if measure:
        timed("compile_baselines", run_compile_baselines)
    log("seconds", total=round(time.time() - t0, 1), phases=json.dumps(seconds))
    quant = "msclip_torch/csrc/quant.cu"
    fused_src = "msclip_torch/csrc/block_fused.cu"
    tuning_src = "msclip_torch/csrc/halfblock_tuning.cu"
    variants = tuning_rows["attention_halfblock_variants"]
    core_out = tuning_rows["core_out_halfblock"]
    print(json.dumps({"kernels": [
        {**kernel_line(attn_rows, launches + train_launches[0]
                       + int8_launches[0] + transfer_launches
                       + data_launches[0] + native_launches[0]
                       + gc_launches[0]
                       + resume_launches[0] + serve["k1"]
                       + dist_launches[0] + zoo_launches[0],
                       "attention_fwd", "msclip_tpu/ops/attention.py:243",
                       headline(attn_rows, B=256, L=50, E=768,
                                dtype="bfloat16"),
                       "B=256 L=50 E=768 H=12 bfloat16"),
         "serving_launches": serve["k1"]},
        kernel_line(bwd_rows, train_launches[1] + data_launches[1]
                    + native_launches[1] + gc_launches[1] + resume_launches[1] + dist_launches[1]
                    + zoo_launches[1],
                    "attention_bwd",
                    "msclip_tpu/ops/attention.py:146",
                    headline(bwd_rows, B=256, L=50, E=768,
                             dtype="bfloat16"),
                    "B=256 L=50 E=768 H=12 bfloat16"),
        kernel_line(quant_rows["ln_quant"], int8_launches[1], "ln_quant",
                    "msclip_tpu/ops/quant.py:109",
                    headline(quant_rows["ln_quant"], dtype="bfloat16"),
                    "B=256 L=197 E=768 bfloat16", quant),
        kernel_line(quant_rows["gelu_quant"], int8_launches[2], "gelu_quant",
                    "msclip_tpu/ops/quant.py:124",
                    headline(quant_rows["gelu_quant"], dtype="bfloat16"),
                    "B=256 L=197 F=3072 bfloat16", quant),
        *chain_kernel_lines(chain_rows, chain_launched),
        {**kernel_line(half_rows["attention_halfblock"],
                       k5_launches + serve["k5"] + zoo_k5[768],
                       "attention_halfblock",
                       "msclip_tpu/ops/block_fused.py:132",
                       headline(half_rows["attention_halfblock"], B=256,
                                L=50, dtype="bfloat16"),
                       "B=256 L=50 E=768 H=12 bfloat16", fused_src),
         "serving_launches": serve["k5"], "zoo_launches": zoo_k5[768]},
        kernel_line(half_rows["mlp_halfblock"], 0, "mlp_halfblock",
                    "msclip_tpu/ops/block_fused.py:185",
                    headline(half_rows["mlp_halfblock"], B=256, L=50,
                             dtype="bfloat16"),
                    "B=256 L=50 E=768 F=3072 bfloat16", fused_src),
        kernel_line(half_rows["attention_halfblock_e512"], zoo_k5[512],
                    "attention_halfblock_e512",
                    "msclip_tpu/ops/block_fused.py:132",
                    headline(half_rows["attention_halfblock_e512"], B=1024,
                             L=77, dtype="bfloat16"),
                    "B=1024 L=77 E=512 H=8 bfloat16 causal", fused_src),
        kernel_line(half_rows["mlp_halfblock_e512"], 0, "mlp_halfblock_e512",
                    "msclip_tpu/ops/block_fused.py:185",
                    headline(half_rows["mlp_halfblock_e512"], B=1024, L=77,
                             dtype="bfloat16"),
                    "B=1024 L=77 E=512 F=2048 bfloat16", fused_src),
        {**kernel_line(variants, tuning_launches[0],
                       "attention_halfblock_variants",
                       "experiments/halfblock_tuning.py:51",
                       headline(variants, variant="v2", B=256, L=50,
                                dtype="bfloat16"),
                       "v2 B=256 L=50 E=768 H=12 bfloat16 tb=2", tuning_src),
         "sweep": [r for r in sweep if r["kernel"] != "core_out_halfblock"]},
        {**kernel_line(core_out, tuning_launches[1], "core_out_halfblock",
                       "experiments/halfblock_tuning.py:307",
                       headline(core_out, B=256, L=50, dtype="bfloat16"),
                       "B=256 L=50 E=768 H=12 bfloat16 tb=2", tuning_src),
         "sweep": [r for r in sweep if r["kernel"] == "core_out_halfblock"]}
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    mode = sys.argv[1:]
    if mode not in ([], ["--measure"], ["--zoo-faults"], ["--serve-split"]):
        raise SystemExit(f"chip_smoke: unknown arguments {mode}")
    if mode == ["--zoo-faults"]:
        device_and_packages()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        zoo_planted_faults()
    elif mode == ["--serve-split"]:
        device_and_packages()
        t_split = time.time()
        print(json.dumps({"serve_split": run_serve_split()}))
        log("seconds", total=round(time.time() - t_split, 1))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    else:
        main(measure=mode == ["--measure"])
