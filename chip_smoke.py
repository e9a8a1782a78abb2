"""Smoke run of the PyTorch/CUDA port (msclip_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

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
   instantiation without wgmma fails the run; then, in a fresh process,
   the fp32 and bf16 turns of K5, K6, E1, E2 and the hybrid against their
   yardsticks that phases 3 and 12 report (``traced_turns``: the profiler
   traced none of them in a process that had run the other phases
   first);
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
   launches counted.

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
``vs_unfused``, the ratio of their device times. A ``k5_design`` line
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
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from msclip_torch.ops import attention as A
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
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
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
    return smi


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
    spilled, serialized, no_wgmma = [], [], []
    sources = (A.SOURCE, A.BWD_SOURCE, Q.SOURCE, BF.SOURCE, HT.SOURCE)
    with cf.ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(cuda_build.build, sources))
    for source, path in zip(sources, paths):
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
        log("build", source=source, seconds=f"{time.time() - t0:.1f}",
            ptxas=json.dumps(report), **extra)
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
    E, H = BF.WIDTH, BF.WIDTH // 64
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
    ``TUNING_SHAPES``; K6 against the unfused MLP half at ``HALF_SHAPES``;
    at ``TUNING_SHAPES`` each E1 variant and the whole hybrid against the
    unfused half, E2 against K1 with the out-projection; the calls of
    :func:`halfblock_jobs`. Every call is
    made once before the first trace. ``{key: turns}``, keys as
    :func:`turn_key`. Runs in a process of its own
    (:func:`traced_turns_in_subprocess`): on the card, in a process that
    had run the other phases first (many other kernels, and
    ``torch.compile``), torch.profiler traced none of these calls; why is
    not known."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    jobs = {}
    for dtype in (torch.float32, torch.bfloat16):
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
    return {key: turns(kernel, other, n, name, per_call)
            for key, (kernel, other, n, name) in jobs.items()}


def turn_key(kind, B, L, dtype, causal=False, variant=None):
    return " ".join(str(k) for k in (
        kind, variant, B, L, str(dtype).replace("torch.", ""),
        causal and "causal") if k not in (None, False))


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


def in_turns(kernel, library, n_inputs, one_record=True, per_call=None):
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
    ``vs_library`` are None (not measured) and ``device_error`` says why."""
    per_call = {} if per_call is None else per_call
    for fn in (kernel, library):
        if fn not in per_call:
            per_call[fn] = records_per_call(fn, n_inputs)
    if one_record and per_call[kernel] is not None \
            and sum(per_call[kernel].values()) != 1:
        raise AssertionError(f"a kernel call traced {per_call[kernel]}")
    turns = []
    for fn in (library, kernel, kernel, library):
        event = cuda_ms(fn, n_inputs)
        turns.append((event, None if per_call[fn] is None else
                      device_ms(fn, n_inputs, event, per_call[fn])))

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
    ``ATTN_SHAPES``, timed in turns with SDPA and beside the plain version,
    then held, untimed, under a random mask at ``FWD_FAULT_SHAPE``."""
    from msclip_torch.models.layers import build_causal_mask

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, causal in ATTN_SHAPES:
        mask = build_causal_mask(L, device="cuda") if causal else None
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.finfo(dtype).bits // 8
            n_inputs = max(1, math.ceil(2 * L2_BYTES / (B * L * 3 * E * item)))
            qkv = [torch.randn(B, L, 3 * E, device="cuda", generator=gen)
                   .to(dtype) for _ in range(n_inputs)]
            heads = [t.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
                     for t in qkv]
            row = {
                "B": B, "L": L, "causal": causal,
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
    for B, L, causal in BWD_SHAPES:
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
                "B": B, "L": L, "causal": causal,
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


def half_params(gen, dtype, E=BF.WIDTH):
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


def staged_l2_bytes(B, L, S, boxes=True, item=2):
    """The bytes K5 stages from the L2 into shared memory at ``B`` samples
    of length ``L`` in groups of ``S``: each of a group's 16 GEMMs (12
    heads' q/k/v, four column tiles of the out-projection) stages 192
    weight rows and the group's rows, 768 values each; with ``boxes`` (the
    TMA design) the rows in whole boxes of 128, else (the mma.sync design,
    groups of ``max(1, 128 // L)``) the rows themselves."""
    full, rest = divmod(B, S)
    rows = [S * L] * full + ([rest * L] if rest else [])
    if boxes:
        rows = [128 * math.ceil(r / 128) for r in rows]
    return sum(16 * (r + 192) * 768 * item for r in rows)


def halfblock_bound(name, B, L, dtype, mask):
    """``(ms, by)``: the least time for K5 or K6, the larger of its I/O (x
    read and the output written once, the weights, LayerNorm and biases
    once, the mask) over the memory rate and its products (K5: four
    projections of ``2 L E^2`` a sample, and ``4 D`` flops per (query, key)
    pair and head the mask leaves; K6: two of ``8 L E^2``) over the peak
    rate of ``dtype``."""
    E, item = BF.WIDTH, torch.finfo(dtype).bits // 8
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


def check_halfblocks(traced):
    """K5 and K6 against their plain versions in fp32 and bf16 at the shapes
    of the fused slice (the image tower, a text chunk), B/16's and two odd
    ones, with the faults of :func:`half_with_fault` read against the same
    check, each as :func:`half_reading` gives it (the run fails unless every
    fault that changes the output is caught). Times each
    kernel, its plain version and the port's unfused half: for K5 the
    turns of :func:`traced_turns` against ``layer_norm`` + ``linear`` + K1
    + ``linear`` + residual, and the same with SDPA in K1's place; for K6
    its turns against the unfused MLP half (cuBLAS GEMMs); at the image
    shape in bf16 also ``torch.compile`` of the plain version. Logs, apart
    from the measurements, the bytes K5's groups stage from the L2 as
    :func:`staged_l2_bytes` reckons them and K6's plan (``mlp_plan``)."""
    from msclip_torch.models import layers as TL

    rows = {"attention_halfblock": [], "mlp_halfblock": []}
    gen = torch.Generator(device="cuda").manual_seed(4)
    H = BF.WIDTH // 64
    for dtype in (torch.float32, torch.bfloat16):
        p = half_params(gen, dtype)
        for B, L, causal in HALF_SHAPES:
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
                got = kernel(xs[0], *extra)
                want = plain(xs[0], *extra)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                reading, mean_reading, mean_err = half_reading(
                    got, want, xs[0], dtype)
                tol = "atol {} rtol {}".format(*HALF_TOL[dtype])
                if dtype in HALF_MEAN_TOL:
                    tol += f", mean {HALF_MEAN_TOL[dtype]} mean |plain - x|"
                if not (reading <= 1.0 and mean_reading <= 1.0
                        and torch.isfinite(got.float()).all()):
                    raise AssertionError(
                        f"{name} kernel B={B} L={L} {dtype}: max |err| {err}, "
                        f"{reading} and {mean_reading} of the limits {tol}")
                faults = {f: half_reading(half_with_fault(
                    name, xs[0], p, mask, f), want, xs[0], dtype)
                    for f in HALF_FAULTS[name] if f != "no_mask" or causal}
                missed = [f for f, (worst, mean, ferr) in faults.items()
                          if ferr > 0 and worst <= 1.0 and mean <= 1.0]
                if missed:
                    raise AssertionError(f"{name} {dtype} B={B} L={L}: the "
                                         f"check misses {missed}: {faults}")
                row = {"B": B, "L": L, "causal": causal,
                       "dtype": str(dtype).replace("torch.", ""),
                       "max_abs_err": err, "mean_abs_err": mean_err,
                       "tolerance": tol, "limit_reading": reading,
                       "mean_reading": mean_reading,
                       "planted_faults": faults,
                       "plain_ms": cuda_ms(lambda i: plain(xs[i], *extra),
                                           n_inputs, iters=10),
                       "library_ms": None}
                # K5 and the unfused half with K1, K6 and the unfused MLP
                # half, in turns, by event and device time; vs_unfused from
                # device times
                row.update(traced[turn_key(
                    "k5" if name == "attention_halfblock" else "k6", B, L,
                    dtype, causal)])
                for key, fn in baselines.items():
                    row[key] = cuda_ms(fn, n_inputs)
                if dtype == torch.bfloat16 and (B, L) == (256, 50):
                    compiled_ms_later(row, name, plain, xs, extra, n_inputs)
                row["bound_ms"], row["bound_by"] = halfblock_bound(
                    name, B, L, dtype, mask)
                log("kernel", name=name, **row,
                    bound_us=row["bound_ms"] * 1e3)
                rows[name].append(row)
            if dtype == torch.bfloat16:
                S = BF.attn_plan(B, L, dtype, BF.sm_count(0))["S"]
                log("k5_design", B=B, L=L, group=S,
                    staged_l2_gb=staged_l2_bytes(B, L, S) / 1e9,
                    staged_l2_gb_mma_sync_design=staged_l2_bytes(
                        B, L, max(1, 128 // L), boxes=False) / 1e9,
                    origin="reckoned by staged_l2_bytes, not measured")
                plan = BF.mlp_plan(B * L, dtype, BF.sm_count(0))
                log("k6_design", B=B, L=L, **{k: plan[k] for k in (
                    "big", "groups", "slots", "slot_rows")},
                    hidden_rows_gb=2 * B * L * 4 * BF.WIDTH * 2 / 1e9,
                    origin="the plan of mlp_plan; the hidden rows' bytes "
                           "written and read back, reckoned, not measured")
            del xs, j
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


def run_slice():
    """Zero-shot MS-CLIP-S B/32 at full width through the port's entry
    point, with the attention kernel's launches counted over the run."""
    from msclip_torch.eval.zero_shot import run_zero_shot

    cfg = b32_zero_shot_config()
    torch.cuda.reset_peak_memory_stats()
    A.fused_attention_qkv.launches = 0
    value, stats = run_zero_shot(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = A.fused_attention_qkv.launches
    expected = 11 * stats["n_image_batches"] + 12 * stats["n_text_chunks"]
    log("slice", model="b32-yfcc-msclips", dtype="bfloat16",
        top1=value, n_images=stats["n_images"],
        images_per_s=stats["images_per_sec"],
        classifier_s=stats["classifier_s"],
        image_batches=stats["n_image_batches"],
        text_chunks=stats["n_text_chunks"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        attention_launches=launches)
    if stats["n_images"] != 512 or not 0.0 <= value <= 100.0:
        raise AssertionError(f"zero-shot run gave {value} on "
                             f"{stats['n_images']} images")
    if launches != expected or launches == 0:
        raise AssertionError(f"attention kernel launched {launches} times, "
                             f"expected 11 x {stats['n_image_batches']} "
                             f"image batches + 12 x {stats['n_text_chunks']} "
                             f"text chunks = {expected}")
    return launches


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
    batch already on the card (CUDA events, after 2 warm-up steps)."""
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
    log("train_step", batch=batch, dtype="bfloat16", step_ms=step_ms,
        samples_per_s_resident=batch / step_ms * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches


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
    BF.fused_attention_halfblock.launches = 0
    BF.fused_mlp_halfblock.launches = 0
    HT.attention_halfblock_variant.launches = 0
    HT.core_out_halfblock.launches = 0


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
    expected = (11 * nb + 12 * nc, 22 * nb, 11 * nb)
    if launches != expected or 0 in launches:
        raise AssertionError(f"int8 slice launched (K1, K3, K4) {launches} "
                             f"times, expected {expected} for {nb} image "
                             f"batches and {nc} text chunks")
    if runs[False][0][1:] != (0, 0):
        raise AssertionError(f"the bf16 run launched K3/K4: {runs[False][0]}")

    # the model of the run: every trunk GEMM in int8; the text tower
    # (L=77 < 96) launches K1 and no quantizer
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
    if text_launches != (12, 0, 0):
        raise AssertionError(f"the int8 text tower launched (K1, K3, K4) "
                             f"{text_launches}, expected (12, 0, 0)")
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
    that is larger."""
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
    if card_launches[1:] != (22, 11):
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
    E, item = BF.WIDTH, torch.finfo(dtype).bits // 8
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


def turns(kernel, other, n_inputs, other_name, per_call=None):
    """:func:`in_turns` of a wrapper call (which may launch small casts
    beside its kernel) against ``other``, its keys renamed for ``other``:
    ``ms``, ``device_ms``, ``<other_name>_ms``,
    ``<other_name>_device_ms`` and ``vs_<other_name>`` (device over
    device)."""
    t = in_turns(kernel, other, n_inputs, one_record=False, per_call=per_call)
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
    SDPA yardstick; the turns of :func:`traced_turns` give each kernel,
    K5, the unfused half with K1, the whole hybrid and, for E2, K1 with
    the out-projection."""
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
                       **traced[key("e1", variant)]}
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
            hybrid = traced[key("hybrid")]
            row = {"B": B, "L": L, "tb": tb,
                   "dtype": str(dtype).replace("torch.", ""), **row,
                   "plain_ms": cuda_ms(lambda i: HT.core_out_plain(
                       xs[i], qkvs[i], p), n_inputs, iters=10),
                   "library_ms": None,
                   "sdpa_matmul_ms": cuda_ms(j["sdpa_matmul"], n_inputs),
                   **base, **traced[key("e2")],
                   **{"hybrid_" + k: v for k, v in hybrid.items()
                      if k != "turns_ms"}}
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


def main():
    seconds = {}
    t0 = time.time()

    def timed(phase, fn, *args, **kw):
        start = time.time()
        out = fn(*args, **kw)
        seconds[phase] = round(time.time() - start, 1)
        return out

    device_and_packages()
    timed("build", build_kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traced = timed("traced_turns", traced_turns_in_subprocess)
    attn_rows = timed("k1", check_attention)
    bwd_rows = timed("k2", check_attention_bwd)
    quant_rows = timed("k3_k4", check_quant)
    half_rows = timed("k5_k6", check_halfblocks, traced)
    launches = timed("slice", run_slice)
    timed("card_vs_cpu", card_against_cpu)
    train_launches = timed("train", run_train_slice)
    timed("train_card_vs_cpu", train_card_against_cpu)
    int8_launches = timed("int8", run_int8_slice)
    timed("int8_card_vs_cpu", int8_card_against_cpu)
    k5_launches = timed("fused", run_fused_slice)
    timed("fused_card_vs_cpu", card_against_cpu, fused=True)
    tuning_rows = timed("e1_e2", check_tuning, traced)
    tuning_launches, sweep = timed("sweep", run_tuning_sweep)
    timed("compile_baselines", run_compile_baselines)
    log("seconds", total=round(time.time() - t0, 1), phases=json.dumps(seconds))
    quant = "msclip_torch/csrc/quant.cu"
    fused_src = "msclip_torch/csrc/block_fused.cu"
    tuning_src = "msclip_torch/csrc/halfblock_tuning.cu"
    variants = tuning_rows["attention_halfblock_variants"]
    core_out = tuning_rows["core_out_halfblock"]
    print(json.dumps({"kernels": [
        kernel_line(attn_rows, launches + train_launches[0] + int8_launches[0],
                    "attention_fwd", "msclip_tpu/ops/attention.py:243",
                    headline(attn_rows, B=256, L=50, dtype="bfloat16"),
                    "B=256 L=50 E=768 H=12 bfloat16"),
        kernel_line(bwd_rows, train_launches[1], "attention_bwd",
                    "msclip_tpu/ops/attention.py:146",
                    headline(bwd_rows, B=256, L=50, dtype="bfloat16"),
                    "B=256 L=50 E=768 H=12 bfloat16"),
        kernel_line(quant_rows["ln_quant"], int8_launches[1], "ln_quant",
                    "msclip_tpu/ops/quant.py:109",
                    headline(quant_rows["ln_quant"], dtype="bfloat16"),
                    "B=256 L=197 E=768 bfloat16", quant),
        kernel_line(quant_rows["gelu_quant"], int8_launches[2], "gelu_quant",
                    "msclip_tpu/ops/quant.py:124",
                    headline(quant_rows["gelu_quant"], dtype="bfloat16"),
                    "B=256 L=197 F=3072 bfloat16", quant),
        kernel_line(half_rows["attention_halfblock"], k5_launches,
                    "attention_halfblock", "msclip_tpu/ops/block_fused.py:132",
                    headline(half_rows["attention_halfblock"], B=256, L=50,
                             dtype="bfloat16"),
                    "B=256 L=50 E=768 H=12 bfloat16", fused_src),
        kernel_line(half_rows["mlp_halfblock"], 0, "mlp_halfblock",
                    "msclip_tpu/ops/block_fused.py:185",
                    headline(half_rows["mlp_halfblock"], B=256, L=50,
                             dtype="bfloat16"),
                    "B=256 L=50 E=768 F=3072 bfloat16", fused_src),
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
    main()
