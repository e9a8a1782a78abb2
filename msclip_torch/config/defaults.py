"""Default configuration tree (a copy of ``msclip_tpu/config/defaults.py``).

The ``TPU`` node keeps its name so that configs written for the JAX
package parse unchanged; the port reads ``TPU.COMPUTE_DTYPE``,
``TPU.FOLD_BN``, ``TPU.SEED`` and, in zero-shot eval, ``TPU.INT8_EVAL``
from it, and ``TPU.USE_FUSED_BLOCK`` (eval only; refused by the train
step). Like the JAX package's tree this one has no default for that key;
``TPU`` is an open node, so a command-line override or an attribute
(``cfg.TPU.USE_FUSED_BLOCK = True``, as ``bench.py`` does) sets it.
There is no ``TPU.USE_PALLAS``: a CUDA tensor always takes the port's
kernels. The other keys mirror the reference MS-CLIP yacs defaults
(``lib/config/default.py:14-192``) key for key, so the released YAML files
(``experiments/model/*.yaml``) parse unchanged; keys the zero-shot path
does not read are inert.
"""

from __future__ import annotations

from .node import CfgNode


def get_default_config() -> CfgNode:
    c = CfgNode()
    c.BASE = [""]
    c.NAME = ""
    c.DATA_DIR = ""
    c.DIST_BACKEND = "nccl"  # inert on TPU; XLA collectives are used
    c.GPUS = (0,)
    c.MULTIPROCESSING_DISTRIBUTED = True
    c.OUTPUT_DIR = ""
    c.PIN_MEMORY = True
    c.PRINT_FREQ = 20
    c.RANK = 0
    c.VERBOSE = True
    c.WORKERS = 4
    c.LOGGING_LEVEL = 20

    c.AMP = CfgNode()
    c.AMP.ENABLED = False
    c.AMP.MEMORY_FORMAT = "nchw"

    # Inert on TPU (kept so reference YAMLs parse; see default.py:36-39).
    c.CUDNN = CfgNode()
    c.CUDNN.BENCHMARK = True
    c.CUDNN.DETERMINISTIC = False
    c.CUDNN.ENABLED = True

    c.MODEL = CfgNode(open_node=True)
    c.MODEL.NAME = "cls_hrnet"
    c.MODEL.INIT_WEIGHTS = True
    c.MODEL.PRETRAINED = None
    c.MODEL.PRETRAINED_LAYERS = ["*"]
    c.MODEL.NUM_CLASSES = 1000
    c.MODEL.SPEC = CfgNode(open_node=True)

    c.LOSS = CfgNode()
    c.LOSS.LABEL_SMOOTHING = 0.0
    c.LOSS.LOSS = "softmax"
    c.LOSS.FOCAL = CfgNode()
    c.LOSS.FOCAL.NORMALIZE = True
    c.LOSS.FOCAL.ALPHA = 1.0
    c.LOSS.FOCAL.GAMMA = 0.5

    c.DATASET = CfgNode(open_node=True)
    c.DATASET.ROOT = ""
    c.DATASET.DATASET = "imagenet"
    c.DATASET.TRAIN_SET = "train"
    c.DATASET.TEST_SET = "val"
    c.DATASET.DATA_FORMAT = "jpg"
    c.DATASET.LABELMAP = ""
    c.DATASET.TRAIN_TSV_LIST = []
    # TPU-repo extension: WebDataset-style tar shards of <key>.jpg +
    # <key>.txt pairs (paths or globs); takes precedence over TSV lists
    c.DATASET.TRAIN_SHARD_LIST = []
    c.DATASET.TEST_TSV_LIST = []
    c.DATASET.COCO = CfgNode(open_node=True)
    c.DATASET.COCO.SCALES = ["m", "l"]
    c.DATASET.COCO.BALANCE_DATA = True
    c.DATASET.LOADER = "blobfuse"
    c.DATASET.TOKEN_FILE = ""
    c.DATASET.SAMPLER = "default"
    c.DATASET.NUM_SAMPLES_CLASS = "average"
    c.DATASET.TARGET_SIZE = -1

    c.INPUT = CfgNode()
    # ImageNet statistics, NOT the OpenAI-CLIP stats (default.py:84-85) —
    # numeric-parity critical for zero-shot eval.
    c.INPUT.MEAN = [0.485, 0.456, 0.406]
    c.INPUT.STD = [0.229, 0.224, 0.225]

    c.AUG = CfgNode()
    c.AUG.RANDOM_CENTER_CROP = False
    c.AUG.SCALE = (0.08, 1.0)
    c.AUG.RATIO = (3.0 / 4.0, 4.0 / 3.0)
    c.AUG.COLOR_JITTER = [0.4, 0.4, 0.4, 0.1, 0.0]
    c.AUG.GRAY_SCALE = 0.0
    c.AUG.GAUSSIAN_BLUR = 0.0
    c.AUG.DROPBLOCK_LAYERS = [3, 4]
    c.AUG.DROPBLOCK_KEEP_PROB = 1.0
    c.AUG.DROPBLOCK_BLOCK_SIZE = 7
    c.AUG.MIXUP_PROB = 0.0
    c.AUG.MIXUP = 0.0
    c.AUG.MIXCUT = 0.0
    c.AUG.MIXCUT_MINMAX = []
    c.AUG.MIXUP_SWITCH_PROB = 0.5
    c.AUG.MIXUP_MODE = "batch"
    c.AUG.MIXCUT_AND_MIXUP = False
    c.AUG.TIMM_AUG = CfgNode(open_node=True)
    c.AUG.TIMM_AUG.USE_LOADER = False
    c.AUG.TIMM_AUG.USE_TRANSFORM = False

    c.SWA = CfgNode()
    c.SWA.ENABLED = False
    c.SWA.DEVICE = "cpu"
    c.SWA.BEGIN_EPOCH = -1
    c.SWA.LR_RATIO = 0.5
    c.SWA.ANNEAL_EPOCHS = 10
    c.SWA.ANNEAL_STRATEGY = "cos"
    c.SWA.FROZEN_BN = False

    c.TRAIN = CfgNode()
    c.TRAIN.AUTO_RESUME = True
    c.TRAIN.CHECKPOINT = ""
    c.TRAIN.LR_SCHEDULER = CfgNode(open_node=True)
    c.TRAIN.LR = 0.001
    c.TRAIN.SCALE_LR = True
    c.TRAIN.OPTIMIZER = "sgd"
    c.TRAIN.OPTIMIZER_ARGS = CfgNode(open_node=True)
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.WD = 0.0001
    c.TRAIN.WITHOUT_WD_LIST = []
    c.TRAIN.NESTEROV = True
    c.TRAIN.GAMMA1 = 0.99
    c.TRAIN.GAMMA2 = 0.0
    c.TRAIN.BEGIN_EPOCH = 0
    c.TRAIN.END_EPOCH = 100
    c.TRAIN.IMAGE_SIZE = [224, 224]
    c.TRAIN.BATCH_SIZE_PER_GPU = 32
    c.TRAIN.SHUFFLE = True
    c.TRAIN.EMA_DECAY = 0.0
    c.TRAIN.EVAL_BEGIN_EPOCH = 0
    c.TRAIN.LARC = False
    c.TRAIN.DETECT_ANOMALY = False
    c.TRAIN.CLIP_GRAD_NORM = 0.0
    c.TRAIN.SAVE_ALL_MODELS = False
    # TPU-repo extension: mid-epoch checkpoint cadence (steps; 0 = only
    # at epoch end). With AUTO_RESUME, a preempted run resumes at the
    # last step checkpoint and fast-forwards the loader past the
    # already-seen batches of that epoch.
    c.TRAIN.SAVE_EVERY_STEPS = 0

    c.TEST = CfgNode(open_node=True)
    c.TEST.BATCH_SIZE_PER_GPU = 32
    c.TEST.CENTER_CROP = True
    c.TEST.IMAGE_SIZE = [224, 224]
    c.TEST.INTERPOLATION = 2
    c.TEST.MODEL_FILE = ""
    c.TEST.REAL_LABELS = False
    c.TEST.VALID_LABELS = ""
    # TPU-repo extensions (absent in the reference):
    # SAVE_PRED: path — dump per-image predictions/labels (and logits for
    # the multilabel metrics) as an .npz in dataset order, for error
    # analysis and pipeline-agreement checks. Per-process stripe under
    # multi-host eval.
    c.TEST.SAVE_PRED = ""
    # SUBSET_CLASSES: >0 evaluates against only the first K prompt
    # classes — smoke evals and classifier-build debugging at a fraction
    # of the 1000x80 prompt cost.
    c.TEST.SUBSET_CLASSES = 0

    c.FINETUNE = CfgNode()
    c.FINETUNE.FINETUNE = False
    c.FINETUNE.USE_TRAIN_AUG = False
    c.FINETUNE.BASE_LR = 0.003
    c.FINETUNE.BATCH_SIZE = 512
    c.FINETUNE.EVAL_EVERY = 3000
    c.FINETUNE.FROZEN_LAYERS = []

    c.DEBUG = CfgNode()
    c.DEBUG.DEBUG = False

    c.USE_DEEPSPEED = False
    c.DEEPSPEED = CfgNode(open_node=True)

    # The open namespace carrying all MS-CLIP knobs (default.py:188-192).
    c.CUSTOM = CfgNode(open_node=True)
    c.CUSTOM.LR_SHARE = 0.0
    c.CUSTOM.WD_SHARE = 0.0
    c.CUSTOM.LORA_WHERE_ADD = "v0"

    # ---- TPU-native additions (not in the reference) ----
    c.TPU = CfgNode(open_node=True)
    c.TPU.COMPUTE_DTYPE = "float32"   # 'bfloat16' for production
    c.TPU.MESH_DATA = -1              # -1: all devices on the data axis
    c.TPU.MESH_MODEL = 1              # tensor-parallel axis size
    c.TPU.SHARDED_LOSS = False        # chunked global-batch InfoNCE
    c.TPU.LOSS_CHUNK = 4096           # column-block size of the sharded loss
    c.TPU.RING_LOSS = False           # ring-rotated InfoNCE (O(b*E)/chip
    #                                   embeddings at any global batch;
    #                                   needs SHARDED_LOSS)
    c.TPU.ACCUM_STEPS = 1             # >1: GradCache two-pass gradient
    #                                   accumulation (activation memory
    #                                   ~1/N at one extra forward; exact
    #                                   InfoNCE over the full batch)
    c.TPU.REMAT = False               # jax.checkpoint on trunk blocks
    c.TPU.ZERO1 = False               # shard optimizer state over 'data'
                                      # (TPU-native DeepSpeed ZeRO stage 1)
    c.TPU.FSDP = False                # shard params (+moments, inherited)
                                      # over 'data': ZeRO-3/FSDP analogue,
                                      # XLA all-gathers weights at use
                                      # (parallel/mesh.py)
    c.TPU.INT8_EVAL = False           # W8A8 trunk GEMMs at eval
                                      # (models/quantize.py; K3/K4)
    c.TPU.XLA_VMEM_KIB = 24576        # xla_tpu_scoped_vmem_limit_kib for
                                      # the train-step compile. Measured
                                      # (experiments/xla_options_sweep.py,
                                      # v5e): +1.5-1.8% b32 train, +0.5%
                                      # b16 train, neutral eval; >=64 MB
                                      # LOSES (starves Pallas kernels).
                                      # 0 disables; TPU backends only.
    c.TPU.SEED = 0                    # rng seed: init, DropPath, loaders

    return c


def update_config(config: CfgNode, cfg_file: str, opts=None, world_size: int = 1):
    """Merge a YAML file + CLI opts into ``config``.

    Replicates reference ``update_config`` (default.py:294-319): BASE
    inheritance, CLI override list, LR x world_size scaling (including
    CUSTOM.LR_SHARE / CUSTOM.GUMBEL_LR), and NAME composition.
    """
    import os.path as op

    config.merge_from_file(cfg_file)
    config.merge_from_list(opts)
    if config.TRAIN.SCALE_LR and world_size > 1:
        config.TRAIN.LR *= world_size
        if config.CUSTOM.get("LR_SHARE", 0.0):
            config.CUSTOM.LR_SHARE *= world_size
        if config.CUSTOM.get("GUMBEL_LR", 0.0):
            config.CUSTOM.GUMBEL_LR *= world_size
    file_name, _ = op.splitext(op.basename(cfg_file))
    config.NAME = file_name + config.NAME
    return config
