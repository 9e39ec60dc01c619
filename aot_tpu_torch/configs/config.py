"""Flat config object + composition logic.

Key names intentionally match the reference framework's public config surface
(reference: configs/default.py, configs/models/default.py) so users can port
run scripts unchanged. Values are composed as: ENGINE_DEFAULTS <- model
overrides <- stage overrides <- kwargs/CLI overrides.
"""

from __future__ import annotations

import os
from typing import Any, Dict


# ---------------------------------------------------------------------------
# Engine defaults (reference: configs/default.py:13-107)
# ---------------------------------------------------------------------------

ENGINE_DEFAULTS: Dict[str, Any] = dict(
    EXP_NAME="default",
    STAGE_NAME="YTB",
    # --- data ---
    DATASETS=["youtubevos"],
    DATA_WORKERS=8,
    # static-image aug backend: 'auto' = fused C++ kernels when
    # aot_tpu_torch/native/augkit.cpp builds, 'pil' = reference-shaped PIL chain,
    # 'native' = fail loudly if the library is unavailable
    DATA_AUG_BACKEND="auto",
    DATA_RANDOMCROP=(465, 465),  # (464, 464) when MODEL_ALIGN_CORNERS=False
    DATA_RANDOMFLIP=0.5,
    DATA_MAX_CROP_STEPS=10,
    DATA_SHORT_EDGE_LEN=480,
    DATA_MIN_SCALE_FACTOR=0.7,
    DATA_MAX_SCALE_FACTOR=1.3,
    DATA_RANDOM_REVERSE_SEQ=True,
    DATA_SEQ_LEN=5,
    DATA_DAVIS_REPEAT=5,
    DATA_RANDOM_GAP_DAVIS=12,
    DATA_RANDOM_GAP_YTB=3,
    DATA_DYNAMIC_MERGE_PROB=0.3,
    # --- pretrain chain ---
    PRETRAIN=True,
    PRETRAIN_FULL=False,  # if False, load encoder only
    PRETRAIN_MODEL="./pretrain_models/mobilenet_v2.npz",
    # --- optimization ---
    TRAIN_TOTAL_STEPS=100_000,
    TRAIN_START_STEP=0,
    TRAIN_WEIGHT_DECAY=0.07,
    TRAIN_WEIGHT_DECAY_EXCLUSIVE={},
    TRAIN_WEIGHT_DECAY_EXEMPTION=[
        "absolute_pos_embed",
        "relative_position_bias_table",
        "relative_emb_v",
        "conv_out",
    ],
    TRAIN_LR=2e-4,
    TRAIN_LR_MIN=2e-5,
    TRAIN_LR_POWER=0.9,
    TRAIN_LR_ENCODER_RATIO=0.1,
    TRAIN_LR_WARM_UP_RATIO=0.05,
    TRAIN_LR_COSINE_DECAY=False,
    TRAIN_LR_RESTART=1,
    TRAIN_LR_UPDATE_STEP=1,
    TRAIN_AUX_LOSS_WEIGHT=1.0,
    TRAIN_AUX_LOSS_RATIO=1.0,
    TRAIN_OPT="adamw",
    TRAIN_SGD_MOMENTUM=0.9,
    TRAIN_GPUS=4,  # kept for CLI parity; on TPU = number of devices in mesh
    TRAIN_BATCH_SIZE=16,
    TRAIN_TBLOG=False,
    TRAIN_TBLOG_STEP=50,
    TRAIN_LOG_STEP=20,
    TRAIN_IMG_LOG=True,
    TRAIN_TOP_K_PERCENT_PIXELS=0.15,
    TRAIN_SEQ_TRAINING_FREEZE_PARAMS=["patch_wise_id_bank"],
    TRAIN_SEQ_TRAINING_START_RATIO=0.5,
    TRAIN_HARD_MINING_RATIO=0.5,
    TRAIN_EMA_RATIO=0.1,
    TRAIN_CLIP_GRAD_NORM=5.0,
    TRAIN_SAVE_STEP=5000,
    TRAIN_MAX_KEEP_CKPT=8,
    TRAIN_RESUME=False,
    TRAIN_RESUME_CKPT=None,
    TRAIN_RESUME_STEP=0,
    TRAIN_AUTO_RESUME=True,
    TRAIN_DATASET_FULL_RESOLUTION=False,
    TRAIN_ENABLE_PREV_FRAME=False,
    TRAIN_ENCODER_FREEZE_AT=2,
    TRAIN_LSTT_EMB_DROPOUT=0.0,
    TRAIN_LSTT_ID_DROPOUT=0.0,
    TRAIN_LSTT_DROPPATH=0.1,
    TRAIN_LSTT_DROPPATH_SCALING=False,
    TRAIN_LSTT_DROPPATH_LST=False,
    TRAIN_LSTT_LT_DROPOUT=0.0,
    TRAIN_LSTT_ST_DROPOUT=0.0,
    # --- evaluation ---
    TEST_GPU_ID=0,
    TEST_GPU_NUM=1,
    TEST_FRAME_LOG=False,
    TEST_DATASET="youtubevos",
    TEST_DATASET_FULL_RESOLUTION=False,
    TEST_DATASET_SPLIT="val",
    TEST_CKPT_PATH=None,
    TEST_CKPT_STEP=None,  # None -> evaluate the latest checkpoint
    TEST_EMA=True,
    TEST_FLIP=False,
    TEST_MULTISCALE=[1],
    TEST_MIN_SIZE=None,
    TEST_MAX_SHORT_EDGE=None,
    TEST_MAX_LONG_EDGE=800 * 1.3,
    TEST_WORKERS=4,
    # --- distribution (TPU-native: mesh axes instead of NCCL) ---
    DIST_ENABLE=True,
    DIST_BACKEND="jax",  # collectives via XLA over ICI; no custom backend
    DIST_START_GPU=0,
    # --- TPU-specific knobs (no reference equivalent) ---
    # Long-term memory ring-buffer capacity in memorised frames. The
    # reference grows its memory unboundedly (aot_engine.py:291-305); static
    # shapes require a cap. Training needs ceil(SEQ_LEN / gap) + 1 at most.
    TRAIN_LONG_TERM_MEM_CAP=4,
    # At test time the cap is the INITIAL bucket only (policy 'grow').
    TEST_LONG_TERM_MEM_CAP=4,
    # When the ring is full: 'grow' (double the bucket just in time — exact
    # reference semantics of unbounded memory, aot_engine.py:291-305, at
    # O(log T) retraces), 'stop' (freeze memory), or 'fifo' (overwrite the
    # oldest slot, keeping slot 0 = reference frame pinned — bounds memory
    # AND compute for arbitrarily long videos, beyond the reference).
    TEST_LONG_TERM_MEM_POLICY="grow",
    # Frames stepped per device dispatch during eval. >1 scans K frames
    # on-device with mask feedback (engine.step_chunk): one K-frame upload
    # + one K-mask readback instead of K host round-trips, bit-identical
    # masks. Applies to single-variant (no TTA) hard-label eval over
    # label-free stretches; annotated frames always break the chunk. The
    # reference steps strictly frame-by-frame with a per-frame device sync
    # (evaluator.py:408 region).
    TEST_FRAME_CHUNK=1,
    # Batched multi-video serving (engine.step_videos): N independent
    # videos share the engine's batch axis, one dispatch advancing all of
    # them a frame — converts idle MXU into aggregate throughput (the
    # TPU-native form of the reference's multi-GPU eval queue,
    # evaluator.py:216-235). Applies to single-variant hard-label eval of
    # videos whose objects all appear in frame 0 (DAVIS-style); videos
    # with mid-stream arrivals or >MAX_OBJ_NUM objects take the scalar
    # path. Masks are identical to per-video stepping (rows of the batch
    # never interact; tests/test_video_batch.py).
    TEST_VIDEO_BATCH=1,
    # Rematerialisation of the per-frame propagation scan body. True is
    # required for batch >= 8 at 465 crops on 16 GB HBM (activations for
    # the 4 propagated frames OOM otherwise). TRAIN_REMAT_POLICY: 'nothing'
    # (full recompute, least memory) or 'dots' (keep matmul/conv outputs,
    # recompute elementwise only — faster backward if it fits).
    TRAIN_REMAT=True,
    TRAIN_REMAT_POLICY="nothing",
    # Compute dtypes. Params/optimizer always fp32.
    TRAIN_DTYPE="bfloat16",
    TEST_DTYPE="float32",
    # fp32 matmul precision (JAX >=0.9 defaults fp32 matmuls to bf16 compute;
    # 'high' = bf16x3 ~fp32 accuracy at 1/3 MXU cost, 'highest' = full fp32).
    # Only affects fp32 tensors; bf16 compute paths are unaffected.
    TEST_MATMUL_PRECISION="high",
    TRAIN_MATMUL_PRECISION="default",
    # Attention implementation: 'auto' picks the Pallas kernels on TPU and
    # the jnp oracles elsewhere; 'reference' forces the oracles.
    ATTN_IMPL="auto",
    # 'auto' dispatch crossovers. Defaults (None) keep the v5e-measured
    # constants in ops/attention.py; set these (or the matching
    # AOT_TPU_* env vars) when profiling a different TPU generation.
    ATTN_FLASH_MIN_KEYS_BF16=None,
    ATTN_FLASH_MIN_KEYS_FP32=None,
    ATTN_DENSE_LOCAL_MAX_TOKENS=None,
    # Mesh: data-parallel axis name and size (-1 = all local devices).
    MESH_DP_AXIS="data",
    MESH_DP_SIZE=-1,
    # dirs (populated by init_dir)
    DIR_ROOT="./",
    DIR_DATA="./datasets",
)


def _model_name_suffix(exp_name: str, model_name: str) -> str:
    return exp_name + "_" + model_name


class Config:
    """A flat attribute bag with dict-style access and override tracking."""

    def __init__(self, values: Dict[str, Any]):
        self.__dict__.update(values)

    # dict-ish conveniences -------------------------------------------------
    def update(self, other: Dict[str, Any]) -> "Config":
        self.__dict__.update(other)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:  # pragma: no cover
        body = ",\n  ".join(f"{k}={v!r}" for k, v in sorted(self.__dict__.items()))
        return f"Config(\n  {body}\n)"

    # directory materialisation (reference: configs/default.py:109-138) -----
    def init_dir(self, make: bool = True, keep=()) -> "Config":
        """Derive data/result directories. Keys in `keep` (explicit
        build_config overrides) are NOT rederived — an explicit
        DIR_STATIC/DIR_DAVIS/... override must win over the DIR_DATA
        derivation."""
        def setd(key, val):
            if key not in keep:
                setattr(self, key, val)

        setd("DIR_DAVIS", os.path.join(self.DIR_DATA, "DAVIS"))
        setd("DIR_YTB", os.path.join(self.DIR_DATA, "YTB"))
        setd("DIR_STATIC", os.path.join(self.DIR_DATA, "Static"))
        setd("DIR_RESULT", os.path.join(
            self.DIR_ROOT, "result", self.EXP_NAME, self.STAGE_NAME))
        setd("DIR_CKPT", os.path.join(self.DIR_RESULT, "ckpt"))
        setd("DIR_EMA_CKPT", os.path.join(self.DIR_RESULT, "ema_ckpt"))
        setd("DIR_LOG", os.path.join(self.DIR_RESULT, "log"))
        setd("DIR_TB_LOG", os.path.join(self.DIR_RESULT, "log", "tensorboard"))
        setd("DIR_IMG_LOG", os.path.join(self.DIR_RESULT, "log", "img"))
        setd("DIR_EVALUATION", os.path.join(self.DIR_ROOT, "results"))
        if make:
            for path in (
                self.DIR_RESULT,
                self.DIR_CKPT,
                self.DIR_EMA_CKPT,
                self.DIR_LOG,
                self.DIR_TB_LOG,
                self.DIR_IMG_LOG,
                self.DIR_EVALUATION,
            ):
                os.makedirs(path, exist_ok=True)
        return self


def build_model_config(model: str) -> Dict[str, Any]:
    """Resolve a model name to its config-override dict."""
    from aot_tpu_torch.configs.models import MODEL_REGISTRY

    key = model.lower()
    if key not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model '{model}'; available: {sorted(MODEL_REGISTRY)}"
        )
    return dict(MODEL_REGISTRY[key])


def build_config(
    stage: str = "ytb",
    model: str = "aott",
    exp_name: str = "default",
    make_dirs: bool = False,
    **overrides: Any,
) -> Config:
    """Compose engine defaults × model × stage × explicit overrides."""
    from aot_tpu_torch.configs.stages import STAGE_REGISTRY

    values: Dict[str, Any] = dict(ENGINE_DEFAULTS)
    values.update(build_model_config(model))

    stage_key = stage.lower()
    if stage_key not in STAGE_REGISTRY:
        raise KeyError(
            f"unknown stage '{stage}'; available: {sorted(STAGE_REGISTRY)}"
        )

    cfg = Config(values)
    cfg.EXP_NAME = _model_name_suffix(exp_name, cfg.MODEL_NAME)
    # stage entries may be callables (they can depend on prior values)
    stage_over = STAGE_REGISTRY[stage_key]
    if callable(stage_over):
        stage_over = stage_over(cfg)
    cfg.update(stage_over)

    # align-corners changes the training crop parity
    # (reference: configs/default.py:17-19)
    if not cfg.MODEL_ALIGN_CORNERS and tuple(cfg.DATA_RANDOMCROP) == (465, 465):
        cfg.DATA_RANDOMCROP = (464, 464)

    cfg.update(overrides)
    cfg.init_dir(make=make_dirs, keep=frozenset(overrides))
    return cfg
