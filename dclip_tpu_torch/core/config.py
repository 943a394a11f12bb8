"""Configuration dataclasses for every pipeline stage: the port's own copy
of `dclip_tpu/core/config.py` (the same fields and defaults), so the port
imports nothing of the JAX package. The fast-path resolver is not here:
the port resolves its "auto" fields in `core/fast_paths.py`.

Replaces the reference's per-script argparse plus hardcoded in-source paths
(see the reference's training/CLIP_image_distillation.py:449-479 and
train_contrastive_teacher.py:143-145 for the pattern being replaced) with a
single typed config layer. CLI entry points parse the same public flags the
reference documents (README.md:24-57) into these dataclasses.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


# ---------------------------------------------------------------------------
# Model architecture configs (HF CLIP-compatible numerics).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    max_length: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class CLIPConfig:
    """Full dual-encoder CLIP. Matches HF `CLIPModel` numerics.

    The reference mixes model ids across stages (teacher stack B/16 at
    image_tokenizer.py:20, student L/14 at CLIP_image_distill_training.py:22,
    FAISS index B/32 at compute_faiss.py:21); here each stage names its
    preset explicitly.
    """

    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    projection_dim: int = 512
    logit_scale_init: float = 2.6592
    dtype: str = "float32"
    # "clip" (HF `CLIPModel`, `models.clip`) or "siglip" (HF `SiglipModel`,
    # `models.siglip`: tanh-GELU, no class token or projections, a
    # bidirectional text tower; the pooled width is `projection_dim`).
    family: str = "clip"

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_b_16() -> "CLIPConfig":
        return CLIPConfig(vision=CLIPVisionConfig(patch_size=16))

    @staticmethod
    def vit_l_14() -> "CLIPConfig":
        return CLIPConfig(
            text=CLIPTextConfig(hidden_size=768, num_heads=12, mlp_dim=3072),
            vision=CLIPVisionConfig(
                patch_size=14,
                hidden_size=1024,
                num_layers=24,
                num_heads=16,
                mlp_dim=4096,
            ),
            projection_dim=768,
        )

    @staticmethod
    def tiny_test() -> "CLIPConfig":
        """Small config for CPU tests: same code path, toy sizes."""
        return CLIPConfig(
            text=CLIPTextConfig(
                vocab_size=1000,
                hidden_size=32,
                num_layers=2,
                num_heads=4,
                mlp_dim=64,
                max_length=16,
                eos_token_id=999,
            ),
            vision=CLIPVisionConfig(
                image_size=32,
                patch_size=8,
                hidden_size=32,
                num_layers=2,
                num_heads=4,
                mlp_dim=64,
            ),
            projection_dim=16,
        )

    @staticmethod
    def siglip_so400m_14_384() -> "CLIPConfig":
        """SigLIP so400m/14-384 (google/siglip-so400m-patch14-384, HF
        `SiglipModel`): both towers 1152 wide, 27 layers, 16 heads of 72, MLP
        4304, tanh-GELU, LayerNorm eps 1e-6; 384-px images in patches of 14
        (729 tokens over the first 378 px); a bidirectional text tower over
        64 positions of a 32,000-id vocabulary, pooled at its last position;
        the pooled width 1152 stands for `projection_dim`. Pad and EOS id 1
        (SentencePiece `</s>`)."""
        tower = dict(hidden_size=1152, num_layers=27, num_heads=16, mlp_dim=4304,
                     layer_norm_eps=1e-6)
        return CLIPConfig(
            text=CLIPTextConfig(vocab_size=32000, max_length=64, eos_token_id=1, **tower),
            vision=CLIPVisionConfig(image_size=384, patch_size=14, **tower),
            projection_dim=1152, logit_scale_init=2.302585092994046, family="siglip")

    @staticmethod
    def tiny_siglip() -> "CLIPConfig":
        """SigLIP's equations at toy sizes for CPU tests: heads of 8, an MLP
        width that is no multiple of 32, images whose last pixels the
        patches leave out."""
        tower = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=40, layer_norm_eps=1e-6)
        return CLIPConfig(
            text=CLIPTextConfig(vocab_size=1000, max_length=16, eos_token_id=1, **tower),
            vision=CLIPVisionConfig(image_size=30, patch_size=7, **tower),
            projection_dim=32, logit_scale_init=2.302585092994046, family="siglip")

    @staticmethod
    def from_name(name: str) -> "CLIPConfig":
        table = {
            "vit-b-32": CLIPConfig.vit_b_32,
            "vit-b-16": CLIPConfig.vit_b_16,
            "vit-l-14": CLIPConfig.vit_l_14,
            "siglip-so400m-14-384": CLIPConfig.siglip_so400m_14_384,
            "tiny": CLIPConfig.tiny_test,
            "tiny-siglip": CLIPConfig.tiny_siglip,
            # HF-style aliases matching the reference's model-id strings.
            "openai/clip-vit-base-patch32": CLIPConfig.vit_b_32,
            "openai/clip-vit-base-patch16": CLIPConfig.vit_b_16,
            "openai/clip-vit-large-patch14": CLIPConfig.vit_l_14,
            "google/siglip-so400m-patch14-384": CLIPConfig.siglip_so400m_14_384,
        }
        if name not in table:
            raise ValueError(f"Unknown CLIP preset: {name!r}; have {sorted(table)}")
        return table[name]()


def model_family(cfg) -> str:
    """A dual-encoder config's family; a config without the field (the JAX
    package's `CLIPConfig`) is CLIP's."""
    return getattr(cfg, "family", "clip")


# ---------------------------------------------------------------------------
# Teacher (meta-teacher) config.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TeacherConfig:
    """PatchTextAggregation hyperparameters.

    Defaults mirror the reference (patch_text_aggregation.py:50-56): 512-d
    embeddings, 8 heads, similarity threshold 0.85, aggregation temperature
    2.0 (:243), 0.5/0.5 text/image fusion (:647).

    Static-shape additions (TPU): `max_patches` / `max_text_tokens` replace
    the reference's pad-to-batch-max (:555-620), and `mask_padding` makes
    padded slots inert in attention/aggregation (the reference lets zero-pad
    rows participate — an artifact of dynamic padding, not a modeling choice).
    """

    embed_dim: int = 512
    num_heads: int = 8
    similarity_threshold: float = 0.85
    aggregation_temperature: float = 2.0
    fusion_alpha: float = 0.5  # global = alpha*text_global + (1-alpha)*image_global
    max_patches: int = 32
    max_text_tokens: int = 77
    mask_padding: bool = True


# ---------------------------------------------------------------------------
# Training configs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. data=DP over batch, model=TP over hidden dims."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all remaining devices
    model_parallel: int = 1


@dataclass(frozen=True)
class TeacherTrainConfig:
    """Matches train_contrastive_teacher.py CLI contract (:430-440)."""

    train_file: str = ""
    val_file: str = ""  # reference derives it via "_train"->"_val" (:218)
    epochs: int = 5
    batch_size: int = 32
    gradient_accumulation: int = 1
    learning_rate: float = 1e-5  # Adam, reference :245-248
    output_path: str = "models/teacher_contrastive"
    seed: int = 42  # seed_everything(42), reference :99
    # Only params whose path matches one of these train (reference :125-134).
    trainable_patterns: Sequence[str] = (
        "cross_attn",
        "attention",
        "proj",
        "fusion",
        "final",
    )
    temperature: float = 0.05  # contrastive loss temp (reference :251)
    log_every: int = 10
    cache_sync_every: int = 100  # reference syncs KNN cache every 100 batches
    teacher: TeacherConfig = field(default_factory=TeacherConfig)
    clip_model: str = "vit-b-16"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Activation dtype for encoder forwards (params stay float32; losses
    # compute in float32). "auto" = bfloat16 on TPU (the MXU-native fast
    # path), float32 elsewhere. Resolved by `resolve_fast_paths`.
    compute_dtype: str = "auto"
    # Route the cross-attention forward through the fused Pallas kernel
    # (backward = rematerialized XLA VJP, kernels.cross_attention_trainable).
    # None = auto: on for TPU meshes (with an XLA fallback if the Pallas
    # toolchain is unavailable), off elsewhere.
    use_pallas: Optional[bool] = None
    # Crop compaction for the frozen region encode (see DistillConfig).
    # None = auto: on for single-data-shard TPU meshes.
    compact_patches: Optional[bool] = None
    # HBM-resident level-0 in front of `pe_cache` (train/device_cache.py):
    # cached gated patch embeddings gather on device instead of re-crossing
    # H2D each epoch. None = auto (on whenever a pe_cache is attached in a
    # single-process run; under dp>1 the buffer rows shard over the data
    # axis). Multihost stays on the host cache.
    device_target_cache: Optional[bool] = None
    device_cache_mb: int = 384


@dataclass(frozen=True)
class UnfreezeStage:
    """One stage of the progressive-unfreeze schedule."""

    epoch: int
    patterns: Sequence[str]


@dataclass(frozen=True)
class DistillConfig:
    """Matches CLIP_image_distill_training.py CLI contract (:47-52 plus
    CLIP_image_distillation.py:711-721).

    The reference's progressive-unfreeze hook `on_epoch_end` never fires
    under modern Lightning (SURVEY.md §3.1), so its effective behavior is
    the init-time freeze only. We keep that as the default
    (`unfreeze_schedule=()`) and expose the intended schedule as an
    explicit, configurable option.

    Model pairing: the reference loads a ViT-L/14 student (768-d,
    CLIP_image_distill_training.py:22) against a 512-d teacher
    (patch_text_aggregation.py:51) — that cosine loss is shape-incompatible
    as written (SURVEY.md §7). This build requires
    student.projection_dim == teacher.embed_dim == teacher_clip.projection_dim
    and defaults to the self-consistent B/16 stack (the teacher's actual
    encoders, image_tokenizer.py:20); use vit-l-14 everywhere with
    TeacherConfig(embed_dim=768) for an L-sized run.
    """

    train_file: str = ""
    val_file: Optional[str] = None
    train_batch_size: int = 32
    eval_batch_size: int = 32
    learning_rate: float = 2e-5  # AdamW (reference :679-682, default :717)
    warmup_steps: int = 0
    # Parsed for CLI parity; the reference also accepts --total_steps
    # (:715-717) without consuming it beyond the warmup scheduler.
    total_steps: int = 1000
    phase1_epochs: int = 2  # README.md:59 "2 epochs to prevent 0 shot decay"
    checkpoint_dir: str = "checkpoints"
    gradient_clip_val: float = 0.5  # reference Trainer(:41)
    accumulate_grad_batches: int = 4  # reference Trainer(:42)
    contrastive_weight: float = 1.0  # reference :628
    temperature: float = 0.05  # InfoNCE temp (reference :532)
    seed: int = 42
    save_top_k: int = 10  # ModelCheckpoint(save_top_k=10) (reference :27-34)
    student_model: str = "vit-b-16"
    teacher_clip_model: str = "vit-b-16"
    teacher: TeacherConfig = field(default_factory=TeacherConfig)
    # () reproduces the hook-never-fires reference behavior.
    unfreeze_schedule: Sequence[UnfreezeStage] = ()
    # Sugar for the reference's intended text unfreeze at epoch 3
    # (CLIP_image_distillation.py:753-755, dead under modern Lightning):
    # appends UnfreezeStage(epoch, ("text_model",)) to unfreeze_schedule.
    # No full_resolution knob: the reference's mid-run flip lives in the
    # same dead hook AND its full-res transform (T.ToTensor() only,
    # image_tokenizer.py:34,105-106) skips CLIP normalization and cannot
    # torch.stack variable-size crops — broken if it ever fired. The
    # supported resolution knob is --teacher_image_size.
    unfreeze_text_at_epoch: Optional[int] = None
    mesh: MeshConfig = field(default_factory=MeshConfig)
    log_every: int = 10
    # Activation dtype for encoder forwards (params stay float32; losses
    # compute in float32). "auto" = bfloat16 on TPU (the MXU-native fast
    # path), float32 elsewhere. Resolved by `resolve_fast_paths`.
    compute_dtype: str = "auto"
    # jax.checkpoint each encoder layer: trades FLOPs for HBM, enabling
    # larger per-chip batches for ViT-L/14 students.
    remat: bool = False
    # Use the Pallas kernels on the hot path: fused bidirectional
    # cross-attention for the frozen teacher targets and the fused
    # distillation loss (custom VJP). None = auto: on for TPU meshes (with
    # an XLA fallback if the Pallas toolchain is unavailable), off elsewhere.
    use_pallas: Optional[bool] = None
    # Crop compaction: run the teacher's region-encode ViT over only the
    # valid patch slots (bucketed, max ~4 compiled variants). Big win when
    # detections average well below max_patches. None = auto: on for
    # single-data-shard TPU meshes.
    compact_patches: Optional[bool] = None
    # Route the student TEXT stack's MLP blocks through the trainable
    # fused kernel trio (kernels/mlp_trainable.py). Default OFF: measured
    # slower than XLA on v5e for CLIP text shapes (S=77 rows under-fill
    # the MXU per program; the HBM traffic saved is negligible at
    # mlp=2048). The kernel exists for bandwidth-bound trainable MLPs.
    fused_text_mlp: bool = False
    # Caption sequence packing for the student text tower (ops/packing.py):
    # pack several captions' CONTENT tokens per 77-token row and encode
    # R << B rows with within-segment causal attention — reclaims the
    # FLOPs CLIP's pad-to-77 burns on padding (real captions run ~10-30
    # tokens). Numerics match the unpacked encode (parity-pinned).
    # Measured on v5e (B/16, batch 256): cache-warm 1344 img/s vs 1137
    # unpacked (+18%). None = auto: on for TPU meshes (gated at runtime to
    # single-data-shard — packed row counts are not dp-even — and to
    # host-resident ids), off elsewhere.
    packed_text: Optional[bool] = None
    # Route the student VISION tower's attention blocks through the fully
    # fused trainable kernel (LN1+QKV+attention+out_proj+residual in one
    # Pallas forward emitting the backward's saved tensors; the backward
    # reuses the stats-reusing attention kernel + XLA weight-grad GEMMs —
    # kernels/attn_block_trainable.py). Real cotangents for all weights,
    # valid under any unfreeze stage. Default OFF: MEASURED SLOWER on v5e
    # at the bench shape (cache-warm 1413 vs 1493 img/s; a full-recompute
    # backward variant measured 1416) — the per-program projection GEMMs
    # ([S=197, D] rows per grid step) under-fill the MXU that XLA's one
    # [B*S, D] x [D, D] GEMM saturates, the same effect measured for
    # fused_text_mlp. The trainable per-op path is MXU-bound, not
    # bandwidth-bound; see bench.py's ceiling notes. Opt-in for shapes
    # where that balance flips.
    fused_attn_block: Optional[bool] = None
    # Allow the TILED (weight-streaming) frozen-MLP pair where weights
    # overflow VMEM residency (ViT-L/14). Default OFF: measured slower
    # than XLA there on v5e (fwd+bwd 2.84 vs 1.85 ms at B=32) — XLA's
    # single large GEMM already runs near peak. The resident pair (B/16)
    # is unaffected by this knob and stays on.
    tiled_frozen_mlp: bool = False
    # HBM-resident level-0 teacher-target cache (train/device_cache.py):
    # cached rows gather on device instead of re-crossing H2D each epoch.
    # None = auto (on whenever a teacher_cache is attached in a
    # single-process run; under dp>1 the buffer rows shard over the data
    # axis and the byte budget is PER DEVICE). Multihost stays on the host
    # cache. Budget split below between full targets and patch embeddings.
    device_target_cache: Optional[bool] = None
    device_cache_mb: int = 512


@dataclass(frozen=True)
class RetrievalEvalConfig:
    """Matches flickr30k_eval.py CLI (:286-298)."""

    dataset_json: str = ""
    max_images: int = 1000
    model: str = "both"  # base | custom | both
    checkpoint: Optional[str] = None
    batch_size: int = 256
    clip_model: str = "vit-b-16"
    chunk_size: int = 1000  # similarity matmul chunking (reference :252-266)


@dataclass(frozen=True)
class ZeroShotEvalConfig:
    """Matches test_zero_shot_ImageNet.py / CIFAR_zeroshot.py protocol."""

    dataset: str = "cifar10"  # cifar10 | cifar100 | imagenet
    data_dir: str = ""
    model: str = "both"
    checkpoint: Optional[str] = None
    batch_size: int = 64
    clip_model: str = "vit-l-14"
    prompt_template: str = "a photo of a {}"
    results_file: Optional[str] = None


# ---------------------------------------------------------------------------
# Serialization helpers.
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def save_json(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


def _build(cls, data: dict):
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _build(ftype, v)
        else:
            # Sequence[SomeDataclass] fields (e.g. unfreeze_schedule):
            # rebuild each element, not just top-level dataclass fields.
            args = typing.get_args(ftype)
            if (
                args
                and dataclasses.is_dataclass(args[0])
                and isinstance(v, (list, tuple))
            ):
                v = tuple(
                    _build(args[0], e) if isinstance(e, dict) else e for e in v
                )
        kwargs[f.name] = v
    return cls(**kwargs)


def load_json(cls, path: str):
    with open(path) as f:
        return _build(cls, json.load(f))
