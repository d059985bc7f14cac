"""Model / run configuration system: the port's copy of the JAX package's
``configs/base.py``.

Every architecture the port runs gets one module in ``repro_torch.configs``
exporting a ``CONFIG: ModelConfig``.  ``ModelConfig`` is a frozen dataclass
so configs are hashable and safely shareable.  The copy keeps every field
and sub-config of the reference, so that every config parses.  The fields
that steer the sharding (``fsdp``, ``dp2d``, ``seq_shard``,
``moe_path``) act under a mesh (``distributed.sharding.make_rules``, the
MoE's ``ep`` path) and do nothing without one; ``scan_layers`` shapes the
parameter tree as in the reference (stacked or a list of layers), and the
port runs both through one loop.  ``remat`` and ``remat_policy`` act under
autograd: each block then runs under ``torch.utils.checkpoint``
(``models/transformer.py``).

Shape sets (assignment): every LM arch is paired with

* ``train_4k``     seq_len=4096,    global_batch=256  -> lowers ``train_step``
* ``prefill_32k``  seq_len=32768,   global_batch=32   -> lowers ``prefill_step``
* ``decode_32k``   seq_len=32768,   global_batch=128  -> lowers ``decode_step``
  (one new token against a KV/state cache of seq_len)
* ``long_500k``    seq_len=524288,  global_batch=1    -> ``decode_step``; only
  for sub-quadratic families (ssm / hybrid / linear attention).  Full-attention
  archs skip it (recorded, see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shape sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}

# Families that can run the 524k-token decode cell (sub-quadratic sequence
# mixing).  Everything else skips `long_500k`.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # number of token groups used for local-capacity dispatch; chosen to align
    # with the data-parallel sharding so per-group gathers never cross shards.
    n_groups: int = 32


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64          # N: state size per head
    d_conv: int = 4            # depthwise causal conv width
    expand: int = 2            # d_inner = expand * d_model
    head_dim: int = 64         # P: channels per SSM head
    chunk: int = 128           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + a single weight-shared attention block
    applied every `attn_every` backbone blocks."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 128
    decay_lora: int = 64       # low-rank dim of the data-dependent decay MLP


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    # fraction of `seq_len` given to the encoder (stub audio frames); the
    # decoder gets the rest.
    encoder_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256       # stub patch embeddings prepended to text
    patch_dim: int = 1024      # raw (pre-projection) patch embedding width


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # defaults to d_model // n_heads
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # --- runtime knobs (not architecture) ---
    scan_layers: bool = True            # scan-over-layers vs python unroll
    remat: bool = True
    remat_policy: str = "nothing"       # nothing | dots | none
    dtype: str = "bfloat16"
    # grad-accumulation microbatches for train_step (1 = no accumulation)
    microbatches: int = 1
    # MoE execution path: 'tp' (scan-over-experts, FFN TP-sharded) or
    # 'ep' (shard_map all-to-all expert parallelism)
    moe_path: str = "tp"
    # attention implementation: 'einsum' | 'flash' (Pallas, TPU target)
    attn_impl: str = "einsum"
    # ZeRO-3/FSDP: additionally shard weight 'embed' dims over the data axis
    # (per-layer all-gather); required for archs whose params exceed HBM
    # under TP-only (llama4-scout: 109B total)
    fsdp: bool = False
    # FSDP-2D: batch shards over BOTH mesh axes (pure data parallel over
    # 256/512 chips); weights stay sharded over model(+data with fsdp) and
    # are all-gathered per layer (ZeRO-3).  Collectives scale with params
    # instead of activations — the winning layout for dense training at
    # large tokens/device (§Perf beyond-paper lever)
    dp2d: bool = False
    # shard activation seq dim over 'model' (sequence parallelism)
    seq_shard: bool = False
    # attention score/softmax accumulation dtype ('float32' | 'bfloat16');
    # bf16 halves the S×T score HBM traffic (§Perf lever; the Pallas flash
    # kernel removes that traffic entirely on TPU)
    attn_scores_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced version of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=16,
            microbatches=1,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(2, self.moe.top_k),
                                  capacity_factor=2.0, n_groups=2)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)
        if self.hybrid is not None:
            kw["hybrid"] = HybridConfig(attn_every=2)
            kw["n_layers"] = 4
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_dim=16, chunk=16, decay_lora=8)
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(n_encoder_layers=2, encoder_frac=0.5)
        if self.vlm is not None:
            kw["vlm"] = VLMConfig(n_patches=8, patch_dim=32)
        return self.replace(**kw)

    def supports_shape(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """(ok, reason-if-skipped)."""
        if shape.name == "long_500k" and self.family not in SUBQUADRATIC_FAMILIES:
            return False, ("full-attention family '%s': 524k-token dense KV decode "
                           "is architecturally quadratic-in-context; skipped per "
                           "DESIGN.md §Arch-applicability" % self.family)
        return True, ""
