"""ModelConfig — the single config object consumed by models/, launch/, serve/.

A copy of the reference's `repro.configs.base.ModelConfig` (same fields,
same defaults, same derived properties), so a config built here equals
the reference's field by field, plus the port's own fields (`PORT_FIELDS`:
YaRN on the global layers), whose defaults leave every configuration of
the reference's registry as it computes. One instance per architecture
the port runs lives in `configs/<id>.py`, with a reduced `smoke()`
variant for CPU tests.

`capacity_factor <= 0` asks for dropless routing (`models.moe`): every
token's top-k pairs are computed, none is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN rotary scaling of one layer (`models.common.rope_frequencies`
    reads it where a plain theta would stand)."""

    theta: float
    factor: float
    original_context: int
    beta_fast: float
    beta_slow: float
    attention_factor: float


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # attention
    qkv_bias: bool = False
    sliding_window: int = 0       # window for "local" layers (0 = none)
    local_global_ratio: int = 0   # e.g. 5 -> 5 local : 1 global (gemma3)
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / recurrent
    ssm_state: int = 0            # mamba2 N
    ssm_expand: int = 2
    ssm_heads: int = 0            # mamba2 H (P = d_inner // H)
    ssm_conv: int = 4
    attn_every: int = 0           # zamba2: shared attn after every k-th layer
    slstm_every: int = 0          # xlstm: sLSTM at every k-th layer
    block_kind: str = "attn"      # attn | mamba | xlstm

    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # embeddings / head
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    act: str = "silu"             # activation inside the FFN
    mlp_kind: str = "swiglu"      # swiglu (3 mats) | plain (2 mats)

    # modality frontend stub (vlm/audio): input_specs() provides embeddings
    frontend: str = "none"        # none | vision_stub | audio_stub
    frontend_tokens: int = 0      # embedding positions supplied by the stub

    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # paper technique: PIM bit-plane quantized serving
    quantize_serving: bool = False
    quant_bits: int = 8
    quant_group: int = 1

    # port-only: YaRN (NTK-by-parts) rotary scaling on the global layers
    # (`window_schedule` gives them the whole sequence; every layer where
    # there is no window); 0 = plain RoPE at `rope_theta` everywhere
    yarn_factor: float = 0.0
    yarn_original_context: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.0

    # ----- derived -----------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_head_dim(self) -> int:
        return self.d_inner // max(self.ssm_heads, 1)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or mostly-local) archs run long_500k."""
        return (
            self.block_kind in ("mamba", "xlstm")
            or self.local_global_ratio > 0
        )

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path

    def window_schedule(self, seq_len: int) -> List[int]:
        """Per-layer attention window (seq_len = global/full attention)."""
        if self.local_global_ratio <= 0 or self.sliding_window <= 0:
            return [seq_len] * self.n_layers
        r = self.local_global_ratio
        return [
            seq_len if (i % (r + 1)) == r else min(self.sliding_window, seq_len)
            for i in range(self.n_layers)
        ]

    @property
    def dropless(self) -> bool:
        """MoE routing computes every pair (`capacity_factor <= 0`)."""
        return self.capacity_factor <= 0

    def layer_rope(self, l: int):
        """Layer `l`'s rotary spec: `rope_theta`, or a `Yarn` on a global
        layer when `yarn_factor` is set."""
        if self.yarn_factor <= 0 or not self.is_global(l):
            return self.rope_theta
        return Yarn(self.rope_theta, self.yarn_factor,
                    self.yarn_original_context, self.yarn_beta_fast,
                    self.yarn_beta_slow, self.yarn_attention_factor)

    def is_global(self, l: int) -> bool:
        """Layer `l` attends over the whole sequence (`window_schedule`)."""
        if self.local_global_ratio <= 0 or self.sliding_window <= 0:
            return True
        r = self.local_global_ratio
        return l % (r + 1) == r

    def layer_flags(self) -> Dict[str, List[bool]]:
        """Per-layer structure flags for heterogeneous stacks."""
        n = self.n_layers
        flags = {
            "is_slstm": [False] * n,
            "has_shared_attn": [False] * n,
        }
        if self.slstm_every > 0:
            flags["is_slstm"] = [(i % self.slstm_every) == self.slstm_every - 1
                                 for i in range(n)]
        if self.attn_every > 0:
            flags["has_shared_attn"] = [(i % self.attn_every) == self.attn_every - 1
                                        for i in range(n)]
        return flags

    def validate(self) -> None:
        assert self.d_model % self.n_heads == 0 or self.head_dim, self.name
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name
        if self.n_experts:
            assert 0 < self.top_k <= self.n_experts, self.name
        if self.block_kind == "mamba":
            assert self.ssm_heads > 0 and self.ssm_state > 0, self.name


#: `ModelConfig` fields the reference's config does not have
PORT_FIELDS = ("yarn_factor", "yarn_original_context", "yarn_beta_fast",
               "yarn_beta_slow", "yarn_attention_factor")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §4)"
    return True, ""
