"""Typed configuration objects: model architectures, serving and the JALAD
decoupling engine (the port's own copy of the reference's dataclasses).

``ModelConfig`` keeps the reference's fields, order and defaults exactly:
its ``repr`` is part of the predictor-table cache key, so a table file
built by either package is found by the other.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Architecture families. "cnn" covers the paper's own VGG/ResNet testbed.
FAMILIES = ("dense", "moe", "ssm", "vlm", "audio", "hybrid", "cnn")


@dataclass(frozen=True)
class ModelConfig:
    """A complete architecture description.

    One instance per assigned architecture lives in ``repro_torch.configs.<id>``.
    ``reduced()`` derives the CPU smoke-test variant of the same family.
    """

    arch_id: str
    family: str                      # one of FAMILIES
    source: str = ""                 # citation (arXiv / hf model card)

    # Transformer trunk.
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # Attention flavour.
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    rope_kind: str = "rope"          # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    attention_window: int = 0        # 0 -> full causal; >0 -> sliding window
    # Sliding window applied only for the long_500k shape when
    # ``window_only_for_long`` (keeps other shapes paper-exact full attn).
    window_only_for_long: bool = True

    # Norm flavour.
    norm_kind: str = "rmsnorm"       # "rmsnorm" | "layernorm" | "nonparametric"
    tie_embeddings: bool = False

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # 0 -> d_ff
    router_aux_loss: float = 0.01

    # SSM / hybrid.
    ssm_state_dim: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # Block pattern string, e.g. "m"*48 for pure mamba/mLSTM,
    # "mmmmmmms"*6 for xlstm 7:1, zamba uses shared-attn markers "A".
    block_pattern: str = ""
    shared_attention_every: int = 0  # zamba2: shared attn block period

    # Encoder-decoder (audio / seamless).
    num_encoder_layers: int = 0
    encoder_is_stub_input: bool = False   # encoder consumes precomputed frames

    # VLM.
    num_vision_tokens: int = 0       # stub patch embeddings prepended
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t,h,w split of head_dim/2

    # CNN family (paper testbed).
    cnn_spec: str = ""               # "vgg16" | "vgg19" | "resnet50" | "resnet101"
    image_size: int = 224
    num_classes: int = 1000

    # Numerics.
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # Execution knobs (not architecture): per-block rematerialization and
    # scan unrolling. ``scan_unroll`` exists for the dry-run/roofline —
    # XLA's cost_analysis counts a while-loop body ONCE, so the layer scans
    # must be unrolled for faithful FLOP/collective accounting.
    block_remat: bool = False
    scan_unroll: bool = False
    # JALAD-quantized KV cache: 16 = bf16 (off); 8 = int8 codes + per
    # (position, kv-head) float32 scales (the paper's min-max quantizer
    # applied to the decode-time boundary data). Halves the dominant
    # memory term of decode shapes.
    kv_cache_bits: int = 16

    # ----------------------------------------------------------------- helpers
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/flavour, tiny dims.

        <=2 layers (per stack), d_model<=512, <=4 experts, small vocab.
        """
        d_model = min(self.d_model, 256) or 256
        heads = min(self.num_heads, 4) or 4
        kv = max(1, min(self.num_kv_heads, heads))
        # Keep GQA grouping: kv must divide heads.
        while heads % kv:
            kv -= 1
        pattern = self.block_pattern[:2] if self.block_pattern else ""
        return self.replace(
            num_layers=min(self.num_layers, 2) if self.num_layers else 0,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            moe_d_ff=min(self.moe_d_ff_, 512) if self.num_experts else 0,
            ssm_state_dim=min(self.ssm_state_dim, 16) if self.ssm_state_dim else 0,
            block_pattern=pattern,
            shared_attention_every=(2 if self.shared_attention_every else 0),
            num_encoder_layers=min(self.num_encoder_layers, 2)
            if self.num_encoder_layers
            else 0,
            num_vision_tokens=min(self.num_vision_tokens, 16)
            if self.num_vision_tokens
            else 0,
            mrope_sections=(8, 12, 12),
            image_size=32,
            num_classes=16,
            dtype="float32",
            param_dtype="float32",
        )


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 2048
    prefill_chunk: int = 512
    kv_cache_bits: int = 16          # 16 = bf16; 8/4 -> JALAD-quantized cache
    seed: int = 0


# ---------------------------------------------------------------------------
# JALAD decoupling engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceProfile:
    """FMAC latency model of one device: T = w * Q / F  (paper Sec. IV-A)."""

    name: str
    flops: float                     # peak FLOP/s
    w: float = 1.0                   # fitted multiplier

    def exec_time(self, fmacs: float) -> float:
        # Q counts FMACs; 1 FMAC = 2 FLOPs, but the paper feeds FMACs into
        # Q/F directly with the fitted w absorbing the factor. We follow the
        # paper: T = w * Q / F with Q in FMACs.
        return self.w * fmacs / self.flops


# Paper constants (Sec. IV-A).
CLOUD_1080TI = DeviceProfile("nvidia-1080ti-cloud", 12e12, 2.1761)
EDGE_TX2 = DeviceProfile("nvidia-tegra-x2", 2e12, 1.1176)
EDGE_TK1 = DeviceProfile("nvidia-tegra-k1", 300e9, 1.1176)
# Mid-tier edge server (three-tier topology): a desktop-class GPU racked at
# the basestation/MEC site, between the Tegra devices and the 1080Ti cloud.
EDGE_SERVER_1060 = DeviceProfile("nvidia-1060-edge-server", 4.4e12, 2.1761)


@dataclass(frozen=True)
class TierPowerModel:
    """Active-power model of the three-tier path (device → edge server →
    cloud). The per-request energy of a plan is

        E = p_dev·T_dev + p_es·T_es + p_cl·T_cl
            + p_tx1·(S1/BW1) + p_tx2·(S2/BW2)   [joules]

    i.e. per-tier compute watts times per-tier execution time, plus the
    radio/NIC watts times each link's transfer time (the MCC-scheduling
    per-core + per-link power model, applied to JALAD's split execution).
    """

    device_w: float = 5.0            # Tegra-class SoC under load
    edge_server_w: float = 70.0      # desktop GPU at the MEC site
    cloud_w: float = 250.0           # datacenter GPU
    tx1_w: float = 1.3               # device radio while uplinking
    tx2_w: float = 4.0               # edge-server backhaul NIC


@dataclass(frozen=True)
class JaladConfig:
    """Configuration of the decoupling decision problem."""

    bits_choices: Tuple[int, ...] = (2, 3, 4, 5, 6, 8, 16)
    # Boundary codecs the ILP may choose between (registry ids from
    # ``repro_torch.codec``). The decision variable is the full (point, bits,
    # codec) triple — the wire format is part of the split decision.
    codec_choices: Tuple[str, ...] = ("huffman", "bitpack", "perchannel")
    accuracy_drop_budget: float = 0.10       # Δα
    bandwidth_bytes_per_s: float = 1e6       # BW (1 MB/s default, paper)
    edge: DeviceProfile = EDGE_TX2
    cloud: DeviceProfile = CLOUD_1080TI
    calibration_samples: int = 64
    # Channel removal (RL bandit) options.
    channel_removal: bool = False
    channel_removal_budget: float = 0.25     # max fraction of channels dropped
    # --- three-tier extension (device → edge server → cloud) ---
    # Middle-tier compute and the second (edge-server → cloud) link. The
    # two-tier fields above keep their meaning: ``edge`` is the device tier,
    # ``bandwidth_bytes_per_s`` the first (device → edge-server) link.
    edge_server: DeviceProfile = EDGE_SERVER_1060
    bandwidth2_bytes_per_s: float = 20e6     # LAN/backhaul uplink
    power: TierPowerModel = TierPowerModel()
    # Energy objective weight λ (seconds per joule): the planner minimizes
    # Z = T + λ·E. λ = 0 keeps the pure-latency objective bitwise intact.
    energy_weight: float = 0.0
    # Optional hard per-request energy cap (joules); None = unconstrained.
    energy_budget_j: Optional[float] = None
