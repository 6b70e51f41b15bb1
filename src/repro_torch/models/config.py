"""Architecture and run configuration of the port's LM path.

A copy of ``src/repro/models/config.py`` (the port imports nothing of the
JAX package): :class:`ArchConfig` carries the published architecture
hyperparameters, :class:`RunConfig` the deployment knobs the serving and
training paths read (parameter dtype, the implementation of each kernel:
``"cuda"``, the hand-written CUDA kernel, or ``"ref"``, its plain PyTorch
version, the MoE capacity factor, and the reference's training fields:
rematerialisation, microbatches, the loss chunk and z-loss, the optimiser
and its schedule).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

IMPLS = ("cuda", "ref")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window attention
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    # hybrid (Zamba2): one shared attention block applied every k ssm layers
    attn_every: int = 0
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # vlm / audio stub frontend
    n_patches: int = 0
    source_len: int = 0
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-context decode cell?"""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (H + 2 * Hkv) * Dh + H * Dh * D
        if self.qkv_bias:
            attn += (H + 2 * Hkv) * Dh
        mlp = 3 * D * F
        moe = 0
        if self.is_moe:
            moe = self.n_experts * 3 * D * F + D * self.n_experts
            mlp = 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            din = self.ssm_expand * D
            nh = din // self.ssm_head_dim
            dconv_in = din + 2 * self.ssm_groups * self.ssm_state
            proj = D * (2 * din + 2 * self.ssm_groups * self.ssm_state + nh)
            ssm = proj + self.ssm_conv * dconv_in + dconv_in + 3 * nh + din + din * D
        emb = V * D * (1 if self.tie_embeddings else 2)
        norms = 2 * D * self.n_layers + D
        if self.family == "moe":
            total = self.n_layers * (attn + moe)
        elif self.family == "ssm":
            total = self.n_layers * ssm
        elif self.family == "hybrid":
            total = self.n_layers * ssm + (attn + mlp)  # shared block counted once
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp)
            dec = self.n_dec_layers * (2 * attn + mlp)  # self + cross
            total = enc + dec
        else:                                           # dense, vlm
            total = self.n_layers * (attn + mlp)
        return int(total + emb + norms)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        full_moe = self.n_layers * self.n_experts * 3 * D * F
        active_moe = self.n_layers * self.top_k * 3 * D * F
        return int(self.param_count() - full_moe + active_moe)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # the reference's defaults: bf16 parameters (the LM kernels take them
    # as bf16 storage, f32 compute); compute_dtype is read nowhere, as in
    # the reference, and so takes only the reference's default or
    # param_dtype (a reference RunConfig's value, never a silent setting)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "cuda"          # cuda | ref
    ssd_impl: str = "cuda"
    conv_impl: str = "cuda"
    capacity_factor: float = 1.25    # MoE expert capacity over the even share
    # training (the reference's fields and defaults)
    remat: bool = True               # recompute each block in the backward
    remat_policy: str = "full"       # full | dots (dots: ROADMAP queue 1, item 9)
    n_microbatch: int = 1            # gradient-accumulation microbatches
    loss_chunk: int = 512
    z_loss: float = 0.0
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 1000

    def __post_init__(self):
        for f in ("attn_impl", "ssd_impl", "conv_impl"):
            if getattr(self, f) not in IMPLS:
                raise ValueError(f"{f} must be one of {IMPLS}, got {getattr(self, f)!r}")
        if self.compute_dtype not in ("bfloat16", self.param_dtype):
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is read nowhere (the kernels compute "
                "in float32, the rest at param_dtype): it must be 'bfloat16' or param_dtype "
                f"({self.param_dtype!r})")


SMOKE_OVERRIDES = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, n_patches=4, source_len=8,
)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (the reference's rule)."""
    kw = dict(SMOKE_OVERRIDES)
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=2)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_dec_layers=2)
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = kw["n_heads"]
    if cfg.window is not None:
        kw["window"] = 16
    return dataclasses.replace(cfg, **kw)
