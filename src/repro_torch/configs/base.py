"""Architecture config schema + registry.

The port's own copy of ``repro/configs/base.py``, equal in every field and
value.  One ``<arch>.py`` per assigned architecture registers an
``ArchConfig`` via ``register``.  ``reduced()`` derives the small-family
config used by smoke tests (same block structure, tiny dims).  ``remat``
selects the activation checkpointing of each block in training
(``models.transformer._remat``); serving records no graph, so it has no
effect there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ArchConfig", "register", "get", "names", "REGISTRY"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | rwkv6 | rglru_hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # attention variants
    window: int | None = None  # sliding-window attention (e.g. mixtral)
    local_window: int | None = None  # local attention in hybrid blocks
    attn_period: int | None = None  # hybrid: 1 attention block per period
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int | None = None  # per-expert hidden dim (else d_ff)
    norm_topk_prob: bool = True
    capacity_factor: float = 1.25
    # modality stub frontend: None | "vit" | "encodec"
    frontend: str | None = None
    # training-time controls (tuned per shape by the launcher)
    remat: str = "full"  # none | full | dots
    # TP head padding (§Perf): extra ZERO-INITIALIZED q-heads so the head
    # count divides the model axis (40 -> 48 etc.).  Forward-exact at init;
    # the padded heads are extra trainable capacity, like vocab padding.
    # Without it, attention falls back to context parallelism, whose
    # backward resharding dominated the collective roofline term.
    head_pad: int = 0
    # provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab rounded up to a TP-shardable multiple (256).
        Labels never reference the padding ids; serving masks them at
        sampling.  Standard Megatron/MaxText practice."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (no dense full-sequence KV at decode)."""
        return self.family in ("rwkv6", "rglru_hybrid") or self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, hd = self.d_model, self.hd
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        if self.qkv_bias:
            qkv += self.n_heads * hd + 2 * self.n_kv_heads * hd
        attn = qkv + (self.n_heads * hd) * d
        if self.family == "rwkv6":
            # r,k,v,w,g projections + output + loras + channel mix (~)
            attn = 6 * d * d + 2 * d * (3 * self.d_ff // 2)
            ffn = 0
            per_layer = attn + 2 * d  # norms
            # channel mix included in attn term above (approx)
        elif self.family == "moe":
            shared = self.n_shared_experts * (self.moe_d_ff or self.d_ff)
            e_ff = self.moe_d_ff or self.d_ff
            ffn = self.n_experts * 3 * d * e_ff + 3 * d * shared + d * self.n_experts
            per_layer = attn + ffn + 2 * d
        else:
            ffn = 3 * d * self.d_ff
            per_layer = attn + ffn + 2 * d
        if self.family == "rglru_hybrid":
            # recurrent blocks replace attention in (period-1)/period of layers
            rec = 3 * d * self.d_ff  # approx: gated MLP-ish recurrent block
            period = self.attn_period or 3
            n_attn = self.n_layers // period
            n_rec = self.n_layers - n_attn
            total_blocks = n_attn * (attn + 3 * d * self.d_ff) + n_rec * (
                rec + 3 * d * self.d_ff
            )
            total = total_blocks + 2 * self.n_layers * d
        else:
            total = self.n_layers * per_layer
        total += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * e_ff * self.n_layers
        return int(self.param_count() - inactive)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = self.attn_period
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            n_layers=max(2, period or 2) if period is None else 2 * period,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            moe_d_ff=32 if self.moe_d_ff else None,
            vocab_size=512,
            head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 16) if self.window else None,
            local_window=min(self.local_window, 16) if self.local_window else None,
            remat="none",
        )


REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        # import the configs package to populate the registry lazily
        from . import _load_all  # noqa

        _load_all()
    return REGISTRY[name]


def names() -> list[str]:
    from . import _load_all  # noqa

    _load_all()
    return sorted(REGISTRY)
