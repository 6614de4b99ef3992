"""Architecture configuration: the fields the ported families read.

The JAX package's ``ArchConfig`` describes every family it supports; the
port carries what its families read, under the same names, so a config
reads the same in both packages. Families:
  dense  — llama-style decoder (GQA + RoPE + SwiGLU or variants)
  moe    — dense skeleton with a mixture-of-experts FFN (top-k routing)
  ssm    — RWKV6 "Finch" (attention-free, data-dependent decay)
  hybrid — Hymba (parallel attention + mamba heads per layer)
  audio  — Whisper encoder-decoder backbone (conv frontend stubbed)
  vlm    — InternVL2: stubbed patch embeddings, projected and prepended
           to the token embeddings
  mlp    — the paper's own 256-128-64 anomaly-detection MLP
``expert_parallel`` and ``client_axes`` are read by the sharding rules
(``launch/sharding.py``) and the mesh's client count
(``launch/mesh.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm|mlp
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    source: str = ""                 # citation for the config

    # attention / norm variants -------------------------------------------
    qkv_bias: bool = False
    attention_impl: str = "full"     # full | blockwise (the flash kernel)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp_act: str = "swiglu"          # swiglu | gelu
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # partial rotary (stablelm uses 0.25)
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None

    # moe ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False       # arctic: dense FFN in parallel
    moe_dispatch: str = "gather"           # gather | scatter (one function)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01        # load-balance loss weight

    # distribution -----------------------------------------------------------
    expert_parallel: bool = False    # shard expert dim over client ("data") axis
    client_axes: Tuple[str, ...] = ("pod", "data")  # mesh axes hosting FL clients

    # ssm / hybrid -----------------------------------------------------------
    ssm_state: int = 0               # mamba state size (hymba) / 0
    rwkv_head_dim: int = 64          # RWKV6 WKV head size
    rwkv_lora_dim: int = 32          # ddlerp / decay LoRA rank

    # audio / vlm stubs ------------------------------------------------------
    encoder_layers: int = 0          # whisper encoder depth
    encoder_seq: int = 1500          # whisper: 30 s -> 1500 frames
    num_patches: int = 256           # vlm: stubbed patch embeddings

    # mlp detector -----------------------------------------------------------
    mlp_hidden: Tuple[int, ...] = ()
    num_features: int = 0
    num_classes: int = 0
    dropout: float = 0.0             # the paper's; training applies none

    # numerics -----------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True               # checkpoint each layer in training
    optimizer: str = "adamw"         # adamw | adafactor (large archs)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as the JAX package's
        embedding and LM head use it (labels never reference pad ids)."""
        v = self.vocab_size
        return v if v % 256 == 0 else (v // 256 + 1) * 256

    @property
    def q_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (the JAX package's formula, approximate
        for the ssm and hybrid families as it is there); ``active_only``
        counts the top-k experts only."""
        if self.family == "mlp":
            dims = ((self.num_features,) + tuple(self.mlp_hidden)
                    + (self.num_classes,))
            return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        d, ff, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd, H, K = self.hd, self.num_heads, self.num_kv_heads
        attn = d * H * hd + 2 * d * K * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * K) * hd
        if self.mlp_act == "swiglu":
            ffn = 3 * d * ff
        else:
            ffn = 2 * d * ff + ff + d
        norms = 2 * d
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            heads = d // self.rwkv_head_dim
            lora = self.rwkv_lora_dim
            tmix = 4 * d * d + d  # r,k,v,g,o projections (g folded) approx
            tmix += 5 * (d * lora + lora * d) + 6 * d  # ddlerp loras + mus
            tmix += d * lora + lora * d + d + heads * self.rwkv_head_dim
            cmix = d * ff + ff * d + 2 * d
            return L * (tmix + cmix + norms) + emb + d
        if self.family == "hybrid":
            dd = d  # mamba inner dim == d_model (parallel-heads design)
            mamba = d * 2 * dd + dd * (2 * self.ssm_state + dd // 16) \
                + dd * self.ssm_state + dd + dd * d + 4 * dd
            return L * (attn + mamba + ffn + 3 * d) + emb + d
        if self.family == "audio":
            enc = self.encoder_layers * (attn + ffn + norms)
            dec = L * (2 * attn + ffn + 3 * d)  # self + cross attention
            return enc + dec + emb + 2 * d
        if self.family == "moe":
            experts = (self.top_k if active_only else self.num_experts)
            router = d * self.num_experts
            dense_res = 3 * d * ff if self.moe_dense_residual else 0
            per_layer = attn + experts * 3 * d * ff + router + dense_res + norms
            return L * per_layer + emb + d
        if self.family == "vlm":
            return L * (attn + ffn + norms) + emb + d + d * d  # projector
        return L * (attn + ffn + norms) + emb + d
