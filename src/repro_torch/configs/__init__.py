"""Architecture registry of the port (port of ``repro.configs``, all ten of
its archs: the dense decoders internlm2-1.8b, qwen3-4b, chatglm3-6b,
gemma2-2b, the MoE decoders phi3.5-moe-42b-a6.6b and mixtral-8x7b, the
recurrent xlstm-125m and hymba-1.5b, and the modality-stub archs
whisper-large-v3 (encoder-decoder) and qwen2-vl-2b (embeds input, M-RoPE))
and the reduced CPU-scale config of the same family."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.models import LayerSpec, ModelConfig

__all__ = ["ARCHS", "get_config", "reduced_config", "cut_depth", "ShapeSpec", "SHAPES",
           "LONG_CONTEXT_ARCHS", "cell_is_runnable"]


def internlm2_1_8b() -> ModelConfig:
    """internlm2-1.8b [arXiv:2403.17297]: 24L d_model=2048 16H (GQA kv=8)
    d_ff=8192 vocab=92544 (``repro/configs/internlm2_1_8b.py``)."""
    return ModelConfig(
        name="internlm2-1.8b",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        blocks=(LayerSpec("dense", 0),) * 24,
    )


def qwen3_4b() -> ModelConfig:
    """qwen3-4b [hf:Qwen/Qwen3-4B]: 36L d_model=2560 32H (GQA kv=8)
    d_ff=9728 vocab=151936; per-head q/k RMS normalization (qk_norm),
    head_dim=128 (projection wider than d_model) (``repro/configs/qwen3_4b.py``)."""
    return ModelConfig(
        name="qwen3-4b",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        blocks=(LayerSpec("dense", 0),) * 36,
    )


def chatglm3_6b() -> ModelConfig:
    """chatglm3-6b [arXiv:2406.12793]: 28L d_model=4096 32H (GQA kv=2)
    d_ff=13696 vocab=65024; 2d RoPE (rotary on the first half of head_dim),
    GQA with 2 kv groups (``repro/configs/chatglm3_6b.py``)."""
    return ModelConfig(
        name="chatglm3-6b",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        rope_variant="rope2d",
        blocks=(LayerSpec("dense", 0),) * 28,
    )


GEMMA2_WINDOW = 4096


def gemma2_2b() -> ModelConfig:
    """gemma2-2b [arXiv:2408.00118]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
    vocab=256000; alternating local(4096)/global attention, attention-logit
    softcap 50, final-logit softcap 30, sandwich (pre+post) norms, tied
    embeddings, GeGLU. head_dim=256 (``repro/configs/gemma2_2b.py``)."""
    return ModelConfig(
        name="gemma2-2b",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        tie_embeddings=True,
        act="gelu",
        blocks=(LayerSpec("dense", GEMMA2_WINDOW), LayerSpec("dense", 0)) * 13,
    )


def phi35_moe() -> ModelConfig:
    """phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 32L
    d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2,
    full attention (``repro/configs/phi35_moe.py``)."""
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        top_k=2,
        blocks=(LayerSpec("moe", 0),) * 32,
    )


MIXTRAL_WINDOW = 4096


def mixtral_8x7b() -> ModelConfig:
    """mixtral-8x7b [arXiv:2401.04088]: 32L d_model=4096 32H (GQA kv=8)
    d_ff=14336 vocab=32000, MoE 8 experts top-2, sliding-window attention
    (window 4096) on every layer, rope_theta 1e6
    (``repro/configs/mixtral_8x7b.py``)."""
    return ModelConfig(
        name="mixtral-8x7b",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        top_k=2,
        rope_theta=1e6,
        blocks=(LayerSpec("moe", MIXTRAL_WINDOW),) * 32,
    )


def xlstm_125m() -> ModelConfig:
    """xlstm-125m [arXiv:2405.04517]: 12L d_model=768 4H vocab=50304, d_ff=0
    (the projections live inside the xLSTM blocks); three mLSTM blocks then
    one sLSTM block, repeated: one scan unit of period 4
    (``repro/configs/xlstm_125m.py``)."""
    return ModelConfig(
        name="xlstm-125m",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        blocks=(LayerSpec("mlstm", 0), LayerSpec("mlstm", 0),
                LayerSpec("mlstm", 0), LayerSpec("slstm", 0)) * 3,
    )


HYMBA_WINDOW = 1024
HYMBA_GLOBAL_LAYERS = (0, 15, 31)


def hymba_1_5b() -> ModelConfig:
    """hymba-1.5b [arXiv:2411.13676]: 32L d_model=1600 25H (GQA kv=5,
    head_dim 64) d_ff=5504, ssm_state=16, vocab=32001; every block runs
    attention and Mamba/SSD heads in parallel and averages their rescaled
    outputs; layers 0, 15, 31 attend globally, the rest in a window of 1024
    (aperiodic: five scan units of runs) (``repro/configs/hymba_1_5b.py``)."""
    return ModelConfig(
        name="hymba-1.5b",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        blocks=tuple(LayerSpec("hymba", 0 if i in HYMBA_GLOBAL_LAYERS else HYMBA_WINDOW)
                     for i in range(32)),
    )


def whisper_large_v3() -> ModelConfig:
    """whisper-large-v3 [arXiv:2212.04356]: 32 encoder + 32 decoder layers,
    d_model=1280 20H d_ff=5120 vocab=51866, LayerNorm, ungated tanh-gelu
    MLP, sinusoidal positions, tied embeddings; the conv audio frontend is a
    stub: inputs are precomputed frames (B, frames, d_model)
    (``repro/configs/whisper_large_v3.py``)."""
    return ModelConfig(
        name="whisper-large-v3",
        num_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        family="encdec",
        norm_type="layernorm",
        rope_variant="none",
        act="gelu",
        gated_mlp=False,
        tie_embeddings=True,
        blocks=(LayerSpec("dec", 0),) * 32,
        encoder_blocks=(LayerSpec("enc", 0),) * 32,
    )


def qwen2_vl_2b() -> ModelConfig:
    """qwen2-vl-2b [arXiv:2409.12191]: 28L d_model=1536 12H (GQA kv=2)
    d_ff=8960 vocab=151936; M-RoPE with (t, h, w) sections (16, 24, 24) over
    head_dim=128, tied embeddings; the vision frontend is a stub: inputs are
    patch embeddings (B, S, d_model) and 3-stream positions
    (``repro/configs/qwen2_vl_2b.py``)."""
    return ModelConfig(
        name="qwen2-vl-2b",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        rope_variant="mrope",
        mrope_sections=(16, 24, 24),
        input_mode="embeds",
        tie_embeddings=True,
        blocks=(LayerSpec("dense", 0),) * 28,
    )


ARCHS: Dict[str, Callable[[], ModelConfig]] = {
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "mixtral-8x7b": mixtral_8x7b,
    "chatglm3-6b": chatglm3_6b,
    "gemma2-2b": gemma2_2b,
    "qwen3-4b": qwen3_4b,
    "internlm2-1.8b": internlm2_1_8b,
    "whisper-large-v3": whisper_large_v3,
    "xlstm-125m": xlstm_125m,
    "qwen2-vl-2b": qwen2_vl_2b,
    "hymba-1.5b": hymba_1_5b,
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs a bounded decode state (sub-quadratic or windowed archs).
LONG_CONTEXT_ARCHS = ("mixtral-8x7b", "xlstm-125m", "hymba-1.5b")


def cell_is_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) dry-run cell."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode state unbounded"
    return True, ""


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port has: {sorted(ARCHS)}")
    return ARCHS[name]()


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg``'s first ``layers`` decoder layers, its width kept."""
    return dataclasses.replace(cfg, num_layers=layers, blocks=cfg.blocks[:layers])


def reduced_config(name: str) -> ModelConfig:
    """Small same-family config for CPU runs (the reference's
    ``reduced_config``): <= 4 layers (windows cut to <= 16, so gemma2 keeps
    its (16, 0) pattern) and <= 2 encoder layers, d_model 64, <= 4 heads of
    16, d_ff 256 (kernel-eligible mlp and expert leaves), vocab 512, <= 4
    experts in groups of 64 tokens, ssm_state <= 8, GLA chunks of 16, M-RoPE
    sections (4, 2, 2), no layer remat (as the reference's); every other
    feature flag kept."""
    cfg = get_config(name)
    L = min(cfg.num_layers, 4)
    blocks = tuple(LayerSpec(b.kind, min(b.window, 16) if b.window else 0) for b in cfg.blocks[:L])
    enc_blocks = tuple(LayerSpec(b.kind, 0) for b in cfg.encoder_blocks[:2])
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg, num_layers=L, blocks=blocks, encoder_blocks=enc_blocks, d_model=64,
        num_heads=heads, num_kv_heads=kv, head_dim=16, d_ff=256 if cfg.d_ff else 0,
        vocab_size=512, num_experts=min(cfg.num_experts, 4), moe_group_size=64,
        ssm_state=min(cfg.ssm_state, 8), gla_chunk=16, mrope_sections=(4, 2, 2), remat=False,
    )
