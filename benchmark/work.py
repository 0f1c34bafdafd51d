"""Operations and bytes of one CFG denoise step of the CrossTransformer3D DiT,
counted from a configuration's shapes, and the H100's data-sheet peaks.

No torch: the counts come from the configuration file alone, so a share of a
roofline reads the same work whatever kernel a later version runs it with.
Work is counted by the configuration, not by the kernel: under ``"quant":
"int8"`` the blocks' and Perceivers' linear layers are counted at the int8
peak, every other linear layer and all attention at the bf16 peak.

Each input byte is counted read once and each output byte written once: a
linear layer reads its activations (bf16), its weight (int8 or bf16) and its
bias, and writes its bf16 output; an attention reads q, k and v and writes
its output.  A layer's least time is the larger of operations over the peak
and bytes over the bandwidth.  The patch embeddings (convolutions with a
kernel of one patch), norms and elementwise work are left out: they are the
"other" device time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


@dataclass(frozen=True)
class Op:
    """One kind of operation in a step: ``count`` launches of ``ops`` operations
    moving ``bytes`` bytes each, at the ``kind`` peak."""

    name: str
    group: str  # "linear" or "attention"
    kind: str  # "bf16" or "int8"
    ops: float
    bytes: float
    count: int

    @property
    def least_s(self) -> float:
        """Least time of all ``count`` launches: max(ops / peak, bytes / bandwidth) each."""
        return self.count * max(self.ops / PEAK_OPS_PER_S[self.kind],
                                self.bytes / HBM_BYTES_PER_S)


def linear(name: str, rows: int, k: int, n: int, kind: str, count: int,
           bias: bool = True) -> Op:
    """A (rows, k) x (k, n) linear layer: 2 rows k n operations; bytes of the
    bf16 input and output, the weight (one byte a value in int8, with an fp32
    scale a column) and the bf16 bias."""
    weight = k * n * (1 if kind == "int8" else BF16_BYTES) + (4 * n if kind == "int8" else 0)
    nbytes = BF16_BYTES * rows * (k + n) + weight + (BF16_BYTES * n if bias else 0)
    return Op(name, "linear", kind, 2.0 * rows * k * n, float(nbytes), count)


def attention(name: str, batch: int, heads: int, q_len: int, kv_len: int, head_dim: int,
              count: int) -> Op:
    """Softmax attention: QK^T and PV, 4 B H Sq Skv D operations; q, k and v read
    and the output written in bf16."""
    ops = 4.0 * batch * heads * q_len * kv_len * head_dim
    nbytes = BF16_BYTES * batch * heads * head_dim * (2 * q_len + 2 * kv_len)
    return Op(name, "attention", "bf16", ops, float(nbytes), count)


def token_counts(cfg: dict) -> Dict[str, int]:
    """Video, text, joint and reference token counts of one sample."""
    height, width = cfg["sample_size"]
    patch = cfg["patch_size"] * cfg["vae_scale_factor_spatial"]
    per_frame = (height // patch) * (width // patch)
    frames = (cfg["video_length"] - 1) // cfg["vae_scale_factor_temporal"] + 1
    ref_frames = (cfg["ref_frames"] - 1) // cfg["vae_scale_factor_temporal"] + 1
    video, text = frames * per_frame, cfg["max_text_seq_length"]
    return {"video": video, "text": text, "joint": video + text,
            "reference": ref_frames * per_frame}


def dit_step_ops(cfg: dict) -> List[Op]:
    """Every linear layer and attention of one CFG step (the DiT on a batch of
    2: unconditional and conditional)."""
    b = 2 if cfg["guidance_scale"] > 1.0 else 1
    tok = token_counts(cfg)
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    ff = dim * cfg["ff_mult"]
    temb = cfg["time_embed_dim"]
    layers = cfg["num_layers"]
    perceivers = len(range(0, layers, cfg["cross_attn_interval"]))
    cross = cfg["cross_attn_num_heads"] * cfg["cross_attn_dim_head"]
    q8 = "int8" if cfg["quant"] == "int8" else "bf16"
    joint, video, ref = b * tok["joint"], b * tok["video"], b * tok["reference"]
    out_ch = cfg["out_channels"] * cfg["patch_size"] ** 2
    return [
        linear("time_embedding.linear_1", b, dim, temb, "bf16", 1),
        linear("time_embedding.linear_2", b, temb, temb, "bf16", 1),
        linear("text_proj", b * tok["text"], cfg["text_embed_dim"], dim, "bf16", 1),
        linear("block.adaln", b, temb, 6 * dim, "bf16", 2 * layers),
        linear("block.attn.qkv", joint, dim, dim, q8, 3 * layers),
        linear("block.attn.to_out", joint, dim, dim, q8, layers),
        linear("block.ff.proj_in", joint, dim, ff, q8, layers),
        linear("block.ff.proj_out", joint, ff, dim, q8, layers),
        linear("perceiver.to_q", video, dim, cross, q8, perceivers, bias=False),
        linear("perceiver.to_kv", ref, dim, 2 * cross, q8, perceivers, bias=False),
        linear("perceiver.to_out", video, cross, dim, q8, perceivers, bias=False),
        linear("norm_out", b, temb, 2 * dim, "bf16", 1),
        linear("proj_out", video, dim, out_ch, "bf16", 1),
        attention("block.self_attention", b, cfg["num_attention_heads"], tok["joint"],
                  tok["joint"], cfg["attention_head_dim"], layers),
        attention("perceiver.attention", b, cfg["cross_attn_num_heads"], tok["video"],
                  tok["reference"], cfg["cross_attn_dim_head"], perceivers),
    ]


def least_seconds(cfg: dict, group: str = None) -> float:
    """Least time of one CFG step's ``group`` ("linear", "attention"; None: both)."""
    return sum(op.least_s for op in dit_step_ops(cfg) if group in (None, op.group))
