"""Shared fixtures of the benchmark's tests: configurations cut to CPU sizes
and a BENCHMARK.json that points a cell at one of them."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, time_embed_dim=32,
            text_embed_dim=32, max_text_seq_length=8, cross_attn_num_heads=2,
            cross_attn_dim_head=16, sample_size=[64, 64], video_length=9, ref_frames=5)
# every width as published, two layers, a small frame
NARROW = dict(num_layers=2, sample_size=[64, 96], video_length=9, ref_frames=5)


def cut(config: str, dtype: str = None, **sizes) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    cfg.update(sizes)
    if dtype:
        cfg["dtype"] = dtype
    return cfg


def bench_with(tmp_path: Path, workload: str, cfg: dict) -> dict:
    """BENCHMARK.json with ``workload``'s configuration replaced by ``cfg``."""
    bench = copy.deepcopy(harness.load_benchmark())
    name = harness.cell_of(bench, workload)["config"]
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    for entry in bench["configs"]:
        if entry["name"] == name:
            entry["file"] = str(path)
    return bench


@pytest.fixture
def cuda_card():
    """Skips a test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
