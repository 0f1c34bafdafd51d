"""BLIP-2 video captioning: the prompt of a run without ``--prompt``.

Counterpart of trajectorycrafter_tpu/utils/caption.py.  The middle frame is
captioned once per video: a ``blip_path`` that holds the HF safetensors,
``config.json`` and the GPT-2 BPE files (``vocab.json``, ``merges.txt``)
loads into ``models/blip2.py`` on the device, greedy-decodes the caption ids
and decodes them with ``utils/bpe.py``.  Two deliberate differences from the
JAX package: there is no transformers route, and a ``blip_path`` that exists
but does not load raises (the JAX package falls back to transformers, then
to the fixed prompt).  A ``blip_path`` that does not exist gives the fixed
prompt, with a printed line.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from trajectorycrafter_tpu_torch.models.blip2 import (
    Blip2Captioner,
    blip2_config_from_hf,
    generate_caption_ids,
    preprocess_frame,
)
from trajectorycrafter_tpu_torch.utils.bpe import GPT2BPETokenizer
from trajectorycrafter_tpu_torch.utils.checkpoints import LOG, load_module


def generation_limits(blip_path: str, eos: int):
    """(max_new_tokens, eos) from ``generation_config.json``: 19 new tokens
    by default; HF's ``max_length`` counts the BOS the decoder starts from,
    so it gives max_length - 1; ``max_new_tokens`` wins over it."""
    max_new = 19
    gen_path = os.path.join(blip_path, "generation_config.json")
    if os.path.isfile(gen_path):
        with open(gen_path) as f:
            gen = json.load(f)
        eos = gen.get("eos_token_id", eos)
        if "max_new_tokens" in gen:
            max_new = gen["max_new_tokens"]
        elif "max_length" in gen:
            max_new = max(int(gen["max_length"]) - 1, 1)
    return max_new, eos


class Blip2Caption:
    """caption(frame (H, W, 3) in [0, 1]) -> str, the BLIP-2 stack on ``device``.
    ``last_ids`` holds the greedy ids of the latest call."""

    def __init__(self, blip_path: str, device="cuda", stats: Optional[dict] = None):
        with open(os.path.join(blip_path, "config.json")) as f:
            self.cfg = blip2_config_from_hf(json.load(f))
        self.max_new, self.eos = generation_limits(blip_path, self.cfg.eos_token_id)
        self.device = device
        self.model = load_module(lambda: Blip2Captioner(self.cfg), blip_path, device,
                                 torch.bfloat16, "blip2", stats=stats)
        self.tokenizer = GPT2BPETokenizer.from_dir(blip_path)
        self.last_ids: Optional[torch.Tensor] = None

    def __call__(self, frame: np.ndarray) -> str:
        pixels = preprocess_frame(frame, self.cfg.image_size, self.device)
        ids = generate_caption_ids(self.model, pixels, max_new_tokens=self.max_new,
                                   eos_token_id=self.eos)
        self.last_ids = ids[0].cpu()
        return self.tokenizer.decode(self.last_ids.tolist()).strip()


def build_captioner(blip_path: str, device="cuda", stats: Optional[dict] = None) -> Callable:
    """-> caption(frame_hw3_float01) -> str."""
    if os.path.isdir(blip_path):
        return Blip2Caption(blip_path, device, stats)
    print(f"{LOG} BLIP-2 not found at {blip_path}; using the fixed prompt 'a video'")
    return lambda frame: "a video"
