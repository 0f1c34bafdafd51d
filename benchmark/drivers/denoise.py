"""The denoise mix: the pipeline's own sampling loop on the DiT, a few steps a call.

Set-up builds the program's DiT at the configuration's widths (the port's
``CrossTransformer3DModel``, each unit filled with the benchmark's weights
and, under ``"quant": "int8"``, quantized by the port as it loads a
checkpoint), the pipeline with the configuration's sampler, and draws the
loop's inputs from the seed: text and negative embeddings, inpaint latents
(mask and masked-video latents), reference latents.  Each call draws its own
initial latents from the seed and the call's index and runs
``TrajCrafterPipeline._denoise`` from entry ``steps - steps_per_call`` of the
configuration's schedule to its end: the CFG pair through the DiT, the
guidance combine and the sampler's update, as ``TrajCrafterPipeline.__call__``
runs them.

Each call's result is moved to host memory as it ends, so that the card's
peak holds the program alone, whatever number of calls the window fits.

The check: for calls drawn from the seed once the window has closed, the
reference (benchmark/reference) runs the same steps from the same initial
latents.  Two readings, each the widest over those calls:

- ``update_rel_err``: the gap between the two results relative to the
  reference's own update, ``|out - ref| / |ref - latents|`` over the whole
  latent tensor;
- ``guidance_err``: the share of the guidance term ``g`` (what the guidance
  adds to the conditional branch alone, reference/step.py) that the
  program's result misses or adds, ``|<out - ref, g>| / <g, g>``.  ``g`` is
  the float32 reference's: under int8 the rounding of activations adds to
  each side's branch difference a noise about the size of the term itself,
  which a program that rounds elsewhere does not share, so the int8
  reference's own term is no steady direction.  A step that leaves out a CFG
  branch reads about scale / (scale - 1) on it; rounding, uncorrelated with
  ``g``, reads near 0.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.dit import ReferenceDiT, rope_tables
from benchmark.reference.step import cfg_ddim_step
from benchmark.weights import draw_unit, generator, subseed, unit_specs


def latent_shapes(cfg: dict):
    """(frames, height, width) of the video latents, and the reference's frames."""
    ft = cfg["vae_scale_factor_temporal"]
    h, w = (s // cfg["vae_scale_factor_spatial"] for s in cfg["sample_size"])
    return (cfg["video_length"] - 1) // ft + 1, h, w, (cfg["ref_frames"] - 1) // ft + 1


def build_program_dit(cfg: dict, seed: int, device):
    """The port's DiT at the configuration's widths with the benchmark's weights."""
    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
    from trajectorycrafter_tpu_torch.ops.int8 import quantize_dit_unit_

    with torch.device("meta"):
        dit = CrossTransformer3DModel(
            num_attention_heads=cfg["num_attention_heads"],
            attention_head_dim=cfg["attention_head_dim"], in_channels=cfg["in_channels"],
            out_channels=cfg["out_channels"], time_embed_dim=cfg["time_embed_dim"],
            text_embed_dim=cfg["text_embed_dim"], num_layers=cfg["num_layers"],
            max_text_seq_length=cfg["max_text_seq_length"], patch_size=cfg["patch_size"],
            cross_attn_interval=cfg["cross_attn_interval"],
            cross_attn_dim_head=cfg["cross_attn_dim_head"],
            cross_attn_num_heads=cfg["cross_attn_num_heads"],
            use_rotary_positional_embeddings=cfg["use_rotary_positional_embeddings"],
            attention_impl=cfg["attention_impl"])
    dit.to(dtype=getattr(torch, cfg["dtype"]))
    with torch.no_grad():
        for unit_name in unit_specs(cfg):
            unit = dit.get_submodule(unit_name)
            unit.to_empty(device=device)
            params = dict(unit.named_parameters())
            drawn = draw_unit(cfg, unit_name, seed, device)
            if params.keys() != drawn.keys():
                raise RuntimeError(f"{unit_name}: the program holds {sorted(params)}, the "
                                   f"configuration {sorted(drawn)}")
            for name, tensor in drawn.items():
                params[name].copy_(tensor)
            del drawn
            if cfg["quant"] == "int8" and unit_name.startswith(
                    ("transformer_blocks.", "perceiver_cross_attention.")):
                quantize_dit_unit_(unit)
    if any(p.is_meta for p in dit.parameters()):
        raise RuntimeError("a DiT parameter was left unfilled")
    return dit.eval()


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
        from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline
        from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY

        if cfg["sampler_name"] != "DDIM_Origin":
            raise ValueError("the reference follows DDIM_Origin alone")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.steps = cfg["num_inference_steps"]
        self.t_start = self.steps - mix["steps_per_call"]
        self.dtype = getattr(torch, cfg["dtype"])
        f, h, w, f_ref = latent_shapes(cfg)
        lc = cfg["latent_channels"]
        self.latent_shape = (1, f, h, w, lc)
        # the loop's inputs as the pipeline hands them to the DiT: in bf16 (T5's
        # output, the VAE's latents), whatever the model's dtype
        gen = generator(self.device, seed, "inputs")
        randn = lambda *shape: torch.randn(shape, generator=gen, device=self.device)  # noqa: E731
        self.text, self.negative = (self._prompt(randn, mix[key]).bfloat16().to(self.dtype)
                                    for key in ("prompt_tokens", "negative_tokens"))
        hole = torch.rand((1, f, h, w, 1), generator=gen, device=self.device) < mix["hole_share"]
        self.inpaint = torch.cat([(~hole).float() * mix["mask_scale"], randn(1, f, h, w, lc)],
                                 dim=-1).bfloat16().to(self.dtype)
        self.reference = randn(1, f_ref, h, w, lc).bfloat16().to(self.dtype)

        self.pipe = TrajCrafterPipeline(
            vae=None, transformer=build_program_dit(cfg, seed, self.device),
            scheduler=SCHEDULER_REGISTRY[cfg["sampler_name"]](), dtype=self.dtype)
        self.state = self.pipe.scheduler.set_timesteps(self.steps)
        hs, ws = cfg["sample_size"]
        cos, sin = rope_for_sample(cfg["attention_head_dim"], hs, ws, f,
                                   cfg["vae_scale_factor_spatial"], cfg["patch_size"])
        self.rope = (torch.from_numpy(cos).to(self.device), torch.from_numpy(sin).to(self.device))
        # the CFG pair on the batch axis, unconditional first, as __call__ builds it
        self.cfg_inputs = (torch.cat([self.negative, self.text]), torch.cat([self.inpaint] * 2),
                           torch.cat([self.reference] * 2))
        self.outputs = {}

    def _prompt(self, randn, tokens: int) -> torch.Tensor:
        """A prompt's embeddings as T5 pads them: ``tokens`` distinct vectors,
        then one padding vector repeated to the text length, each copy
        perturbed by ``pad_noise``."""
        length, dim = self.cfg["max_text_seq_length"], self.cfg["text_embed_dim"]
        tokens = min(tokens, length)
        pad = randn(1, 1, dim) + self.mix["pad_noise"] * randn(1, length - tokens, dim)
        return torch.cat([randn(1, tokens, dim), pad], dim=1)

    def latents(self, index: int) -> torch.Tensor:
        """Call ``index``'s initial latents (float32)."""
        return torch.randn(self.latent_shape, generator=generator(self.device, self.seed,
                                                                    "latents", index),
                           device=self.device)

    @torch.no_grad()
    def _run(self, index: int) -> torch.Tensor:
        text, inpaint, reference = self.cfg_inputs
        return self.pipe._denoise(
            self.state, self.latents(index), text, inpaint, reference, self.rope, self.steps,
            self.t_start, self.cfg["guidance_scale"], self.cfg["guidance_scale"] > 1.0,
            self.cfg["use_dynamic_cfg"], None, None)

    def warm(self) -> None:
        for i in range(self.mix["warmup_calls"]):
            self._run(-1 - i)

    def call(self, index: int) -> int:
        """One call of the window: returns the steps it ran."""
        self.outputs[index] = self._run(index).cpu()
        return self.steps - self.t_start

    def release(self) -> None:
        """Free the program: only its outputs stay."""
        self.pipe = self.state = self.rope = self.cfg_inputs = None

    def precision(self) -> str:
        """The reference's precision for this configuration: the int8 scheme's
        linears under int8, else float32."""
        return "int8" if self.cfg["quant"] == "int8" else "fp32"

    def reference_model(self, precision: str = None) -> ReferenceDiT:
        """The reference DiT in ``precision`` (the configuration's by default);
        TF32 off."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.cfg
        return ReferenceDiT(cfg, lambda unit: draw_unit(cfg, unit, self.seed, self.device),
                            precision or self.precision())

    def expected(self, index: int):
        """Call ``index`` by the reference -> (its latents in the configuration's
        precision, the float32 guidance term)."""
        ref, term = self.follow(self.reference_model(), index)
        if self.precision() != "fp32":
            term = self.follow(self.reference_model("fp32"), index)[1]
        return ref, term

    def readings(self, out: torch.Tensor, ref: torch.Tensor, term: torch.Tensor,
                 index: int) -> dict:
        return {"update_rel_err": self.gap(out, ref, index),
                "guidance_err": self.guidance_gap(out, ref, term)}

    @torch.no_grad()
    def follow(self, model: ReferenceDiT, index: int):
        """``model`` through call ``index``'s steps from its initial latents
        -> (its latents, its guidance term)."""
        cfg = self.cfg
        rope = tuple(t.to(self.device) for t in rope_tables(
            cfg["attention_head_dim"], *cfg["sample_size"], self.latent_shape[1],
            cfg["patch_size"], cfg["vae_scale_factor_spatial"]))
        x, term = self.latents(index), None
        for i in range(self.t_start, self.steps):
            x, term = cfg_ddim_step(model, x, i, self.text, self.negative, self.inpaint,
                                    self.reference, rope, term)
        return x, term

    @staticmethod
    def _finite(value) -> float:
        value = float(value)
        return value if np.isfinite(value) else float("nan")

    def gap(self, out: torch.Tensor, ref: torch.Tensor, index: int) -> float:
        """|out - ref| / |ref - initial latents| over the whole latent tensor."""
        err = out.to(ref.device).float() - ref
        return self._finite(err.norm() / (ref - self.latents(index)).norm())

    def guidance_gap(self, out: torch.Tensor, ref: torch.Tensor, term: torch.Tensor) -> float:
        """|<out - ref, term>| / <term, term>: the share of the reference's
        guidance term that ``out`` misses or adds."""
        err = out.to(ref.device).double() - ref.double()
        term = term.double()
        return self._finite((err * term).sum().abs() / (term * term).sum())

    def check(self) -> dict:
        """The widest of each reading over the calls drawn for the comparison."""
        rng = np.random.default_rng(subseed(self.seed, "check"))
        done = sorted(self.outputs)
        picks = rng.choice(len(done), size=min(self.mix["check_calls"], len(done)),
                           replace=False)
        readings = [self.readings(self.outputs[done[int(p)]], *self.expected(done[int(p)]),
                                  done[int(p)]) for p in picks]
        return {name: float("nan") if any(np.isnan(r[name]) for r in readings)
                else max(r[name] for r in readings) for name in readings[0]}
